"""The tiled fp32 single-block attention (rows 1-2 on the fp32 route):
csrc/fused_attention_fwd.cu and fused_attention_bwd.cu, register micro-tiles
and one sweep over the keys with an online softmax; the forward writes each
row's (max, log of its sum), the backward rebuilds P from it and takes
delta = rowsum(g · out).

On the CPU: the plain PyTorch mirror of that algorithm
(kernels/attention.py:_tiled_fwd, _tiled_bwd) against the JAX kernel in
interpret mode on the same numpy inputs (B=1 or 2, 2 heads of 64, fp32,
dropout 0 and 0.1) at 128 x 128, 99 x 227, ViLT's 418 x 418 (row_start 1,
text_len 128; and the +290 offset), 1100 keys and a batch row whose keys
are all masked; the identity delta = rowsum(g · out) = rowsum(dP · P) under
dropout; why the row statistics keep their two terms apart; which route's
autograd function saves out and lse; what the launchers hand the library.
On the card (`cuda`): the kernels against the plain versions at those
shapes, lse against the mirror's, and shared memory set by the head width
alone."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from test_torch_port_attention import cuda  # noqa: F401

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

H, D = 2, 64
ATOL = 1e-5  # the per-op bar (tests/test_fused_attention.py:74)
SEED = 2 ** 31 - 9
# name -> (B, Lq, Lk, geometry keywords or None, batch row whose keys are all
# masked or None)
SHAPES = {
    "text_128": (1, 128, 128, dict(boundary=(50,), row_start=0, text_len=None, offset=0), None),
    "vision_text_227": (1, 99, 227, None, None),
    "vilt_418": (1, 418, 418, dict(boundary=(40,), row_start=1, text_len=128, offset=0), None),
    "vilt_418_offset_290": (1, 418, 418, dict(boundary=(1,), row_start=1, text_len=None,
                                              offset=290), None),
    "vision_text_1100": (1, 99, 1100, None, None),
    "all_masked_row": (2, 99, 99, None, 1),
    "one_key": (2, 40, 1, None, None),
}


def make_case(b, lq, lk, masked_row, seed=0):
    """numpy q, k, v, the cotangent g and the mask: the last 11 keys padded,
    every key of ``masked_row``."""
    rng = np.random.default_rng(seed + lq + lk)
    q, g = (rng.standard_normal((b, lq, H * D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, lk, H * D)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, lk), np.float32)
    mask[:, lk - 11:] = 0.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    return q, k, v, g, mask


def geometry_kwargs(geometry, b, device="cpu"):
    if geometry is None:
        return {}
    boundary = torch.tensor(geometry["boundary"] * b, dtype=torch.int32, device=device)
    return dict(geometry, boundary=boundary, w0=torch.tensor([0.3], device=device),
                w1=torch.tensor([0.7], device=device))


def resolved(q, kw, rate):
    """(boundary, w, geometry, rate, seed) as the wrapper resolves them."""
    return single._resolve(q, kw.get("boundary"), kw.get("w0"), kw.get("w1"),
                           kw.get("text_len"), kw.get("row_start", 0), kw.get("offset", 0),
                           rate, rate == 0.0, SEED)


def jax_results(q, k, v, g, mask, geometry, rate):
    """(out, dq, dk, dv, dw0, dw1) of the JAX kernel in interpret mode."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention

    kw = {}
    if geometry is not None:
        kw = dict(geometry, boundary=jnp.asarray(geometry["boundary"] * q.shape[0]))

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry is not None else {}
        return fused_attention(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32,
                               interpret=True, dropout_rate=rate, deterministic=rate == 0.0,
                               dropout_seed=jnp.asarray(SEED, jnp.int32), **kw, **extra)

    args = [jnp.asarray(x) for x in (q, k, v)] + [jnp.asarray([0.3]), jnp.asarray([0.7])]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    return [np.asarray(out)] + [np.asarray(x) for x in grads[:3]] + [
        float(grads[3][0]), float(grads[4][0])]


def mirror_results(q, k, v, g, mask, geometry, rate):
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = geometry_kwargs(geometry, q.shape[0])
    args = resolved(t[0], kw, rate)
    out, lse = single._tiled_fwd(*t[:4], H, *args)
    dq, dk, dv, dw = single._tiled_bwd(*t, out, lse, H, *args)
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


def plain_results(q, k, v, g, mask, geometry, rate):
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = dict(geometry_kwargs(geometry, q.shape[0]), compute_dtype=torch.float32,
              dropout_rate=rate, deterministic=rate == 0.0, dropout_seed=SEED)
    out = single.fused_attention_reference(*t[:4], H, **kw)
    dq, dk, dv, dw = single.fused_attention_bwd_reference(*t, H, **kw)
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


def assert_results_close(got, want, lk, masked_row=None):
    """out within 1e-5; dq, dk and dv within 1e-5 of each result's largest
    |value|; dw0 and dw1 within 1e-5 for each key they sum over (the bar of
    test_torch_port_long_keys.py). A batch row whose keys are all masked
    within REL_MASKED_ROW of its own largest value instead."""
    for name, a, w in zip(("out", "dq", "dk", "dv"), got[:4], want[:4]):
        assert a.shape == w.shape
        bar = ATOL * (1.0 if name == "out" else np.abs(w).max())
        for b in range(a.shape[0]):
            row_bar = bar
            if b == masked_row:
                row_bar = max(bar, REL_MASKED_ROW * float(np.abs(w[b]).max()))
            np.testing.assert_allclose(a[b], w[b], atol=row_bar, rtol=0,
                                       err_msg=f"{name} batch row {b}")
    for name, a, w in zip(("dw0", "dw1"), got[4:], want[4:]):
        np.testing.assert_allclose(a, w, atol=ATOL * lk, rtol=0, err_msg=name)


# A batch row whose keys are all masked scores at s_raw - 1e4, where an fp32
# ulp is 9.8e-4: the q·k products of the port (torch.matmul) and of the JAX
# kernel (XLA's dot) sum in different orders, a last-bit difference moves a
# score there by one ulp and a probability by 1e-3 of itself. So against JAX
# that row holds 2e-3 of its largest value, as in
# test_torch_port_attention_edges.py (REL_MASKED_ROW, and
# test_masked_row_gap_is_the_dots_summation_order for why); against the plain
# version, which shares the port's products, 1e-5 like every other row.
REL_MASKED_ROW = 2e-3


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tiled_mirror_matches_jax(shape, rate):
    """The fp32 kernels' algorithm, mirrored in plain PyTorch, against the
    JAX kernel at the bars of assert_results_close, and against the plain
    version at the same bars with no exception for an all-masked row. The
    keep masks must agree bit for bit, or the bars break."""
    b, lq, lk, geometry, masked_row = SHAPES[shape]
    q, k, v, g, mask = make_case(b, lq, lk, masked_row)
    got = mirror_results(q, k, v, g, mask, geometry, rate)
    assert_results_close(got, jax_results(q, k, v, g, mask, geometry, rate), lk, masked_row)
    assert_results_close(got, plain_results(q, k, v, g, mask, geometry, rate), lk)
    if geometry is None:
        assert got[4] == 0.0 and got[5] == 0.0


@pytest.mark.parametrize("block_k", [1, 32, 64, 500])
def test_tiled_forward_and_lse_take_any_key_tile(block_k):
    """The online softmax gives the plain forward whatever the key tile (one
    key, the kernels' 32 and 64, all keys at once), with dropout; lse's two
    terms are the row's max and the log of its sum."""
    q, k, v, _, mask = (torch.from_numpy(x) for x in make_case(2, 99, 227, 1))
    kw = dict(compute_dtype=torch.float32, dropout_rate=0.1, deterministic=False,
              dropout_seed=SEED)
    out, lse = single._tiled_fwd(q, k, v, mask, H, *resolved(q, {}, 0.1), block_k=block_k)
    want = single.fused_attention_reference(q, k, v, mask, H, **kw)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=0)
    split = (lambda x: single._split_heads(x, H, torch.float32))
    bias = ((1.0 - mask) * single.NEG_BIAS)[:, None, None, :]
    _, s = single._score(single._qk_products(split(q), split(k)), D ** -0.5, None, bias)
    assert lse.shape == (2, H, 99, 2)
    torch.testing.assert_close(lse[..., 0], s.amax(dim=-1), atol=ATOL, rtol=0)
    torch.testing.assert_close(lse[..., 1], torch.log(torch.exp(s - lse[..., :1]).sum(-1)),
                               atol=1e-6, rtol=0)


def test_delta_from_g_and_out_is_rowsum_of_dp_and_p_under_dropout():
    """delta = rowsum(g · out), which the fp32 backward reads from the
    forward's output, equals rowsum(dP · P) with dP the dropped and rescaled
    g Vᵀ and P the softmax (attention.py:_bwd_kernel :210), and rowsum(g Vᵀ ·
    P~): out = P~ V. In fp32, within 1e-5 of the largest |delta|."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in make_case(2, 99, 227, None))
    rate = 0.3
    bnd, w, geo, rate, seed = resolved(q, {}, rate)
    out = single._plain_fwd(q, k, v, mask, H, bnd, w, geo, rate, seed, torch.float32)
    split = (lambda x: single._split_heads(x, H, torch.float32))
    delta = (split(g) * split(out)).sum(-1)
    _, _, p = single._scores(q, k, mask, H, bnd, w, geo)
    keep = single.dropout_keep(2, H, 99, 227, rate, seed, "cpu")
    gv = split(g) @ split(v).transpose(-1, -2)
    dp = torch.where(keep, gv / (1.0 - rate), torch.zeros(()))
    p_drop = torch.where(keep, p / (1.0 - rate), torch.zeros(()))
    top = delta.abs().max().item()
    assert keep.float().mean().item() < 0.75  # the dropout is there
    torch.testing.assert_close((dp * p).sum(-1), delta, atol=ATOL * top, rtol=0)
    torch.testing.assert_close((gv * p_drop).sum(-1), delta, atol=ATOL * top, rtol=0)


def test_row_statistics_keep_two_terms_at_an_all_masked_row():
    """Why lse is (max, log of the sum) and not their fp32 sum: a row whose
    keys are all masked scores near -1e4, where an fp32 ulp is 2^-10, so an
    lse summed into one fp32 value moves every probability of the row by up
    to 2^-11 of itself and the backward by more than 1e-4 of its largest
    value, beyond the fp32 bar; kept apart, within 1e-5."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in make_case(2, 99, 99, 1))
    args = resolved(q, {}, 0.1)
    want = single.fused_attention_bwd_reference(q, k, v, mask, g, H,
                                                compute_dtype=torch.float32,
                                                dropout_rate=0.1, deterministic=False,
                                                dropout_seed=SEED)
    out, lse = single._tiled_fwd(q, k, v, mask, H, *args)
    summed = lse.sum(-1, keepdim=True)
    one_term = torch.cat([summed, torch.zeros_like(summed)], dim=-1)
    for stats, ok in ((lse, True), (one_term, False)):
        got = single._tiled_bwd(q, k, v, mask, g, out, stats, H, *args)
        worst = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(got[:3], want[:3]))
        assert (worst <= ATOL) == ok and (ok or worst > 1e-4), worst


def test_one_key_tile_takes_delta_from_its_own_p_and_dp():
    """Where every key fits one tile (here one key: P is 1 in every row) the
    backward takes delta = rowsum(dP · P) of that tile, so dS, dq and dk are
    exactly 0, as the plain version's are; from g · out they would be a few
    ulps off 0, beyond a bar of 2e-5 of a largest value of 0."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in make_case(2, 40, 1, None))
    mask = torch.ones(2, 1)
    args = resolved(q, {}, 0.1)
    out, lse = single._tiled_fwd(q, k, v, mask, H, *args)
    dq, dk, dv, _ = single._tiled_bwd(q, k, v, mask, g, out, lse, H, *args)
    want = single.fused_attention_bwd_reference(q, k, v, mask, g, H,
                                                compute_dtype=torch.float32,
                                                dropout_rate=0.1, deterministic=False,
                                                dropout_seed=SEED)
    assert not dq.any() and not dk.any() and not want[0].any() and not want[1].any()
    torch.testing.assert_close(dv, want[2], atol=ATOL * want[2].abs().max().item(), rtol=0)


def _stub_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride=None):
    return single._tiled_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride)


@pytest.mark.parametrize("route", ["plain", "tensor_cores", "cuda_cores"])
def test_only_the_fp32_cuda_route_saves_out_and_lse(monkeypatch, route):
    """_FusedAttention saves q, k, v, the mask, the boundary and w on every
    route (JAX's residuals), and the output and lse besides on the fp32
    CUDA route alone, whose backward gets them. The launchers are stood in
    for by the plain versions, on the CPU."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in make_case(1, 20, 30, None))
    q.requires_grad_(True)
    seen = {}
    if route != "plain":
        monkeypatch.setattr(single, "_route", lambda x: route)

        def bwd(q_, k_, v_, mask_, g_, heads, bnd, w, geo, rate, seed, stride=None,
                out=None, lse=None):
            seen.update(out=out, lse=lse)
            return single._plain_bwd(q_, k_, v_, mask_, g_, heads, bnd, w, geo, rate, seed,
                                     torch.float32, stride)

        monkeypatch.setattr(single, "_launch_bwd", bwd)
        monkeypatch.setattr(single, "_launch_fwd_cuda_cores", _stub_fwd)
        monkeypatch.setattr(single, "_launch_fwd_mma", lambda *a: _stub_fwd(*a)[0])
    out = single.fused_attention(q, k, v, mask, H, compute_dtype=torch.float32)
    saved = out.grad_fn.saved_tensors
    if route == "cuda_cores":
        assert len(saved) == 8
        assert torch.equal(saved[6], out) and saved[7].shape == (1, H, 20, 2)
    else:
        assert len(saved) == 6
    out.backward(g)
    assert q.grad is not None and torch.isfinite(q.grad).all()
    if route == "cuda_cores":
        assert torch.equal(seen["out"], out) and seen["lse"].shape == (1, H, 20, 2)
    elif route == "tensor_cores":
        assert seen == dict(out=None, lse=None)


def test_route_follows_device_and_dtype():
    """The route of a call: the CPU takes the plain versions; on another
    device the dtype alone picks the kernels."""
    cpu = torch.zeros(1, 2, 4)
    assert single._route(cpu) == single._route(cpu.bfloat16()) == "plain"
    meta = torch.empty(1, 2, 4, device="meta")
    assert single._route(meta) == "cuda_cores"
    assert single._route(meta.bfloat16()) == "tensor_cores"


class _Lib:
    """A stand-in library: records each launcher's name and arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_smem"):
            return lambda *args: 100_000
        return lambda *args: self.calls.append((name, args)) or 0


class _Props:
    shared_memory_per_block_optin = 232448


def test_fp32_launchers_hand_the_library_the_residuals(monkeypatch):
    """On the fp32 route the forward passes out and lse; the backward
    passes the forward's out and lse it is given and launches nothing else,
    and without them has the forward kernel rebuild them first, counting
    one backward launch and no forward."""
    class _Stream:
        cuda_stream = 0

    class _Null:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    lib = _Lib()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda device=None: _Null())
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: _Props())
    for name in ("_lib", "_lib_bwd"):
        monkeypatch.setattr(single, name, lambda width=None: lib)
    q = torch.zeros(2, 70, H * D)
    k = torch.zeros(2, 300, H * D)
    mask = torch.ones(2, 300)
    args = resolved(q, {}, 0.0)
    out, lse = single._launch_fwd_cuda_cores(q, k, k, mask, H, *args)
    assert lse.shape == (2, H, 70, 2) and lse.dtype == torch.float32
    name, fwd_args = lib.calls[-1]
    assert name == "mkg_fused_attention_fwd"
    assert fwd_args[6:8] == (out.data_ptr(), lse.data_ptr())
    assert fwd_args[8:13] == (2, 70, 300, H, D)
    before = (single.LAUNCHES, single.LAUNCHES_BWD)
    single._launch_bwd(q, k, k, mask, q, H, *args, None, out, lse)
    name, bwd_args = lib.calls[-1]
    assert name == "mkg_fused_attention_bwd" and len(lib.calls) == 2
    assert bwd_args[7:9] == (out.data_ptr(), lse.data_ptr())
    assert bwd_args[14:19] == (2, 70, 300, H, D)
    single._launch_bwd(q, k, k, mask, q, H, *args)
    assert [n for n, _ in lib.calls[2:]] == ["mkg_fused_attention_fwd",
                                              "mkg_fused_attention_bwd"]
    assert (single.LAUNCHES, single.LAUNCHES_BWD) == (before[0], before[1] + 2)
    with pytest.raises(ValueError, match="float32"):
        single._launch_fwd_cuda_cores(q.bfloat16(), k.bfloat16(), k.bfloat16(), mask, H,
                                      *args)


# ---------------------------------------------------------------- on the card

def card_case(shape, cuda):  # noqa: F811
    b, lq, lk, geometry, masked_row = SHAPES[shape]
    q, k, v, g, mask = (torch.from_numpy(x).to(cuda) for x in
                        make_case(max(b, 2), lq, lk, masked_row))
    return q, k, v, g, mask, geometry_kwargs(geometry, max(b, 2), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tiled_kernels_match_plain_versions(cuda, shape, rate):  # noqa: F811
    """The fp32 kernels on the card against the plain versions: the forward
    within 2e-5, its lse against the mirror's (max exactly up to the
    products' summation order, log of the sum within 1e-6), the backward
    from the forward's residuals within 2e-5 of each result's largest, each
    launch counted once."""
    q, k, v, g, mask, kw = card_case(shape, cuda)
    args = resolved(q, kw, rate)
    before = (single.LAUNCHES, single.LAUNCHES_BWD)
    out, lse = single._launch_fwd_cuda_cores(q, k, v, mask, H, *args)
    grads = single._launch_bwd(q, k, v, mask, g, H, *args, None, out, lse)
    torch.cuda.synchronize()
    assert (single.LAUNCHES, single.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    call = dict(kw, compute_dtype=torch.float32, dropout_rate=rate,
                deterministic=rate == 0.0, dropout_seed=SEED)
    want = single.fused_attention_reference(q, k, v, mask, H, **call)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    _, want_lse = single._tiled_fwd(q, k, v, mask, H, *args)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)
    want = single.fused_attention_bwd_reference(q, k, v, mask, g, H, **call)
    for a, b_ in zip(grads[:3], want[:3]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b_, atol=2e-5 * b_.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_shared_memory_is_set_by_the_head_width_alone(cuda, d):  # noqa: F811
    """Neither kernel's shared memory depends on a length (the libraries
    take the head width alone), each fits the device's limit, and calls at
    1 and at 3000 keys both launch and match the plain version."""
    from mkg_analogy_tpu_torch.kernels import build

    width = build.library_width(d)
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    fwd = single._lib(width).mkg_fused_attention_fwd_smem(d)
    bwd = single._lib_bwd(width).mkg_fused_attention_bwd_smem(d)
    assert 0 < fwd <= limit and 0 < bwd <= limit
    gen = torch.Generator().manual_seed(d)
    for lk in (1, 3000):
        q = torch.randn(1, 70, 2 * d, generator=gen).to(cuda)
        k, v = (torch.randn(1, lk, 2 * d, generator=gen).to(cuda) for _ in range(2))
        mask = torch.ones(1, lk, device=cuda)
        got = single.fused_attention(q, k, v, mask, 2, compute_dtype=torch.float32)
        want = single.fused_attention_reference(q, k, v, mask, 2, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
