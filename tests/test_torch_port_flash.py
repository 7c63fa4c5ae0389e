"""Port parity for the flash (K-blocked) attention: the plain PyTorch forward
and backward (mkg_analogy_tpu_torch/kernels/flash_attention.py:
flash_attention_reference, flash_attention_bwd_reference) against the JAX
Pallas kernels in interpret mode on the same numpy inputs, at L=12 with the
block shapes of tests/test_flash_attention.py (one tile, exact division,
ragged Q, ragged K, ragged both), across the mask geometries, with dropout
and in bf16; the one-tile case against the single-block plain version; the
CPU autograd.Function; and the CUDA kernels against the plain versions
(need a card)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import build
from mkg_analogy_tpu_torch.kernels import flash_attention as port
from test_torch_port_attention import CASES, H, cuda, make_inputs  # noqa: F401
from test_torch_port_flash_edges import (FLASH_EDGE_CASES, flash_edge_inputs,
                                         flash_edge_kwargs, one_key_size)

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

# (block_q, block_k) against L=12: one block, exact division, ragged Q,
# ragged K, ragged both (tests/test_flash_attention.py:19)
BLOCKS = [(16, 16), (6, 6), (8, 6), (6, 8), (8, 8)]
# the JAX flash kernels' bars against their einsum oracle
# (tests/test_flash_attention.py:35, :77): the same fp32 math, summed in
# another order and over other tiles
ATOL, GRAD_ATOL = 1e-5, 2e-5
GEOMETRY = dict(boundary=(5, 7), row_start=1, text_len=10)


def make_cotangent(b=2, lq=12, seed=9):
    return np.random.default_rng(seed).standard_normal((b, lq, H * 8)).astype(np.float32)


def _kwargs(case, lib):
    """The case's keyword arguments with (w0, w1) = (0.3, 0.7), for the JAX
    (``lib`` = jnp) or the port's (``lib`` = torch) call."""
    kw = dict(case)
    if "boundary" in case:
        if lib is torch:
            kw.update(boundary=torch.tensor(case["boundary"]), w0=torch.tensor([0.3]),
                      w1=torch.tensor([0.7]))
        else:
            kw.update(boundary=lib.asarray(case["boundary"]), w0=lib.asarray([0.3]),
                      w1=lib.asarray([0.7]))
    return kw


def jax_flash(q, k, v, mask, g, case, blocks, rate=0.0, seed=0, dtype=None):
    """(out, [dq, dk, dv, dw0, dw1]) of the JAX flash kernels in interpret
    mode; dw0/dw1 None without a geometry, the gradients None without g."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.flash_attention import flash_attention as jax_fa

    dtype = dtype or jnp.float32
    kw = _kwargs(case, jnp)
    w = (kw.pop("w0", jnp.asarray([1.0])), kw.pop("w1", jnp.asarray([1.0])))
    geometry = "boundary" in case

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry else {}
        return jax_fa(q, k, v, jnp.asarray(mask), H, compute_dtype=dtype, interpret=True,
                      dropout_rate=rate, deterministic=rate == 0.0,
                      dropout_seed=jnp.asarray(seed, jnp.int32), block_q=blocks[0],
                      block_k=blocks[1], **kw, **extra)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)] + list(w)
    out, vjp = jax.vjp(f, *args)
    out = np.asarray(out, np.float32)
    if g is None:
        return out, None
    grads = vjp(jnp.asarray(g, dtype))
    res = [np.asarray(x, np.float32) for x in grads[:3]]
    res += [float(grads[3][0]), float(grads[4][0])] if geometry else [None, None]
    return out, res


def port_call(q, k, v, mask, g, case, blocks, rate=0.0, seed=0, dtype=torch.float32):
    """(out, (dq, dk, dv, dw) or None) of the port's plain versions."""
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    kw = dict(_kwargs(case, torch), compute_dtype=dtype, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=seed, block_q=blocks[0],
              block_k=blocks[1])
    m = torch.from_numpy(mask)
    out = port.flash_attention_reference(*t, m, H, **kw)
    if g is None:
        return out, None
    return out, port.flash_attention_bwd_reference(
        *t, m, torch.from_numpy(g).to(dtype), H, **kw)


def assert_grads_close(got, want, atol):
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, err_msg=name)
    if want[3] is None:
        assert not got[3].any()
    else:
        # dw sums ds * s_raw over a region of the score plane: the bar scales
        # with the number of rows summed
        for i, name in enumerate(("dw0", "dw1")):
            np.testing.assert_allclose(float(got[3][i]), want[3 + i],
                                       atol=atol * got[0].shape[1], err_msg=name)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("case", CASES)
def test_reference_forward_matches_jax_flash(case, blocks):
    q, k, v, mask = make_inputs()
    want, _ = jax_flash(q, k, v, mask, None, case, blocks)
    got, _ = port_call(q, k, v, mask, None, case, blocks)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("case", [CASES[0], GEOMETRY])
def test_reference_bwd_matches_jax_flash(case, blocks):
    """dq, dk, dv, dw0 and dw1 of the plain backward against jax.vjp of the
    two Pallas backward kernels, including across ragged tiles."""
    q, k, v, mask = make_inputs(seed=3)
    g = make_cotangent()
    _, want = jax_flash(q, k, v, mask, g, case, blocks)
    _, got = port_call(q, k, v, mask, g, case, blocks)
    assert_grads_close(got, want, GRAD_ATOL)


@pytest.mark.parametrize("blocks", [(16, 16), (8, 6), (6, 8)])
def test_dropout_masks_match_jax_flash(blocks):
    """Dropout 0.3 keyed to the logical tiles (the seed of _tile_seed, the
    row stride bk in a ragged tile): forward and gradients equal to the JAX
    interpret kernels at the fp32 bar, so the masks are the same bits; and
    the masks are not trivial."""
    q, k, v, mask = make_inputs(seed=1)
    g = make_cotangent(seed=4)
    want_out, want = jax_flash(q, k, v, mask, g, GEOMETRY, blocks, rate=0.3, seed=1234)
    got_out, got = port_call(q, k, v, mask, g, GEOMETRY, blocks, rate=0.3, seed=1234)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=ATOL)
    assert_grads_close(got, want, ATOL)
    plain, _ = port_call(q, k, v, mask, None, GEOMETRY, blocks)
    assert (got_out - plain).abs().max() > 1e-2


def test_dropout_seed_wraps_like_int32():
    """A seed near 2^31 pushes the tile seeds past int32, where JAX's int32
    sum wraps: the port's sum modulo 2^32 gives the same masks."""
    q, k, v, mask = make_inputs(seed=2)
    want, _ = jax_flash(q, k, v, mask, None, CASES[0], (6, 6), rate=0.2, seed=2 ** 31 - 3)
    got, _ = port_call(q, k, v, mask, None, CASES[0], (6, 6), rate=0.2, seed=2 ** 31 - 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("blocks", [(16, 16), (8, 6)])
def test_reference_bf16_matches_jax_flash(blocks):
    """bf16 inputs and compute dtype: the exp-weights rounded to bf16
    against the running max of each K tile, then a divide in fp32. Two
    implementations round values that differ in their last fp32 bits, so the
    bar is the JAX package's bf16 flash bar, 2e-2 (test_flash_attention.py:110)."""
    import jax.numpy as jnp

    q, k, v, mask = make_inputs(seed=21)
    want, _ = jax_flash(q, k, v, mask, None, GEOMETRY, blocks, dtype=jnp.bfloat16)
    got, _ = port_call(q, k, v, mask, None, GEOMETRY, blocks, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_reference_bf16_bwd_matches_jax_flash():
    """bf16 backward with its cast points (P_drop and dS_raw rounded before
    the products): each result within 2 bf16 ulps (2^-7) of its largest
    value, dw likewise of the larger |dw|."""
    import jax.numpy as jnp

    q, k, v, mask = make_inputs(seed=5)
    g = make_cotangent(seed=6)
    _, want = jax_flash(q, k, v, mask, g, GEOMETRY, (8, 6), dtype=jnp.bfloat16)
    _, got = port_call(q, k, v, mask, g, GEOMETRY, (8, 6), dtype=torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b, atol=2 ** -7 * np.abs(b).max(),
                                   err_msg=name)
    scale = max(abs(want[3]), abs(want[4]))
    for i in range(2):
        assert abs(float(got[3][i]) - want[3 + i]) <= 2 ** -7 * scale


def test_cross_length_kv():
    """Lq != Lk (the vision tower over [text K/V ; vision]), K blocked more
    finely than Q, so the last K tile is ragged."""
    q, _, _, _ = make_inputs(lq=9, lk=9)
    _, k, v, mask = make_inputs(lq=20, lk=20, seed=5)
    g = make_cotangent(lq=9)
    want_out, want = jax_flash(q, k, v, mask, g, CASES[0], (16, 8))
    got_out, got = port_call(q, k, v, mask, g, CASES[0], (16, 8))
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=ATOL)
    assert_grads_close(got, want, GRAD_ATOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4]])
def test_one_tile_equals_single_block_reference(case):
    """With L below both block sizes there is one tile: the flash forward is
    the single-block plain forward up to where each rounds (fp32: none),
    dropout included, since the one tile's seed is the single block's
    per-(b, head) seed; its gradients likewise."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(seed=7))
    g = torch.from_numpy(make_cotangent(seed=8))
    kw = dict(_kwargs(case, torch), compute_dtype=torch.float32, dropout_rate=0.2,
              deterministic=False, dropout_seed=99)
    flash = port.flash_attention_reference(q, k, v, mask, H, **kw)
    want = single.fused_attention_reference(q, k, v, mask, H, **kw)
    torch.testing.assert_close(flash, want, atol=1e-6, rtol=0)
    got_g = port.flash_attention_bwd_reference(q, k, v, mask, g, H, **kw)
    want_g = single.fused_attention_bwd_reference(q, k, v, mask, g, H, **kw)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


def _autograd(fn, q, k, v, g, w0, w1):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, w0, w1)]
    fn(*leaves).backward(g)
    return [x.grad for x in leaves]


def test_function_on_cpu_takes_plain_versions():
    """On CPU tensors the autograd.Function runs the plain forward and
    backward and launches nothing; the backward reads the saved output and
    lse (the same numbers as recomputing them); (w0, w1) get the dw."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(seed=3))
    g = torch.from_numpy(make_cotangent(seed=8))
    w0, w1 = torch.tensor([0.3]), torch.tensor([0.7])
    kw = dict(boundary=torch.tensor([5, 7]), row_start=0, compute_dtype=torch.float32,
              dropout_rate=0.1, deterministic=False, dropout_seed=17, block_q=8, block_k=6)
    before = (port.LAUNCHES_FLASH, port.LAUNCHES_FLASH_DKV, port.LAUNCHES_FLASH_DQ)
    got = _autograd(lambda q, k, v, a, b: port.flash_attention(
        q, k, v, mask, H, w0=a, w1=b, **kw), q, k, v, g, w0, w1)
    assert (port.LAUNCHES_FLASH, port.LAUNCHES_FLASH_DKV, port.LAUNCHES_FLASH_DQ) == before
    want = port.flash_attention_bwd_reference(q, k, v, mask, g, H, w0=w0, w1=w1, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat([got[3], got[4]]), want[3])


def test_plain_bwd_matches_autograd_of_plain_forward():
    """The written-out backward is the derivative of the tile-walking
    forward: autograd through flash_attention_reference gives the same
    gradients in fp32 (ragged tiles, dropout on)."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(seed=4))
    g = torch.from_numpy(make_cotangent(seed=10))
    w0, w1 = torch.tensor([0.3]), torch.tensor([0.7])
    kw = dict(boundary=torch.tensor([5, 7]), row_start=1, compute_dtype=torch.float32,
              dropout_rate=0.2, deterministic=False, dropout_seed=5, block_q=8, block_k=6)
    want = _autograd(lambda q, k, v, a, b: port.flash_attention_reference(
        q, k, v, mask, H, w0=a, w1=b, **kw), q, k, v, g, w0, w1)
    got = port.flash_attention_bwd_reference(q, k, v, mask, g, H, w0=w0, w1=w1, **kw)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(got[3], torch.cat(want[3:]), atol=GRAD_ATOL * 12, rtol=0)


def test_gradcheck_float64_multi_tile_with_dropout():
    """torch.autograd.gradcheck of the Function in float64 over ragged Q and
    K tiles, with the analogy geometry and dropout on."""
    rng = np.random.default_rng(12)
    b, lq, lk = 2, 7, 9
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, H * 4))).requires_grad_(True)
               for n in (lq, lk, lk))
    mask = torch.ones(b, lk, dtype=torch.float64)
    mask[:, -1] = 0.0
    w0 = torch.tensor([0.3], dtype=torch.float64, requires_grad=True)
    w1 = torch.tensor([0.7], dtype=torch.float64, requires_grad=True)

    def f(q, k, v, w0, w1):
        return port.flash_attention(
            q, k, v, mask, H, boundary=torch.tensor([2, 4]), w0=w0, w1=w1, row_start=0,
            dropout_rate=0.25, deterministic=False, dropout_seed=3,
            compute_dtype=torch.float64, block_q=4, block_k=4)

    assert torch.autograd.gradcheck(f, (q, k, v, w0, w1), eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["flash_attention_fwd", "flash_attention_bwd"])
def test_flash_build_without_nvcc_raises(monkeypatch, tmp_path, name):
    """A flash kernel that is not built and cannot be built raises; nothing
    falls back to the plain versions."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load(name)


# (Lq, Lk, geometry, block_q, block_k): the triple pre-train shapes, the
# analogy text shape, two Q tiles, two K tiles (the second ragged), and
# small tiles that leave both last tiles ragged
KERNEL_SHAPES = [(96, 96, False, 256, 512), (99, 195, False, 256, 512),
                 (128, 128, True, 256, 512), (512, 512, True, 256, 512),
                 (99, 611, False, 256, 512), (130, 200, True, 48, 72)]
# each shape in fp32 (the CUDA-core backward) and bf16 (the tensor-core
# one); then the flash edge cases, by name, in bf16: the tensor-core
# backward's 64-row chunks against the logical tiles
KERNEL_PARAMS = ([(shape, dtype) for shape in KERNEL_SHAPES
                  for dtype in (torch.float32, torch.bfloat16)]
                 + [(case[0], torch.bfloat16) for case in FLASH_EDGE_CASES])


def _card_inputs(device, lq, lk, geometry, dtype, seed=0, b=2):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, go = (torch.randn(b, n, 12 * 64, generator=g).to(device, dtype)
                   for n in (lq, lk, lk, lq))
    mask = torch.ones(b, lk)
    mask[:, lk - 7:] = 0.0
    kw = {}
    if geometry:
        kw = dict(boundary=torch.tensor([lq // 3, lq // 2], device=device),
                  w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))
    return q, k, v, go, mask.to(device), kw


def _card_case(device, shape, dtype):
    """(q, k, v, g, mask, keyword arguments with the blocks, Lk) of a kernel
    shape or an edge case's name, at 12 heads of 64."""
    if isinstance(shape, str):
        case = next(c for c in FLASH_EDGE_CASES if c[0] == shape)
        q, k, v, go, mask = (torch.from_numpy(x).to(device) for x in
                             flash_edge_inputs(case, heads=12, head_dim=64))
        q, k, v, go = (x.to(dtype) for x in (q, k, v, go))
        return q, k, v, go, mask, flash_edge_kwargs(case, torch, device), case[3]
    lq, lk, geometry, bq, bk = shape
    q, k, v, go, mask, kw = _card_inputs(device, lq, lk, geometry, dtype)
    return q, k, v, go, mask, dict(kw, block_q=bq, block_k=bk), lk


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", KERNEL_PARAMS)
def test_flash_kernels_match_plain_versions(cuda, shape, dtype):  # noqa: F811
    """The three CUDA kernels against the plain versions on the card (B=2,
    12 heads of 64), dropout on with the same seed: the backward on the
    CUDA cores in fp32 and on the tensor cores in bf16, by the dtype alone.
    Forward: 2e-5 fp32 (the same math summed in another order), 2e-2 bf16
    (one bf16 ulp of outputs ~1); lse 1e-5 where no batch row has all its
    keys masked (there lse sits at -1e4, where an fp32 ulp is 9.8e-4).
    Backward, from the kernel forward's out and lse: 2e-5 of each result's
    largest value in fp32, 2^-7 (2 bf16 ulps) in bf16; with one key dq and
    dk of test_torch_port_flash_edges.one_key_size (they cancel to rounding
    noise on both sides)."""
    q, k, v, go, mask, kw, lk = _card_case(cuda, shape, dtype)
    bq, bk = kw["block_q"], kw["block_k"]
    kw.update(compute_dtype=dtype, dropout_rate=0.1, deterministic=False, dropout_seed=11)
    bnd, w, geo, rate, seed = single._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
        kw.get("row_start", 0), kw.get("offset", 0), 0.1, False, 11)
    counts = (lambda: (port.LAUNCHES_FLASH, port.LAUNCHES_FLASH_DKV, port.LAUNCHES_FLASH_DQ,
                       port.LAUNCHES_FLASH_DKV_MMA, port.LAUNCHES_FLASH_DQ_MMA))
    before = counts()
    out, lse = port._launch_fwd(q, k, v, mask, 12, bnd, w, geo, rate, seed, bq, bk)
    got = port._launch_bwd(q, k, v, mask, go, lse, port._delta(go, out, 12), 12, bnd, w,
                           geo, rate, seed, bq, bk)
    torch.cuda.synchronize()
    mma = int(dtype == torch.bfloat16)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + mma,
                        before[4] + mma)
    want_out, want_lse = port._plain_fwd(q, k, v, mask, 12, bnd, w, geo, rate, seed, dtype,
                                         bq, bk)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol, rtol=0)
    if mask.any(dim=1).all():
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    want = port.flash_attention_bwd_reference(q, k, v, mask, go, 12, out=out, lse=lse, **kw)
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, b_ in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        size = b_.float().abs().max().item()
        if lk == 1 and name != "dv":
            size = max(size, one_key_size(*(x.float().cpu().numpy() for x in (q, k, v, go)),
                                          heads=12, head_dim=64))
        torch.testing.assert_close(a.float(), b_.float(), atol=rel * size, rtol=0)


@pytest.mark.cuda
def test_flash_launches_counted_through_autograd(cuda):  # noqa: F811
    """One forward and backward through flash_attention launches each of the
    three kernels once."""
    q, k, v = (torch.randn(2, 40, 768, device=cuda, requires_grad=True) for _ in range(3))
    mask = torch.ones(2, 40, device=cuda)
    before = (port.LAUNCHES_FLASH, port.LAUNCHES_FLASH_DKV, port.LAUNCHES_FLASH_DQ)
    port.flash_attention(q, k, v, mask, 12, compute_dtype=torch.float32).sum().backward()
    torch.cuda.synchronize()
    assert (port.LAUNCHES_FLASH, port.LAUNCHES_FLASH_DKV, port.LAUNCHES_FLASH_DQ) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()
