"""The tiled fp32 flash backward (rows 4-5 on the fp32 route):
csrc/flash_attention_bwd.cu, the dK/dV and dQ passes of
csrc/attention_fp32_bwd.cuh (register micro-tiles, 64-row tiles, one sweep
over the other side) on the flash contract: p = exp(s - lse) from row 3's
one lse a row, delta = rowsum(g · out) from the wrapper, the dropout mask
keyed to the logical (bq, bk) tiles, one (dw0, dw1) partial per 64 keys.

On the CPU: the plain PyTorch mirror of that walk
(kernels/flash_attention.py:_tiled_bwd) against JAX's flash backward in
interpret mode on the same numpy inputs (2 heads of 64, fp32, dropout 0 and
0.1) at 96 x 96 with the multiplier, 99 x 195, 393 x 393 with logical tiles
of 96 x 160, 255 x 257 with an all-masked batch row, 513 x 511 with the
+290 offset, 611 x 1 and 1 x 611, and against the plain version; what the
launchers hand the library. On the card (`cuda`): the kernels against the
plain versions at the main-path shapes, FLAVA's, the edge cases and a mesh
rank's cell stride; two runs bit for bit; shared memory set by the head
width alone."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import flash_attention as fa
from test_torch_port_attention import cuda  # noqa: F401
from test_torch_port_attention_edges import assert_close_by_batch_row
from test_torch_port_flash_edges import (
    FLASH_EDGE_CASES,
    flash_edge_inputs,
    flash_edge_kwargs,
    jax_flash,
    one_key_size,
)

# JAX is imported where it is used (jax_flash): the card's machine runs the
# `cuda` tests of this file without it.

torch.set_num_threads(1)

H, D = 2, 64
ATOL = 1e-5  # the per-op bar (tests/test_fused_attention.py:74)
SEED = 41
_EDGES = {c[0]: c for c in FLASH_EDGE_CASES}
# (name, B, Lq, Lk, geometry or None, batch row whose keys are all masked or
# None, (block_q, block_k)), as FLASH_EDGE_CASES
CASES = [
    ("96x96_multiplier", 2, 96, 96, dict(boundary=(30, 50), row_start=0), None, (256, 512)),
    ("99x195", 2, 99, 195, None, None, (256, 512)),
    _EDGES["393x393_tiles_96x160"],
    _EDGES["255x257_masked_row"],
    _EDGES["513x511_offset_290"],
    _EDGES["611x1"],
    _EDGES["1x611"],
]
CASE_IDS = [c[0] for c in CASES]


def call_args(case, q, k, rate, device="cpu", stride=None, cell_offset=0):
    """(kw, args) of a case's call in fp32: the keywords of the plain
    versions, and the arguments after (q, k, v, mask[, g, lse, delta]) of
    the launchers (heads, the resolved call, the logical tiles, the cell
    stride)."""
    kw = flash_edge_kwargs(case, torch, device)
    bq, bk = kw["block_q"], kw["block_k"]
    res = fa._resolve(q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
                      kw.get("row_start", 0), kw.get("offset", 0), rate, rate == 0.0, SEED,
                      cell_offset, fa._tile_count(q, k, bq, bk))
    kw.update(compute_dtype=torch.float32, dropout_rate=rate, deterministic=rate == 0.0,
              dropout_seed=SEED, cell_stride=stride, cell_offset=cell_offset)
    return kw, (H, *res, bq, bk, stride)


def mirror_results(case, q, k, v, g, mask, rate):
    """(dq, dk, dv, dw) of the mirror, from the plain forward's out and lse
    (the kernels take row 3's)."""
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    _, args = call_args(case, t[0], t[1], rate)
    heads, bnd, w, geo, rate_, seed, bq, bk, stride = args
    out, lse = fa._plain_fwd(*t[:4], heads, bnd, w, geo, rate_, seed, torch.float32, bq, bk)
    delta = fa._delta(t[4], out, heads)
    return fa._tiled_bwd(*t, lse, delta, *args[:6], bq, bk, stride)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tiled_mirror_matches_jax(case, rate):
    """The fp32 flash backward kernels' walk, mirrored in plain PyTorch,
    against jax.vjp of JAX's interpret-mode flash kernels: dq, dk and dv
    within 1e-5 of each result's largest |value| (with one key dq and dk of
    one_key_size: dS cancels to rounding noise), the all-masked batch row
    within REL_MASKED_ROW (2e-3) of its largest value
    (tests/test_torch_port_attention_edges.py says why); dw0/dw1 within 1e-5 for each row they sum
    over. Against the plain version at the same bars. The keep masks must
    agree bit for bit, or the bars break."""
    q, k, v, g, mask = flash_edge_inputs(case)
    got = mirror_results(case, q, k, v, g, mask, rate)
    want_jax = jax_flash(case, q, k, v, mask, g, rate, SEED)[1:]
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    plain = fa.flash_attention_bwd_reference(*t, H, **call_args(case, t[0], t[1], rate)[0])
    want_plain = [x.numpy() for x in plain[:3]] + [float(plain[3][0]), float(plain[3][1])]
    for want in (want_jax, want_plain):
        for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            size = float(np.abs(b).max())
            if case[3] == 1 and name != "dv":
                size = max(size, one_key_size(q, k, v, g))
            assert_close_by_batch_row(a.numpy(), b, case, ATOL * size, name)
        if case[4] is None:
            assert not got[3].any()
        else:
            for i, name in enumerate(("dw0", "dw1")):
                np.testing.assert_allclose(float(got[3][i]), want[3 + i],
                                           atol=ATOL * case[2], err_msg=name)


def test_cases_cross_the_physical_and_logical_tiles():
    """What the 64-row tiles of both passes must get right: 96 and 99 rows
    and keys fill their second tile in part; 393 x 393's logical 96 x 160
    tiles straddle them (neither divides 64, nor 64 them); 513 x 511 has a
    one-row second logical Q tile in the middle of a physical one; 611 x 1
    and 1 x 611 a single physical tile on one side."""
    for name, _, lq, lk, _, _, blocks in CASES:
        bq, bk, _, _ = fa._blocks(lq, lk, *blocks)
        assert lq % 64 or lk % 64 or bq % 64 or bk % 64, name
    assert fa._blocks(393, 393, 96, 160)[:2] == (96, 160)
    assert fa._blocks(513, 511, 256, 512)[2] == 3
    assert fa.KEYS_PER_BLOCK == 64


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
    """On the fp32 route the dK/dV and dQ launchers hand the library the
    forward's lse and the wrapper's delta, (B, heads, Lq) fp32; dK/dV one
    (dw0, dw1) partial per 64 keys, which it sums; the logical tiles and a
    mesh rank's cell stride; each launch counted once. bf16 raises: the
    tensor-core kernels take it."""
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
    monkeypatch.setattr(fa, "_lib_bwd", lambda width=None: lib)
    empties = []
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        empties.append(out)
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    b, lq, lk = 2, 70, 300
    q = torch.zeros(b, lq, H * D)
    k = torch.zeros(b, lk, H * D)
    mask = torch.ones(b, lk)
    lse = torch.zeros(b, H, lq)
    delta = torch.zeros(b, H, lq)
    case = ("call", b, lq, lk, None, None, (64, 160))
    _, args = call_args(case, q, k, 0.1, stride=5)
    before = (fa.LAUNCHES_FLASH_DKV, fa.LAUNCHES_FLASH_DQ)
    dk, dv, dw = fa._launch_bwd_dkv(q, k, k, mask, q, lse, delta, *args)
    name, dkv_args = lib.calls[-1]
    assert name == "mkg_flash_attention_bwd_dkv"
    assert dkv_args[7:9] == (lse.data_ptr(), delta.data_ptr())
    dw_part = next(t for t in empties if t.data_ptr() == dkv_args[11])
    assert dw_part.shape == (b, H, -(-lk // 64), 2) and dw_part.dtype == torch.float32
    assert dkv_args[9:11] == (dk.data_ptr(), dv.data_ptr())
    tail = dkv_args[12:]
    assert tail[:6] == (b, lq, lk, H, D, 0)  # batch lq lk heads head_dim is_bf16
    assert tail[11] == 1 and tail[15] == 5  # dropout on; the cell stride
    assert tail[16:20] == (64, 160, 2, 2)   # bq bk n_qblk n_kblk
    dq = fa._launch_bwd_dq(q, k, k, mask, q, lse, delta, *args)
    name, dq_args = lib.calls[-1]
    assert name == "mkg_flash_attention_bwd_dq" and len(lib.calls) == 2
    assert dq_args[7:10] == (lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    assert dq_args[10:] == tail
    assert (fa.LAUNCHES_FLASH_DKV, fa.LAUNCHES_FLASH_DQ) == (before[0] + 1, before[1] + 1)
    for launch in (fa._launch_bwd_dkv_cuda_cores, fa._launch_bwd_dq_cuda_cores):
        with pytest.raises(ValueError, match="float32"):
            launch(q.bfloat16(), k.bfloat16(), k.bfloat16(), mask, q.bfloat16(), lse, delta,
                   *args)
    assert len(lib.calls) == 2


# ---------------------------------------------------------------- on the card

# (name, B, Lq, Lk, geometry, masked row, blocks, head_dim): the triple
# pre-train's text, vision and vision-over-text calls, ViLBERT's visual
# stream at 128, FLAVA's text, image and multimodal calls (B=2 here)
CARD_SHAPES = [
    ("text_96", 2, 96, 96, dict(boundary=(30, 50), row_start=0), None, (256, 512), 64),
    ("vision_99", 2, 99, 99, None, None, (256, 512), 64),
    ("vision_text_99x195", 2, 99, 195, None, None, (256, 512), 64),
    ("vilbert_visual_72", 2, 72, 72, None, None, (256, 512), 128),
    ("flava_text_128", 2, 128, 128, dict(boundary=(40, 60), row_start=1), None, (256, 512),
     64),
    ("flava_image_393", 2, 393, 393, None, None, (256, 512), 64),
    ("flava_multimodal_522", 2, 522, 522, None, None, (256, 512), 64),
] + [c + (64,) for c in FLASH_EDGE_CASES]


def card_case(case, device, dtype=torch.float32):
    name, b, lq, lk, geometry, masked_row, blocks, d = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, n, H * d)).astype(np.float32))
                  .to(device, dtype) for n in (lq, lk, lk, lq))
    mask = torch.ones(b, lk)
    mask[:, lk - lk // 8:] = 0.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    return q, k, v, g, mask.to(device)


def kernel_bwd(q, k, v, g, mask, args):
    """(out, lse, delta, (dq, dk, dv, dw)) of the row 3 forward kernel and
    the two backward kernels, each launch counted once."""
    before = (fa.LAUNCHES_FLASH_DKV, fa.LAUNCHES_FLASH_DQ)
    out, lse = fa._launch_fwd(q, k, v, mask, *args)
    delta = fa._delta(g, out, H)
    grads = fa._launch_bwd(q, k, v, mask, g, lse, delta, *args)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FLASH_DKV, fa.LAUNCHES_FLASH_DQ) == (before[0] + 1, before[1] + 1)
    return out, lse, delta, grads


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", CARD_SHAPES, ids=[c[0] for c in CARD_SHAPES])
def test_tiled_flash_kernels_match_plain_versions(cuda, case, rate):  # noqa: F811
    """The fp32 flash backward kernels on the card against the plain
    backward from the same forward's out and lse: dq, dk and dv within
    2e-5 of each result's largest |value| (of one_key_size for dq and dk
    with one key), dw within 2e-5 for each row it sums over."""
    q, k, v, g, mask = card_case(case, cuda)
    kw, args = call_args(case, q, k, rate, cuda)
    out, lse, _, grads = kernel_bwd(q, k, v, g, mask, args)
    want = fa.flash_attention_bwd_reference(q, k, v, mask, g, H, out=out, lse=lse, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), grads[:3], want[:3]):
        assert torch.isfinite(a).all()
        size = b.abs().max().item()
        if case[3] == 1 and name != "dv":
            size = max(size, one_key_size(*(x.cpu().numpy() for x in (q, k, v, g)),
                                          head_dim=case[7]))
        torch.testing.assert_close(a, b, atol=2e-5 * size, rtol=0, msg=name)
    torch.testing.assert_close(grads[3], want[3], atol=2e-5 * case[2], rtol=0)


@pytest.mark.cuda
def test_tiled_flash_kernels_take_a_mesh_ranks_cells(cuda):  # noqa: F811
    """A mesh rank's call (cell stride 12 for its 2 of 12 heads, its first
    cell 7 folded into the seed; tests/test_torch_port_dropout_cells.py
    holds such a slice to the whole call bit for bit) against the plain
    backward with the same cells, dropout 0.1, at 393 x 393 over logical
    tiles of 96 x 160."""
    case = ("rank_393", 2, 393, 393, dict(boundary=(60, 100), row_start=1), None, (96, 160),
            64)
    q, k, v, g, mask = card_case(case, cuda)
    kw, args = call_args(case, q, k, 0.1, cuda, stride=12, cell_offset=7)
    out, lse, _, grads = kernel_bwd(q, k, v, g, mask, args)
    want = fa.flash_attention_bwd_reference(q, k, v, mask, g, H, out=out, lse=lse, **kw)
    for a, b in zip(grads[:3], want[:3]):
        torch.testing.assert_close(a, b, atol=2e-5 * b.abs().max().item(), rtol=0)
    torch.testing.assert_close(grads[3], want[3], atol=2e-5 * case[2], rtol=0)


@pytest.mark.cuda
def test_tiled_flash_kernels_repeat_bit_for_bit(cuda):  # noqa: F811
    """Two runs of the backward give the same bits, dw included: no float
    atomics, the dw partials summed in a fixed order."""
    case = ("393x393_tiles_96x160",) + _EDGES["393x393_tiles_96x160"][1:] + (64,)
    q, k, v, g, mask = card_case(case, cuda)
    _, args = call_args(case, q, k, 0.1, cuda)
    first = kernel_bwd(q, k, v, g, mask, args)[3]
    second = kernel_bwd(q, k, v, g, mask, args)[3]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_shared_memory_is_set_by_the_head_width_alone(cuda, d):  # noqa: F811
    """The backward pair's shared memory depends on the head width alone and
    fits the device's limit; calls at one key, one row and 3000 keys launch
    and match the plain backward."""
    from mkg_analogy_tpu_torch.kernels import build

    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    smem = fa._lib_bwd(build.library_width(d)).mkg_flash_attention_bwd_smem(d)
    assert 0 < smem <= limit
    gen = torch.Generator().manual_seed(d)
    for lq, lk in ((70, 1), (1, 70), (70, 3000)):
        q, g = (torch.randn(1, lq, 2 * d, generator=gen).to(cuda) for _ in range(2))
        k, v = (torch.randn(1, lk, 2 * d, generator=gen).to(cuda) for _ in range(2))
        mask = torch.ones(1, lk, device=cuda)
        res = fa._resolve(q, None, None, None, None, 0, 0, 0.0, True, 0, 0, 1)
        args = (2, *res, fa.BLOCK_Q, fa.BLOCK_K)
        out, lse = fa._launch_fwd(q, k, v, mask, *args)
        delta = fa._delta(g, out, 2)
        grads = fa._launch_bwd(q, k, v, mask, g, lse, delta, *args)
        want = fa.flash_attention_bwd_reference(q, k, v, mask, g, 2, out=out, lse=lse,
                                                compute_dtype=torch.float32)
        torch.cuda.synchronize()
        for a, b in zip(grads[:3], want[:3]):
            scale = max(b.abs().max().item(), 1.0 if lk == 1 else 0.0)
            torch.testing.assert_close(a, b, atol=2e-5 * scale, rtol=0)
