"""The tiled fp32 flash forward (row 3 on the fp32 route):
csrc/flash_attention_fwd.cu, the forward of csrc/attention_fp32_fwd.cuh
(register micro-tiles, 64-row blocks, keys in staged tiles of 64 or 32) on
the flash contract: each logical (bq, bk) tile's max before any exponential,
one lse a row, m + log(l), the dropout mask keyed to the logical tiles, keys
past Lk never read.

On the CPU: the plain PyTorch mirror of that walk
(kernels/flash_attention.py:_tiled_fwd) against JAX's flash forward in
interpret mode on the same numpy inputs (2 heads, fp32, dropout 0 and 0.1):
out and lse at 96 x 96 with the multiplier, 99 x 195, 393 x 393 over
logical tiles of 96 x 160, 255 x 257 with an all-masked batch row, 513 x
511 with the +290 offset, 611 x 1 and 1 x 611 (head width 64), and at
widths 16, 72, 128, 136 and 256 over logical tiles of 48 x 72; against the
plain version; its keep masks bit for bit those of the plain version's
tiles; what the launcher hands the library. On the card (`cuda`): the
kernel against the plain version at the main-path shapes, FLAVA's, the edge
cases and a mesh rank's cells; two runs bit for bit; shared memory set by
the head width alone; a bf16 tensor raising at the CUDA-core launcher."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import flash_attention as fa
from test_torch_port_attention import cuda  # noqa: F401
from test_torch_port_attention_edges import assert_close_by_batch_row
from test_torch_port_flash_edges import FLASH_EDGE_CASES, flash_edge_inputs
from test_torch_port_flash_fp32_tiled import CARD_SHAPES, SEED, call_args, card_case

# JAX is imported where it is used (jax_forward): the card's machine runs the
# `cuda` tests of this file without it.

torch.set_num_threads(1)

H = 2
ATOL = 1e-5  # JAX's fp32 bar of its flash kernel (flash_attention.py:31-35)
WRAP_SEED = 2 ** 31 - 9  # tile seeds past int32
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
# the widths' case: 48-row logical tiles inside the 64-row blocks, 72-key
# logical tiles across the staged tiles of 64 (up to 64) or 32 keys
WIDTH_CASE = ("130x200_tiles_48x72", 2, 130, 200, dict(boundary=(40, 70), row_start=1), None,
              (48, 72))
WIDTHS = [16, 72, 128, 136, 256]
# An all-masked row scores near -1e4, where an fp32 ulp is 2^-10: the q·k
# products of the mirror (a torch.matmul of each 64-row block) and of JAX
# (XLA's dot of each logical tile) sum in other orders, so that row's max,
# and with it its lse, may sit an ulp apart (at 393 x 393 over 96 x 160
# tiles they do)
MASKED_ROW_LSE_ATOL = 2.0 ** -10


def jax_forward(case, q, k, v, mask, rate, head_dim):
    """(out, lse (B, heads, Lq)) of JAX's Pallas flash forward in interpret
    mode, fp32."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.flash_attention import _flash_attention_fwd

    b, lq = q.shape[:2]
    geometry = None
    bnd = jnp.zeros((b,), jnp.int32)
    if case[4] is not None:
        geo = case[4]
        geometry = (geo.get("row_start", 0), geo.get("text_len", lq), geo.get("offset", 0))
        bnd = jnp.asarray(geo["boundary"], jnp.int32)
    out, residuals = _flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), bnd,
        jnp.asarray([0.3, 0.7], jnp.float32), jnp.asarray([SEED], jnp.int32), H,
        float(head_dim) ** -0.5, rate, geometry, rate == 0.0, jnp.float32, True, *case[6])
    return np.asarray(out), np.asarray(residuals[-1]).reshape(b, H, lq)


def mirror(case, q, k, v, mask, rate, stride=None, cell_offset=0):
    """(out, lse) of the mirror and of the plain version on numpy inputs."""
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    _, args = call_args(case, t[0], t[1], rate, stride=stride, cell_offset=cell_offset)
    heads, bnd, w, geo, rate_, seed, bq, bk, stride = args
    got = fa._tiled_fwd(*t, heads, bnd, w, geo, rate_, seed, bq, bk, stride)
    plain = fa._plain_fwd(*t, heads, bnd, w, geo, rate_, seed, torch.float32, bq, bk, stride)
    return got, plain


def assert_lse_close(got, want, case):
    """lse within ATOL, an all-masked batch row within MASKED_ROW_LSE_ATOL."""
    for b in range(got.shape[0]):
        bar = MASKED_ROW_LSE_ATOL if b == case[5] else ATOL
        np.testing.assert_allclose(got[b], want[b], atol=bar, rtol=0,
                                   err_msg=f"lse batch row {b}")


def check_case(case, rate, head_dim):
    q, k, v, _, mask = flash_edge_inputs(case, head_dim=head_dim)
    (out, lse), (plain_out, plain_lse) = mirror(case, q, k, v, mask, rate)
    want_out, want_lse = jax_forward(case, q, k, v, mask, rate, head_dim)
    assert out.shape == q.shape and lse.shape == (q.shape[0], H, q.shape[1])
    for want, want_l in ((want_out, want_lse), (plain_out.numpy(), plain_lse.numpy())):
        assert_close_by_batch_row(out.numpy(), want, case, ATOL, "out")
        assert_lse_close(lse.numpy(), want_l, case)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tiled_forward_matches_jax(case, rate):
    """The fp32 flash forward kernel's walk, mirrored in plain PyTorch,
    against JAX's interpret-mode flash forward and against the plain
    version: out within 1e-5 (the all-masked batch row within REL_MASKED_ROW
    of its largest value, tests/test_torch_port_attention_edges.py says
    why), lse within 1e-5 (that row's within an ulp at 1e4). The keep masks
    must agree bit for bit, or the bars break."""
    check_case(case, rate, 64)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("head_dim", WIDTHS)
def test_tiled_forward_matches_jax_at_head_widths(head_dim, rate):
    """The same at the other widths the kernel takes (16, the padded 72 and
    136, ViLBERT's 128, 256), the staged key tiles of 64 or 32 against
    logical tiles of 48 x 72, with the multiplier from row 1."""
    check_case(WIDTH_CASE, rate, head_dim)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] != (256, 512)] + [WIDTH_CASE],
                         ids=lambda c: c[0])
def test_keep_masks_are_the_plain_versions_tiles(case):
    """Each element's keep bit from its logical tile (the kernel's one
    division a row and a column, _tile_keep) equals, tile by tile, the mask
    the plain version draws for that (qb, kb) tile (_dropout_keep, held to
    JAX's interpret-mode hash by tests/test_torch_port_flash_d128.py), bit
    for bit, also for a mesh rank's cells."""
    _, b, lq, lk, _, _, blocks = case
    for stride in (None, 7):
        bq, bk, n_qblk, n_kblk = fa._blocks(lq, lk, *blocks)
        whole = fa._tile_keep(b, lq, lk, H, 0.1, WRAP_SEED, *blocks, stride, "cpu")
        assert whole.shape == (b, H, lq, lk)
        for qb in range(n_qblk):
            for kb in range(n_kblk):
                r0, c0 = qb * bq, kb * bk
                tile = fa._dropout_keep(b, H, bq, bk, 0.1, WRAP_SEED, qb, kb, n_qblk, n_kblk,
                                        "cpu", stride)
                r1, c1 = min(lq, r0 + bq), min(lk, c0 + bk)
                assert torch.equal(whole[:, :, r0:r1, c0:c1], tile[:, :, :r1 - r0, :c1 - c0])
        assert 0.8 < whole.float().mean().item() < 0.97  # the dropout is there


def test_staged_key_tiles_only_reorder_the_sums():
    """Whatever the staged key tile (1, 32, 64 keys, or a whole logical tile
    of 512), the walk takes each logical tile's max before any exponential,
    as the plain version and JAX do: out and lse within 1e-5 of the plain
    version's, at two logical tiles."""
    case = ("99x611", 2, 99, 611, None, None, (256, 512))
    q, k, v, _, mask = (torch.from_numpy(x) for x in flash_edge_inputs(case))
    _, args = call_args(case, q, k, 0.1)
    heads, bnd, w, geo, rate, seed, bq, bk, stride = args
    want, want_lse = fa._plain_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed,
                                   torch.float32, bq, bk)
    for keys in (1, 32, 64, 512):
        out, lse = fa._tiled_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed, bq, bk,
                                 keys=keys)
        torch.testing.assert_close(out, want, atol=ATOL, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=0)


class _Lib:
    """A stand-in library: records each launcher's name and arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_smem"):
            return lambda *args: self.calls.append((name, args)) or 100_000
        return lambda *args: self.calls.append((name, args)) or 0


class _Props:
    shared_memory_per_block_optin = 232448


def test_fp32_launcher_hands_the_library_the_call(monkeypatch):
    """On the fp32 route the forward launcher asks for the shared memory of
    the logical tile's width and the head width, hands the library out and
    a (B, heads, Lq) fp32 lse, the logical tiles and a mesh rank's cell
    stride, and counts one launch; bf16 raises before any library call (the
    tensor-core kernel takes it)."""
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
    monkeypatch.setattr(fa, "_lib_fwd", lambda width=None: lib)
    b, lq, lk, d = 2, 70, 300, 64
    q = torch.zeros(b, lq, H * d)
    k = torch.zeros(b, lk, H * d)
    mask = torch.ones(b, lk)
    case = ("call", b, lq, lk, None, None, (64, 160))
    _, args = call_args(case, q, k, 0.1, stride=5)
    before = (fa.LAUNCHES_FLASH, fa.LAUNCHES_FLASH_FWD_MMA)
    out, lse = fa._launch_fwd(q, k, k, mask, *args)
    assert lib.calls[0] == ("mkg_flash_attention_fwd_smem", (160, d))  # bk head_dim
    name, fwd_args = lib.calls[1]
    assert name == "mkg_flash_attention_fwd" and len(lib.calls) == 2
    assert fwd_args[6:8] == (out.data_ptr(), lse.data_ptr())
    assert out.shape == q.shape and lse.shape == (b, H, lq) and lse.dtype == torch.float32
    tail = fwd_args[8:]
    assert tail[:6] == (b, lq, lk, H, d, 0)  # batch lq lk heads head_dim is_bf16
    assert tail[11] == 1 and tail[15] == 5  # dropout on; the cell stride
    assert tail[13] == pytest.approx(1.0 / 0.9)  # a kept weight's factor
    assert tail[16:20] == (64, 160, 2, 2)   # bq bk n_qblk n_kblk
    assert (fa.LAUNCHES_FLASH, fa.LAUNCHES_FLASH_FWD_MMA) == (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="float32"):
        fa._launch_fwd_cuda_cores(q.bfloat16(), k.bfloat16(), k.bfloat16(), mask, *args)
    assert len(lib.calls) == 2 and fa.LAUNCHES_FLASH == before[0] + 1


# ---------------------------------------------------------------- on the card


def kernel_fwd(q, k, v, mask, args):
    """(out, lse) of one launch of the fp32 flash forward, counted once."""
    before = fa.LAUNCHES_FLASH
    out, lse = fa._launch_fwd(q, k, v, mask, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_FLASH == before + 1
    return out, lse


def assert_kernel_close(out, lse, q, k, v, mask, kw, args, masked_row=None):
    """out within 2e-5 of flash_attention_reference (chip_smoke.py's fp32
    forward bar), lse within 1e-5 of the plain forward's, both finite."""
    heads, bnd, w, geo, rate, seed, bq, bk, stride = args
    want = fa.flash_attention_reference(q, k, v, mask, heads, **kw)
    _, want_lse = fa._plain_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed,
                                torch.float32, bq, bk, stride)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", CARD_SHAPES, ids=[c[0] for c in CARD_SHAPES])
def test_tiled_flash_forward_matches_plain_version(cuda, case, rate):  # noqa: F811
    """The fp32 flash forward on the card against the plain version at the
    triple pre-train shapes, ViLBERT's visual stream at 128, FLAVA's calls
    and the flash edge cases."""
    q, k, v, _, mask = card_case(case, cuda)
    kw, args = call_args(case, q, k, rate, cuda)
    out, lse = kernel_fwd(q, k, v, mask, args)
    assert_kernel_close(out, lse, q, k, v, mask, kw, args)


@pytest.mark.cuda
def test_tiled_flash_forward_takes_a_mesh_ranks_cells(cuda):  # noqa: F811
    """A mesh rank's call (cell stride 12 for its 2 of 12 heads, its first
    cell 7 folded into the seed) against the plain version with the same
    cells, dropout 0.1, at 393 x 393 over logical tiles of 96 x 160."""
    case = ("rank_393", 2, 393, 393, dict(boundary=(60, 100), row_start=1), None, (96, 160),
            64)
    q, k, v, _, mask = card_case(case, cuda)
    kw, args = call_args(case, q, k, 0.1, cuda, stride=12, cell_offset=7)
    out, lse = kernel_fwd(q, k, v, mask, args)
    assert_kernel_close(out, lse, q, k, v, mask, kw, args)


@pytest.mark.cuda
def test_tiled_flash_forward_repeats_bit_for_bit(cuda):  # noqa: F811
    """Two launches give the same out and lse bits."""
    case = ("393x393_tiles_96x160",) + _EDGES["393x393_tiles_96x160"][1:] + (64,)
    q, k, v, _, mask = card_case(case, cuda)
    _, args = call_args(case, q, k, 0.1, cuda)
    first, second = kernel_fwd(q, k, v, mask, args), kernel_fwd(q, k, v, mask, args)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_forward_shared_memory_fits_the_default_tiles(cuda, d):  # noqa: F811
    """The forward's shared memory grows with the logical tile's width (its
    scores) and fits the device's limit at JAX's default of 512 keys at
    every width; up to 128 keys at 64 it leaves room for two blocks an SM.
    Calls at one key, one row and 3000 keys launch and match the plain
    version."""
    from mkg_analogy_tpu_torch.kernels import build

    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    smem = fa._lib_fwd(build.library_width(d)).mkg_flash_attention_fwd_smem
    assert 0 < smem(1, d) < smem(fa.BLOCK_K, d) <= limit
    if d == 64:
        assert 2 * smem(128, d) <= limit
    gen = torch.Generator().manual_seed(d)
    for lq, lk in ((70, 1), (1, 70), (70, 3000)):
        q = torch.randn(1, lq, 2 * d, generator=gen).to(cuda)
        k, v = (torch.randn(1, lk, 2 * d, generator=gen).to(cuda) for _ in range(2))
        mask = torch.ones(1, lk, device=cuda)
        res = fa._resolve(q, None, None, None, None, 0, 0, 0.0, True, 0, 0, 1)
        args = (2, *res, fa.BLOCK_Q, fa.BLOCK_K, None)
        out, lse = kernel_fwd(q, k, v, mask, args)
        assert_kernel_close(out, lse, q, k, v, mask, dict(compute_dtype=torch.float32), args)


@pytest.mark.cuda
def test_bf16_raises_at_the_cuda_core_forward(cuda):  # noqa: F811
    """The CUDA-core forward is fp32 alone: a bf16 CUDA tensor raises there
    and launches nothing; the wrapper sends bf16 to the tensor cores."""
    q = torch.randn(1, 96, 2 * 64, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(1, 96, device=cuda)
    res = fa._resolve(q, None, None, None, None, 0, 0, 0.0, True, 0, 0, 1)
    args = (2, *res, fa.BLOCK_Q, fa.BLOCK_K)
    before = fa.LAUNCHES_FLASH
    with pytest.raises(ValueError, match="float32"):
        fa._launch_fwd_cuda_cores(q, q, q, mask, *args)
    assert fa.LAUNCHES_FLASH == before
    fa._launch_fwd(q, q, q, mask, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_FLASH == before + 1
