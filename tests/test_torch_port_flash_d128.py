"""Port parity of the flash (K-blocked) attention at head_dim 128 (ViLBERT's
visual stream with ``--fused_attention flash``: 1024 wide, 8 heads, 72
region tokens): the plain PyTorch forward and backward
(mkg_analogy_tpu_torch/kernels/flash_attention.py) against JAX's Pallas
flash kernels in interpret mode (``flash_attention`` and ``jax.vjp`` of it),
on the same numpy inputs at B=2, 8 heads of 128: one tile at 72 x 72;
several Q and K tiles through small ``block_q``/``block_k``, ragged at both
edges; the analogy geometry, in one tile and across tiles; one image's 36
regions masked; every key of a row masked; dropout 0.1 with the keep masks
compared bit for bit. Then what the wrappers pass and count at head_dim 128
(the scale of the call's width, the ``_D128`` launch counts), and the six
CUDA kernel instances at head_dim 128 against their plain versions (need a
card)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import flash_attention as port
from test_torch_port_attention import cuda  # noqa: F401

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

B, H, D = 2, 8, 128
REGIONS = 36           # RegionStore.num_regions: one image's share of the 72 keys
ATOL = 1e-5            # the JAX flash kernels' bar (tests/test_flash_attention.py:35)
REL_MASKED_ROW = 2e-3  # an all-masked row (tests/test_torch_port_attention_edges.py)
MASKED_ROW = 1         # the batch row "all_keys_masked" masks
GEOMETRY = dict(boundary=(30, 50), row_start=1, text_len=64)

# name -> (Lq, Lk, (block_q, block_k), geometry or None, mask layout). The
# small tiles leave both last tiles ragged: Q 32 + 32 + 8, K 40 + 40 + 19.
CASES = {
    "one_tile_72": (72, 72, (256, 512), None, "pad"),
    "ragged_tiles": (72, 99, (32, 40), None, "pad"),
    "geometry": (72, 72, (256, 512), GEOMETRY, "pad"),
    "geometry_ragged_tiles": (72, 99, (32, 40), GEOMETRY, "pad"),
    "one_image_masked": (72, 72, (256, 512), None, "one_image"),
    "all_keys_masked": (72, 99, (32, 40), None, "all"),
}


def make_mask(lk, layout):
    """(B, Lk) mask: the last 4 keys padded; "one_image" also masks the
    second image's 36 regions of batch row 0 (an image id of -1, as
    trainer._gather_images builds it), "all" every key of batch row 1."""
    mask = np.ones((B, lk), np.float32)
    mask[:, lk - 4:] = 0.0
    if layout == "one_image":
        mask[0, REGIONS:72] = 0.0
    if layout == "all":
        mask[MASKED_ROW] = 0.0
    return mask


def make_inputs(lq, lk, seed=0):
    """q, k, v and the cotangent g, standard normal."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, n, H * D)).astype(np.float32)
                 for n in (lq, lk, lk, lq))


def jax_flash(q, k, v, g, mask, geometry, blocks, rate=0.0, seed=0):
    """(out, dq, dk, dv, dw0, dw1) of the JAX flash kernels in interpret
    mode, fp32."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.flash_attention import flash_attention as jax_fa

    kw = {} if geometry is None else dict(geometry, boundary=jnp.asarray(geometry["boundary"]))

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry is not None else {}
        return jax_fa(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32,
                      interpret=True, dropout_rate=rate, deterministic=rate == 0.0,
                      dropout_seed=jnp.asarray(seed, jnp.int32), block_q=blocks[0],
                      block_k=blocks[1], **kw, **extra)

    args = [jnp.asarray(x) for x in (q, k, v)] + [jnp.asarray([0.3]), jnp.asarray([0.7])]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    return [np.asarray(out)] + [np.asarray(x) for x in grads[:3]] + [
        float(grads[3][0]), float(grads[4][0])]


def port_kwargs(geometry, device="cpu"):
    if geometry is None:
        return {}
    return dict(geometry, boundary=torch.tensor(geometry["boundary"], device=device),
                w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))


def port_flash(q, k, v, g, mask, geometry, blocks, rate=0.0, seed=0):
    """The same of the port's plain versions."""
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = dict(port_kwargs(geometry), compute_dtype=torch.float32, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=seed, block_q=blocks[0],
              block_k=blocks[1])
    out = port.flash_attention_reference(*t[:4], H, **kw)
    dq, dk, dv, dw = port.flash_attention_bwd_reference(*t, H, **kw)
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


def assert_parity(got, want, geometry, lq, masked_row=None):
    """Every result within ATOL; a batch row whose keys are all masked within
    REL_MASKED_ROW of its largest value (its scores sit at -1e4, where an
    fp32 ulp is 9.8e-4, and the products' summation order, torch.matmul's
    against XLA's dot, moves a score across that grid now and then:
    tests/test_torch_port_attention_edges.py, and at head_dim 128
    tests/test_torch_port_attention_d128.py::
    test_masked_row_gap_is_the_dots_summation_order)."""
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:4], want[:4]):
        for i in range(B):
            bar = ATOL
            if i == masked_row:
                bar = max(ATOL, REL_MASKED_ROW * float(np.abs(b[i]).max()))
            np.testing.assert_allclose(a[i], b[i], atol=bar, rtol=0,
                                       err_msg=f"{name}, batch row {i}")
    if geometry is not None:
        # dw sums ds * s_raw over a region of the score plane: the bar
        # scales with the number of rows summed (test_torch_port_flash.py)
        for name, a, b in zip(("dw0", "dw1"), got[4:], want[4:]):
            np.testing.assert_allclose(a, b, atol=ATOL * lq, rtol=0, err_msg=name)
    else:
        assert got[4] == 0.0 and got[5] == 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_plain_flash_d128_matches_jax_kernels(name):
    """Forward and backward of the plain flash versions at head_dim 128,
    where the scale 2^-3.5 is not a power of two, against jax.vjp of the
    three Pallas flash kernels: out, dq, dk, dv, dw0 and dw1 within 1e-5."""
    lq, lk, blocks, geometry, layout = CASES[name]
    q, k, v, g = make_inputs(lq, lk)
    mask = make_mask(lk, layout)
    want = jax_flash(q, k, v, g, mask, geometry, blocks)
    assert_parity(port_flash(q, k, v, g, mask, geometry, blocks), want, geometry, lq,
                  masked_row=MASKED_ROW if layout == "all" else None)


def test_plain_flash_d128_lse_matches_jax_kernel():
    """The forward's per-row log-sum-exp across ragged tiles, which the
    backward kernels read, against the Pallas forward's own lse output."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.flash_attention import _flash_attention_fwd

    lq, lk, blocks, geometry, layout = CASES["geometry_ragged_tiles"]
    q, k, v, _ = make_inputs(lq, lk, seed=4)
    mask = make_mask(lk, layout)
    geo = (geometry["row_start"], geometry["text_len"], 0)
    _, residuals = _flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(geometry["boundary"], jnp.int32), jnp.asarray([0.3, 0.7], jnp.float32),
        jnp.zeros((1,), jnp.int32), H, float(D) ** -0.5, 0.0, geo, True, jnp.float32, True,
        *blocks)
    want_lse = residuals[-1]
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    bnd, w, geo_p, rate, seed = single._resolve(
        t[0], torch.tensor(geometry["boundary"]), torch.tensor([0.3]), torch.tensor([0.7]),
        geometry["text_len"], geometry["row_start"], 0, 0.0, True, None)
    _, lse = port._plain_fwd(*t, H, bnd, w, geo_p, rate, seed, torch.float32, *blocks)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(lse.shape),
                               atol=ATOL, rtol=0)


def test_plain_flash_d128_dropout_masks_match_jax():
    """Dropout 0.1 keyed to the logical tiles at head_dim 128: the keep mask
    of every (batch row, head, q-tile, k-tile) equals JAX's interpret-mode
    ``_dropout_keep`` with the seed of ``_tile_seed``, bit for bit (the
    width takes no part in it), with a seed that wraps past int32."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import _dropout_keep

    seed, rate = 2 ** 31 - 9, 0.1
    lq, lk, (block_q, block_k), _, _ = CASES["ragged_tiles"]
    bq, bk, n_qblk, n_kblk = port._blocks(lq, lk, block_q, block_k)
    for qb in range(n_qblk):
        for kb in range(n_kblk):
            got = port._dropout_keep(B, H, bq, bk, rate, seed, qb, kb, n_qblk, n_kblk,
                                     "cpu").numpy()
            for bi in range(B):
                for h in range(H):
                    tile = jnp.asarray(seed, jnp.int32) + jnp.asarray(
                        ((bi * H + h) * n_qblk + qb) * n_kblk + kb, jnp.int32)
                    want = np.asarray(_dropout_keep((bq, bk), rate, tile, interpret=True))
                    assert np.array_equal(got[bi, h], want), (qb, kb, bi, h)


@pytest.mark.parametrize("name", ["ragged_tiles", "geometry"])
def test_plain_flash_d128_dropout_matches_jax_kernels(name):
    """Dropout 0.1 with one image's regions masked: forward and backward
    hold the fp32 bar against the Pallas kernels, which a single differing
    keep bit would break, and the dropout does change the output."""
    lq, lk, blocks, geometry, _ = CASES[name]
    q, k, v, g = make_inputs(lq, lk, seed=1)
    mask = make_mask(lk, "one_image")
    seed = 2 ** 31 - 9  # the tile seeds wrap past int32
    want = jax_flash(q, k, v, g, mask, geometry, blocks, rate=0.1, seed=seed)
    got = port_flash(q, k, v, g, mask, geometry, blocks, rate=0.1, seed=seed)
    assert_parity(got, want, geometry, lq)
    plain = port_flash(q, k, v, g, mask, geometry, blocks)
    assert np.abs(got[0] - plain[0]).max() > 1e-2


def test_function_on_cpu_takes_plain_versions_at_d128():
    """flash_attention on CPU tensors at head_dim 128, through autograd:
    the plain forward and backward, no launch counted."""
    q, k, v, g = (torch.from_numpy(x) for x in make_inputs(72, 72, seed=3))
    mask = torch.from_numpy(make_mask(72, "one_image"))
    kw = dict(compute_dtype=torch.float32, dropout_rate=0.1, deterministic=False,
              dropout_seed=17, block_q=32, block_k=40)
    before = launch_counts()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    port.flash_attention(*leaves, mask, H, **kw).backward(g)
    assert launch_counts() == before
    want = port.flash_attention_bwd_reference(q, k, v, mask, g, H, **kw)
    for leaf, w in zip(leaves, want[:3]):
        assert torch.equal(leaf.grad, w)


def launch_counts():
    return {name: getattr(port, name) for name in dir(port) if name.startswith("LAUNCHES_")}


def test_call_args_take_the_scale_of_the_calls_width(monkeypatch):
    """The launchers pass the head width of the call and its scale, d^-1/2:
    2^-3.5 at head_dim 128 (the scale of 64 would soften every score by
    2^0.5) and 2^-3 at 64."""
    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    for heads, d in ((8, 128), (12, 64)):
        q = torch.zeros(2, 72, heads * d)
        args = port._call_args(q, q, heads, None, 0.0, 0, 256, 512)
        assert args[3:7] == (heads, d, 0, float(d) ** -0.5), args


def test_launches_counted_by_width(monkeypatch):
    """Each launcher counts its launch in its kernel's count, in the _MMA
    count on the tensor-core route and, at head_dim 128, in the _D128
    sibling of each (the kernels themselves replaced: no card here)."""
    monkeypatch.setattr(port, "_fwd", lambda *a: (None, None))
    monkeypatch.setattr(port, "_dkv", lambda *a: (None, None, None))
    monkeypatch.setattr(port, "_dq", lambda *a: None)
    for name in launch_counts():
        monkeypatch.setattr(port, name, 0)
    for heads, d in ((8, 128), (12, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 4, heads * d, dtype=dtype)
            port._launch_fwd(q, q, q, None, heads, *([None] * 7))
            port._launch_bwd(q, q, q, None, q, None, None, heads, *([None] * 7))
    # two widths x two dtypes; half of them bf16, half at head_dim 128, one
    # quarter both
    want = {}
    for kernel in ("", "_DKV", "_DQ"):
        want[f"LAUNCHES_FLASH{kernel}"] = 4
        want[f"LAUNCHES_FLASH{kernel}_D128"] = 2
    for kernel in ("_FWD", "_DKV", "_DQ"):
        want[f"LAUNCHES_FLASH{kernel}_MMA"] = 2
        want[f"LAUNCHES_FLASH{kernel}_MMA_D128"] = 1
    assert launch_counts() == want


# ---------------------------------------------------------------- on the card

# (name, Lq, Lk, (block_q, block_k), geometry or None, mask layout): one
# resident tile, a second ragged K tile (the streamed forward), small tiles
# ragged at both edges, and an all-masked row
KERNEL_CASES = [
    ("visual_72x72", 72, 72, (256, 512), None, "one_image"),
    ("visual_72x72_geometry", 72, 72, (256, 512), GEOMETRY, "one_image"),
    ("ragged_130x611", 130, 611, (256, 512), None, "pad"),
    ("tiles_72x99_geometry", 72, 99, (32, 40), GEOMETRY, "pad"),
    ("masked_row_72x99", 72, 99, (32, 40), None, "all"),
]
KERNEL_IDS = [c[0] for c in KERNEL_CASES]


def kernel_inputs(case, dtype, device, seed=0):
    _, lq, lk, _, _, layout = case
    q, k, v, g = (torch.from_numpy(x).to(device, dtype) for x in make_inputs(lq, lk, seed))
    return q, k, v, g, torch.from_numpy(make_mask(lk, layout)).to(device)


def dw_scales(q, k, v, g, mask, lse, delta, bnd, w, geo, rate, seed, blocks):
    """sum |dS * S_raw| over each analogy region, walking the logical tiles
    as the plain backward does: the scale of the dw0 / dw1 sums."""
    tiles = port._Tiles(q.float(), k.float(), mask, H, bnd, w, geo, rate, seed, *blocks)
    qh, kh, vh, gh = (port._split_heads(x, H, torch.float32) for x in (q, k, v, g))
    scales = [0.0, 0.0]
    for qb in range(tiles.n_qblk):
        r0, r1 = tiles.rows(qb, q.shape[1])
        for kb in range(tiles.n_kblk):
            s_raw, planes, s = tiles.scores(qh[:, :, r0:r1], tiles.keys(kh, kb), qb, kb, r0, r1)
            p = torch.exp(s - lse[:, :, r0:r1, None])
            dp = torch.matmul(gh[:, :, r0:r1], tiles.keys(vh, kb).transpose(-1, -2))
            keep = tiles.keep(qb, kb, r0, r1, q.device)
            if keep is not None:
                dp = torch.where(keep, dp / (1.0 - rate), 0.0)
            terms = (p * (dp - delta[:, :, r0:r1, None]) * s_raw).abs()
            scales[0] += (terms * planes[1]).sum().item()
            scales[1] += (terms * planes[2]).sum().item()
    return scales


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=KERNEL_IDS)
def test_d128_flash_kernels_match_plain_versions(cuda, case, dtype):  # noqa: F811
    """The three flash kernels at head_dim 128, on the CUDA cores in fp32
    and on the tensor cores in bf16 (six instances), against the plain
    versions on the card, dropout 0.1 with the same seed. The bars of
    PERF.md section 2: forward 2e-5 fp32 / 2e-2 bf16 absolute, lse 1e-5
    (two fp32 ulps at -1e4 on a row whose keys are all masked:
    test_torch_port_flash.py says why); dq, dk and dv, from the kernel
    forward's out and lse, 2e-5 fp32 / 2^-7 bf16 of each result's largest
    value; dw 1e-5 of its sum of |terms|. Each launch counted once, at
    head_dim 128, on the route of its dtype."""
    name, lq, lk, blocks, geometry, _ = case
    q, k, v, g, mask = kernel_inputs(case, dtype, cuda)
    kw = dict(port_kwargs(geometry, cuda), compute_dtype=dtype, dropout_rate=0.1,
              deterministic=False, dropout_seed=11, block_q=blocks[0], block_k=blocks[1])
    bnd, w, geo, rate, seed = single._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
        kw.get("row_start", 0), kw.get("offset", 0), 0.1, False, 11)
    before = launch_counts()
    out, lse = port._launch_fwd(q, k, v, mask, H, bnd, w, geo, rate, seed, *blocks)
    delta = port._delta(g, out, H)
    got = port._launch_bwd(q, k, v, mask, g, lse, delta, H, bnd, w, geo, rate, seed, *blocks)
    torch.cuda.synchronize()
    mma = dtype == torch.bfloat16
    after = launch_counts()
    for count, n in after.items():
        want_n = before[count] + int("MMA" not in count or mma)
        assert n == want_n, (count, before[count], n)
    want_out, want_lse = port._plain_fwd(q, k, v, mask, H, bnd, w, geo, rate, seed, dtype,
                                         *blocks)
    torch.testing.assert_close(out.float(), want_out.float(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    keys = mask.any(dim=1)
    torch.testing.assert_close(lse[keys], want_lse[keys], atol=1e-5, rtol=0)
    torch.testing.assert_close(lse[~keys], want_lse[~keys], atol=2.0 ** -9, rtol=0)
    want = port.flash_attention_bwd_reference(q, k, v, mask, g, H, out=out, lse=lse, **kw)
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    for a, b_ in zip(got[:3], want[:3]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b_.float(),
                                   atol=rel * b_.float().abs().max().item(), rtol=0)
    if geometry is None:
        assert not got[3].any()
    else:
        scales = dw_scales(q, k, v, g, mask, lse, delta, bnd, w, geo, rate, seed, blocks)
        for i in range(2):
            assert abs(got[3][i].item() - want[3][i].item()) <= 1e-5 * scales[i], i
