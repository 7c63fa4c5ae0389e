"""Port parity of rows 1-5 (the single-block and the flash attention) at head
widths other than 64 and 128: the repo's small recipes (``--hidden_size 32
--num_heads 2``: 16), MiniLM's 32, widths that are not multiples of 8 (13)
or 16 (8, 24, 40), and padded widths up to 112 (80, 96).

The plain PyTorch forward and backward (mkg_analogy_tpu_torch/kernels/
attention.py, flash_attention.py) against the JAX kernels in interpret mode
(``fused_attention``, ``flash_attention`` and ``jax.vjp`` of them) on the
same numpy inputs, B=2, 2 heads, 33 x 40: without a geometry or dropout, and
with the analogy geometry and dropout 0.1; the flash ones in one tile and in
ragged small tiles; the keep masks bit for bit. Then the wrappers' width
logic as pure functions (the padded width, the scale of the real width, the
libraries of other widths, head_dim 257 raising), and the CUDA kernels of
every width against their plain versions (need a card)."""

import re

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import build
from mkg_analogy_tpu_torch.kernels import flash_attention as flash
from test_torch_port_attention import cuda  # noqa: F401

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

B, H, LQ, LK = 2, 2, 33, 40
WIDTHS = (8, 13, 24, 40, 80, 96)
FWD_ATOL, BWD_ATOL = 1e-5, 2e-5
GEOMETRY = dict(boundary=(10, 20), row_start=1, text_len=30)
SEED = 2 ** 31 - 9  # the dropout cells' seeds wrap past int32
# name -> (geometry or None, dropout rate)
CASES = {"plain": (None, 0.0), "geometry_dropout": (GEOMETRY, 0.1)}
# logical flash tiles: one tile; ragged small tiles (Q 16 + 16 + 1, K 24 + 16)
BLOCKS = {"one_tile": (256, 512), "small_tiles": (16, 24)}


def make_inputs(d, seed=0):
    """q, k, v and the cotangent g, standard normal, (B, L, 2 heads * d)."""
    rng = np.random.default_rng(seed + d)
    return tuple(rng.standard_normal((B, n, H * d)).astype(np.float32)
                 for n in (LQ, LK, LK, LQ))


def make_mask():
    """(B, Lk): the last 4 keys of each row padded, 9 more of batch row 1."""
    mask = np.ones((B, LK), np.float32)
    mask[:, LK - 4:] = 0.0
    mask[1, LK - 13:] = 0.0
    return mask


def port_kwargs(geometry, device="cpu"):
    if geometry is None:
        return {}
    return dict(geometry, boundary=torch.tensor(geometry["boundary"], device=device),
                w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))


def jax_results(q, k, v, g, mask, geometry, rate, blocks=None):
    """(out, dq, dk, dv, dw0, dw1) of the JAX kernel (the flash kernels with
    ``blocks``) in interpret mode, fp32."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused
    from mkg_analogy_tpu.kernels.flash_attention import flash_attention as jax_flash

    kw = {} if geometry is None else dict(geometry, boundary=jnp.asarray(geometry["boundary"]))
    if blocks is not None:
        kw.update(block_q=blocks[0], block_k=blocks[1])
    fn = jax_fused if blocks is None else jax_flash

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry is not None else {}
        return fn(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32, interpret=True,
                  dropout_rate=rate, deterministic=rate == 0.0,
                  dropout_seed=jnp.asarray(SEED, jnp.int32), **kw, **extra)

    args = [jnp.asarray(x) for x in (q, k, v)] + [jnp.asarray([0.3]), jnp.asarray([0.7])]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    return [np.asarray(out)] + [np.asarray(x) for x in grads[:3]] + [
        float(grads[3][0]), float(grads[4][0])]


def port_results(q, k, v, g, mask, geometry, rate, blocks=None):
    """The same of the port's plain versions."""
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = dict(port_kwargs(geometry), compute_dtype=torch.float32, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=SEED)
    if blocks is None:
        out = single.fused_attention_reference(*t[:4], H, **kw)
        grads = single.fused_attention_bwd_reference(*t, H, **kw)
    else:
        kw.update(block_q=blocks[0], block_k=blocks[1])
        out = flash.flash_attention_reference(*t[:4], H, **kw)
        grads = flash.flash_attention_bwd_reference(*t, H, **kw)
    dq, dk, dv, dw = grads
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


def assert_parity(got, want, geometry):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL, rtol=0, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:4], want[1:4]):
        np.testing.assert_allclose(a, b, atol=BWD_ATOL, rtol=0, err_msg=name)
    if geometry is not None:
        # dw sums ds * s_raw over a region of the score plane: the bar
        # scales with the number of terms summed (test_torch_port_attention_bwd)
        for name, a, b in zip(("dw0", "dw1"), got[4:], want[4:]):
            np.testing.assert_allclose(a, b, atol=BWD_ATOL * LK, rtol=0, err_msg=name)
    else:
        assert got[4] == 0.0 and got[5] == 0.0


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_single_block_matches_jax_kernel(d, case):
    """Rows 1-2: the plain forward and backward at head width ``d`` (scale
    d^-1/2, a power of two at none of these widths) against the JAX kernel,
    out within 1e-5, dq, dk, dv within 2e-5; with dropout the keep masks
    must agree bit for bit, or the bars break."""
    geometry, rate = CASES[case]
    q, k, v, g = make_inputs(d)
    mask = make_mask()
    assert_parity(port_results(q, k, v, g, mask, geometry, rate),
                  jax_results(q, k, v, g, mask, geometry, rate), geometry)


@pytest.mark.parametrize("blocks", list(BLOCKS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_flash_matches_jax_kernels(d, case, blocks):
    """Rows 3-5: the plain flash forward and backward at head width ``d``
    against jax.vjp of the three Pallas flash kernels, in one logical tile
    and in ragged small tiles, at the bars of rows 1-2."""
    geometry, rate = CASES[case]
    q, k, v, g = make_inputs(d, seed=1)
    mask = make_mask()
    assert_parity(port_results(q, k, v, g, mask, geometry, rate, BLOCKS[blocks]),
                  jax_results(q, k, v, g, mask, geometry, rate, BLOCKS[blocks]), geometry)


def test_dropout_masks_match_jax_bit_for_bit():
    """The keep masks of rows 1-2 (one plane a cell) and of rows 3-5 (one a
    logical tile) at these shapes equal JAX's interpret-mode
    ``_dropout_keep`` bit for bit; the head width takes no part in them."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import _dropout_keep

    rate = 0.1
    got = single.dropout_keep(B, H, LQ, LK, rate, SEED, "cpu").numpy()
    for bi in range(B):
        for h in range(H):
            cell = jnp.asarray(SEED, jnp.int32) + jnp.asarray(bi * H + h, jnp.int32)
            want = np.asarray(_dropout_keep((LQ, LK), rate, cell, interpret=True))
            assert np.array_equal(got[bi, h], want), (bi, h)
    bq, bk, n_qblk, n_kblk = flash._blocks(LQ, LK, *BLOCKS["small_tiles"])
    for qb in range(n_qblk):
        for kb in range(n_kblk):
            got = flash._dropout_keep(B, H, bq, bk, rate, SEED, qb, kb, n_qblk, n_kblk,
                                      "cpu").numpy()
            for bi in range(B):
                for h in range(H):
                    tile = jnp.asarray(SEED, jnp.int32) + jnp.asarray(
                        ((bi * H + h) * n_qblk + qb) * n_kblk + kb, jnp.int32)
                    want = np.asarray(_dropout_keep((bq, bk), rate, tile, interpret=True))
                    assert np.array_equal(got[bi, h], want), (qb, kb, bi, h)


# ------------------------------------------------------- the width logic


def test_padded_width_and_library():
    """Every width from 1 to 128 runs the instance of its multiple of 16,
    and from 129 to 256 that of its multiple of 64; 64 and 128 the nine
    libraries' own (no library of their own), the others the library of
    their padded width, whose name and hash carry the define."""
    for d in range(1, 257):
        step = 16 if d <= 128 else 64
        assert build.padded_width(d) == -(-d // step) * step
        assert build.library_width(d) == (None if d in (64, 128) else build.padded_width(d))
    assert [build.padded_width(d) for d in (8, 13, 16, 20, 24, 32, 40, 80, 96, 112, 129, 192,
                                            193, 256)] == [
        16, 16, 16, 32, 32, 32, 48, 80, 96, 112, 192, 192, 256, 256]
    base = build.library_path("fused_attention_fwd")
    d16 = build.library_path("fused_attention_fwd", 16)
    assert re.fullmatch(r"libfused_attention_fwd_[0-9a-f]{12}\.so", base.name), base.name
    assert re.fullmatch(r"libfused_attention_fwd_d16_[0-9a-f]{12}\.so", d16.name), d16.name
    assert d16.name[-15:] != base.name[-15:]  # the define is hashed


@pytest.mark.parametrize("d", [0, 257, 300])
def test_widths_beyond_the_limit_raise(d):
    """head_dim 257 (or 0) has no instance: a ValueError naming the limit."""
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        build.padded_width(d)


def test_scale_is_the_real_widths(monkeypatch):
    """The launchers pass the call's own width and d^-1/2 of it, never the
    padded width's scale (16^-1/2 for a call at 13 would sharpen every
    score by 1.1x)."""
    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    for d in WIDTHS + (16, 32, 112):
        assert single.scale_of(d) == float(d) ** -0.5
        q = torch.zeros(2, 8, H * d)
        args = flash._call_args(q, q, H, None, 0.0, 0, 256, 512)
        assert args[3:7] == (H, d, 0, float(d) ** -0.5), args
        assert single._call_tail(q, d, None, 0.0, 0, None, 1.0)[0] == float(d) ** -0.5


def test_cpu_route_takes_the_plain_versions_at_any_width():
    """CPU tensors take the plain versions at any width, 300 included, and
    count no launch; nothing checks the kernels' limit there."""
    for d in (13, 300):
        q, k, v, g = (torch.from_numpy(x) for x in make_inputs(d))
        mask = torch.from_numpy(make_mask())
        counts = (single.LAUNCHES, flash.LAUNCHES_FLASH, dict(single.WIDTH_LAUNCHES),
                  dict(flash.WIDTH_LAUNCHES_FLASH))
        for fn in (single.fused_attention, flash.flash_attention):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*leaves, mask, H, compute_dtype=torch.float32)
            out.backward(g)
            assert torch.isfinite(out).all() and all(torch.isfinite(x.grad).all()
                                                     for x in leaves)
        assert counts == (single.LAUNCHES, flash.LAUNCHES_FLASH, dict(single.WIDTH_LAUNCHES),
                          dict(flash.WIDTH_LAUNCHES_FLASH))


def test_build_widths_builds_the_padded_widths_libraries(monkeypatch):
    """``build_widths`` asks for the eight attention sources at each padded
    width other than 64 and 128, once; the CLI's cache builds them for a
    CUDA device only."""
    from mkg_analogy_tpu_torch.core import cache

    jobs = []
    monkeypatch.setattr(build, "build_jobs", lambda js: jobs.append(sorted(js, key=str)))
    build.build_widths([16, 13, 64, 128, 32, 50])
    assert jobs == [sorted([(n, w) for w in (16, 32, 64) for n in build.ATTENTION_SOURCES],
                           key=str)]
    calls = []
    monkeypatch.setattr(build, "build", lambda names=(): calls.append("nine"))
    monkeypatch.setattr(build, "build_widths", lambda dims: calls.append(sorted(dims)))
    cache.enable_compilation_cache("cpu", head_dims=[16])
    assert calls == []
    cache.enable_compilation_cache("cuda", kernels=False, head_dims=[16, 32])
    assert calls == [[16, 32]]


def test_models_head_widths():
    """The widths whose libraries the CLI builds: the attention cores' own,
    each once (the small recipe's 16 in both towers of MKGformer)."""
    from mkg_analogy_tpu_torch.models.common import attention_head_dims
    from mkg_analogy_tpu_torch.models.registry import create_model

    model = create_model("MKGformerKGC", vocab_size=64, dtype="float32", hidden_size=32,
                         num_layers=2, num_heads=2, intermediate_size=64)
    assert attention_head_dims(model) == [16]


# ---------------------------------------------------------------- on the card

# 56 from the padded library of 64, 116 and 120 from that of 128 (its blocks
# split a head into 64-column halves, the second of d - 64 columns)
KERNEL_WIDTHS = (8, 13, 16, 20, 24, 32, 40, 56, 80, 96, 112, 116, 120)


def kernel_inputs(d, dtype, device, lq=99, lk=227, seed=0):
    """q, k, v, g (B=2, 2 heads of d) and the mask, the last 40 keys of
    batch row 1 padded."""
    gen = torch.Generator().manual_seed(seed + d)
    q, g = (torch.randn(B, lq, H * d, generator=gen).to(device, dtype) for _ in range(2))
    k, v = (torch.randn(B, lk, H * d, generator=gen).to(device, dtype) for _ in range(2))
    mask = torch.ones(B, lk)
    mask[1, lk - 40:] = 0.0
    return q, k, v, g, mask.to(device)


def assert_close_to(got, want, rel):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=rel * b.float().abs().max().item() + 1e-30, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", KERNEL_WIDTHS)
def test_single_block_kernels_match_plain_version(cuda, d, dtype):  # noqa: F811
    """Rows 1-2 at head width ``d`` on the card, with the geometry and
    dropout 0.1: the forward within 2e-5 fp32 / 2e-2 bf16, the backward
    within 2e-5 / 2^-7 of each result's largest; each launch counted under
    its width."""
    # 99 x 227: from padded width 112 the fp32 kernels' K and V of 227
    # keys pass a block's shared memory, and they stream them
    q, k, v, g, mask = kernel_inputs(d, dtype, cuda)
    kw = dict(port_kwargs(dict(GEOMETRY, text_len=None), cuda), compute_dtype=dtype,
              dropout_rate=0.1, deterministic=False, dropout_seed=5)
    before = (single.WIDTH_LAUNCHES["fwd", d], single.WIDTH_LAUNCHES["bwd", d])
    got = single.fused_attention(q, k, v, mask, H, **kw)
    want = single.fused_attention_reference(q, k, v, mask, H, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    bnd, w, geo, rate, seed = single._resolve(q, kw["boundary"], kw["w0"], kw["w1"], None,
                                              kw["row_start"], 0, 0.1, False, 5)
    grads = single._launch_bwd(q, k, v, mask, g, H, bnd, w, geo, rate, seed)
    torch.cuda.synchronize()
    assert (single.WIDTH_LAUNCHES["fwd", d], single.WIDTH_LAUNCHES["bwd", d]) == (
        before[0] + 1, before[1] + 1)
    want = single.fused_attention_bwd_reference(q, k, v, mask, g, H, **kw)
    # dq, dk, dv (chip_smoke's head_widths phase holds dw to its terms' sum)
    assert_close_to(grads[:3], want[:3], 2e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", KERNEL_WIDTHS)
def test_flash_kernels_match_plain_versions(cuda, d, dtype):  # noqa: F811
    """Rows 3-5 at head width ``d`` on the card, in ragged small tiles with
    the geometry and dropout 0.1: out within 2e-5 / 2e-2 and lse within
    1e-5 of the plain forward; dq, dk, dv from the kernels' out and lse
    within 2e-5 / 2^-7 of each result's largest."""
    q, k, v, g, mask = kernel_inputs(d, dtype, cuda, lq=96, lk=96, seed=1)
    kw = port_kwargs(dict(GEOMETRY, text_len=None), cuda)
    bnd, w, geo, rate, seed = single._resolve(q, kw["boundary"], kw["w0"], kw["w1"], None,
                                              kw["row_start"], 0, 0.1, False, 6)
    args = (H, bnd, w, geo, rate, seed, 48, 80)
    before = flash.WIDTH_LAUNCHES_FLASH["", d]
    out, lse = flash._launch_fwd(q, k, v, mask, *args)
    want_out, want_lse = flash._plain_fwd(q, k, v, mask, *args[:6], dtype, *args[6:])
    torch.cuda.synchronize()
    assert flash.WIDTH_LAUNCHES_FLASH["", d] == before + 1
    torch.testing.assert_close(out.float(), want_out.float(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    delta = flash._delta(g, out, H)
    grads = flash._launch_bwd(q, k, v, mask, g, lse, delta, *args)
    want = flash._plain_bwd(q, k, v, mask, g, lse, delta, *args[:6], dtype, *args[6:])
    torch.cuda.synchronize()
    assert_close_to(grads[:3], want[:3], 2e-5 if dtype == torch.float32 else 2 ** -7)
