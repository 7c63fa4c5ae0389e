"""Port parity of the single-block attention at head_dim 128 (ViLBERT's
visual stream: 1024 wide, 8 heads, 72 region tokens): the plain PyTorch
forward and backward (mkg_analogy_tpu_torch/kernels/attention.py) against
the JAX kernel in interpret mode (``fused_attention`` and ``jax.vjp`` of it),
on the same numpy inputs at B=2, Lq=Lk=72, 8 heads of 128: without and with
the analogy geometry, one image's 36 regions masked, every key of a row
masked, and dropout 0.1 with the keep masks compared bit for bit. Plus the
four CUDA kernels at head_dim 128 against their plain versions, and a width
neither kernel set takes (need a card)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as port
from test_torch_port_attention import cuda  # noqa: F401

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

B, L, H, D = 2, 72, 8, 128
REGIONS = 36  # RegionStore.num_regions: one image's share of the 72 keys
ATOL = 1e-5   # the per-op bar (tests/test_fused_attention.py:74)
REL_MASKED_ROW = 2e-3  # an all-masked row (tests/test_torch_port_attention_edges.py)
MASKED_ROW = 1         # the batch row "all_keys_masked" masks

# name -> (geometry keywords or None, mask) for the parity cases
CASES = {
    "plain": None,
    "geometry": dict(boundary=(30, 50), row_start=1, text_len=64),
    "one_image_masked": None,
    "all_keys_masked": None,
}


def make_mask(name):
    """(B, Lk) mask: the last 4 keys padded; "one_image_masked" also masks
    the second image's 36 regions of batch row 0 (an image id of -1, as
    trainer._gather_images builds it), "all_keys_masked" every key of batch
    row 1 (both image ids missing)."""
    mask = np.ones((B, L), np.float32)
    mask[:, L - 4:] = 0.0
    if name == "one_image_masked":
        mask[0, REGIONS:] = 0.0
    if name == "all_keys_masked":
        mask[MASKED_ROW] = 0.0
    return mask


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, L, H * D)).astype(np.float32) for _ in range(4))


def jax_forward_and_grads(q, k, v, g, mask, geometry, rate=0.0, seed=0):
    """(out, dq, dk, dv, dw0, dw1) of the JAX kernel in interpret mode."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused

    kw = {}
    if geometry is not None:
        kw = dict(geometry, boundary=jnp.asarray(geometry["boundary"]))

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry is not None else {}
        return jax_fused(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32,
                         interpret=True, dropout_rate=rate, deterministic=rate == 0.0,
                         dropout_seed=jnp.asarray(seed, jnp.int32), **kw, **extra)

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


def port_forward_and_grads(q, k, v, g, mask, geometry, rate=0.0, seed=0):
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = dict(port_kwargs(geometry), compute_dtype=torch.float32, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=seed)
    out = port.fused_attention_reference(*t[:4], H, **kw)
    dq, dk, dv, dw = port.fused_attention_bwd_reference(*t, H, **kw)
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


def assert_parity(got, want, geometry, masked_row=None):
    """Every result within ATOL; a batch row whose keys are all masked within
    REL_MASKED_ROW of its largest value (its scores sit at -1e4, where an
    fp32 ulp is 9.8e-4, and the products' summation order, torch.matmul's
    against XLA's dot, moves a score across that grid now and then:
    tests/test_torch_port_attention_edges.py and
    ``test_masked_row_gap_is_the_dots_summation_order`` below)."""
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:4], want[:4]):
        for i in range(B):
            bar = ATOL
            if i == masked_row:
                bar = max(ATOL, REL_MASKED_ROW * float(np.abs(b[i]).max()))
            np.testing.assert_allclose(a[i], b[i], atol=bar, rtol=0,
                                       err_msg=f"{name}, batch row {i}")
    if geometry is not None:
        # dw sums ds * s_raw over a region of the score plane: the bar
        # scales with the number of terms summed (test_torch_port_attention_bwd)
        for name, a, b in zip(("dw0", "dw1"), got[4:], want[4:]):
            np.testing.assert_allclose(a, b, atol=ATOL * L, rtol=0, err_msg=name)
    else:
        assert got[4] == 0.0 and got[5] == 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_plain_d128_matches_jax_kernel(name):
    """Forward and backward at head_dim 128, where the scale 2^-3.5 is not a
    power of two: the plain version's score (one FMA of the raw products
    without a multiplier, ``s_raw * w + bias`` after rounding s_raw with
    one) against the JAX kernel's, every result within 1e-5."""
    q, k, v, g = make_inputs()
    mask = make_mask(name)
    geometry = CASES[name]
    want = jax_forward_and_grads(q, k, v, g, mask, geometry)
    assert_parity(port_forward_and_grads(q, k, v, g, mask, geometry), want, geometry,
                  masked_row=MASKED_ROW if name == "all_keys_masked" else None)


def test_masked_row_gap_is_the_dots_summation_order():
    """At head_dim 128 too: given the JAX kernel's own q·k products (XLA's
    dot_general under jit, as the interpret-mode kernel runs it), the port's
    softmax-and-product path gives the all-masked row within 1e-5 of its
    largest value and every other row within ATOL."""
    import jax
    import jax.numpy as jnp

    q, k, v, g = make_inputs()
    mask = make_mask("all_keys_masked")
    want = jax_forward_and_grads(q, k, v, g, mask, None)[0]
    dot = jax.jit(lambda a, c: jax.lax.dot_general(
        a, c, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    qh, kh = (x.reshape(B, L, H, D).transpose(0, 2, 1, 3) for x in (q, k))
    products = torch.from_numpy(np.stack([np.stack([np.asarray(dot(qh[i, h], kh[i, h]))
                                                    for h in range(H)]) for i in range(B)]))
    bnd, w, geometry, _, _ = port._resolve(torch.from_numpy(q), None, None, None, None, 0, 0,
                                           0.0, True, None)
    _, _, p = port._softmax_scores(products, torch.from_numpy(mask), bnd, w, geometry,
                                   D ** -0.5)
    got = port._merge_heads(torch.matmul(p, port._split_heads(torch.from_numpy(v), H,
                                                              torch.float32)),
                            torch.float32).numpy()
    for i in range(B):
        bar = 1e-5 * float(np.abs(want[i]).max()) if i == MASKED_ROW else ATOL
        np.testing.assert_allclose(got[i], want[i], atol=bar, rtol=0, err_msg=f"batch row {i}")


@pytest.mark.parametrize("geometry", [None, CASES["geometry"]], ids=["plain", "geometry"])
def test_plain_d128_dropout_matches_jax_kernel(geometry):
    """Dropout 0.1: the keep mask of every (batch row, head) cell equals the
    JAX interpret-mode ``_dropout_keep`` bit for bit (its index is (head,
    row, column), whatever the width), and forward and backward hold the
    fp32 bar, which a single differing keep bit would break."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import _dropout_keep

    seed, rate = 2 ** 31 - 9, 0.1  # the cell seeds wrap past int32
    got_keep = port.dropout_keep(B, H, L, L, rate, seed, "cpu").numpy()
    for bi in range(B):
        for h in range(H):
            cell = jnp.asarray(seed, jnp.int32) + jnp.asarray(bi * H + h, jnp.int32)
            want = np.asarray(_dropout_keep((L, L), rate, cell, interpret=True))
            assert np.array_equal(got_keep[bi, h], want), (bi, h)
    q, k, v, g = make_inputs(seed=1)
    mask = make_mask("one_image_masked")
    want = jax_forward_and_grads(q, k, v, g, mask, geometry, rate=rate, seed=seed)
    assert_parity(port_forward_and_grads(q, k, v, g, mask, geometry, rate=rate, seed=seed),
                  want, geometry)


# ---------------------------------------------------------------- on the card

# (name, Lq, Lk, geometry, masked keys of batch row 0 / of batch row 1)
KERNEL_CASES = [
    ("visual_72x72", 72, 72, None, (REGIONS, L)),
    ("visual_72x72_geometry", 72, 72, dict(boundary=(30, 50), row_start=1, text_len=64),
     (REGIONS, L)),
    ("ragged_1", 72, 1, None, (0, 0)),
    ("ragged_37", 37, 37, dict(boundary=(10, 20), row_start=1), (0, 37)),
    ("ragged_130", 130, 130, None, (REGIONS, 130)),
]
KERNEL_IDS = [c[0] for c in KERNEL_CASES]


def kernel_inputs(case, dtype, device, seed=0):
    """q, k, v, g (B=2, 8 heads of 128) and the mask: batch row 0 has its
    last ``masked[0]`` keys masked, batch row 1 its last ``masked[1]``."""
    _, lq, lk, _, masked = case
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, g = (torch.randn(B, lq, H * D, generator=gen).to(device, dtype) for _ in range(2))
    k, v = (torch.randn(B, lk, H * D, generator=gen).to(device, dtype) for _ in range(2))
    mask = torch.ones(B, lk)
    for row, n in enumerate(masked):
        if n:
            mask[row, lk - n:] = 0.0
    return q, k, v, g, mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=KERNEL_IDS)
def test_d128_forward_kernels_match_plain_version(cuda, case, dtype, atol):  # noqa: F811
    """The fp32 CUDA-core and bf16 tensor-core forwards at head_dim 128
    against the plain version on the card, dropout 0.1 (the same seed, so
    the masks must agree), rows with 36 and with all keys masked; the bars
    of rows 1-2 at head_dim 64."""
    q, k, v, _, mask = kernel_inputs(case, dtype, cuda)
    kw = dict(port_kwargs(case[3], cuda), compute_dtype=dtype, dropout_rate=0.1,
              deterministic=False, dropout_seed=5)
    before = (port.LAUNCHES, port.LAUNCHES_D128)
    got = port.fused_attention(q, k, v, mask, H, **kw)
    torch.cuda.synchronize()
    assert (port.LAUNCHES, port.LAUNCHES_D128) == (before[0] + 1, before[1] + 1)
    want = port.fused_attention_reference(q, k, v, mask, H, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 2e-5), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=KERNEL_IDS)
def test_d128_backward_kernels_match_plain_version(cuda, case, dtype, rel):  # noqa: F811
    """The fp32 CUDA-core and bf16 tensor-core backwards at head_dim 128
    against the plain backward on the card, dropout 0.1: each of dq, dk, dv
    and dw within ``rel`` of its largest value."""
    q, k, v, g, mask = kernel_inputs(case, dtype, cuda, seed=1)
    geometry = case[3]
    kw = port_kwargs(geometry, cuda)
    bnd, w, geo, rate, seed = port._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
        kw.get("row_start", 0), kw.get("offset", 0), 0.1, False, 11)
    before = (port.LAUNCHES_BWD, port.LAUNCHES_BWD_D128)
    got = port._launch_bwd(q, k, v, mask, g, H, bnd, w, geo, rate, seed)
    torch.cuda.synchronize()
    assert (port.LAUNCHES_BWD, port.LAUNCHES_BWD_D128) == (before[0] + 1, before[1] + 1)
    want = port.fused_attention_bwd_reference(
        q, k, v, mask, g, H, compute_dtype=dtype, dropout_rate=0.1, deterministic=False,
        dropout_seed=11, **kw)
    for a, b_ in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b_.float(),
                                   atol=rel * b_.float().abs().max().item() + 1e-30, rtol=0)


@pytest.mark.cuda
def test_other_widths_raise(cuda):  # noqa: F811
    """Both kernel sets take head_dim 1 to 256 (the widths other than 64 and
    128 are held to their plain versions in test_torch_port_head_widths.py
    and test_torch_port_wide_heads.py): a width above 256 raises, naming the
    limit, on the single-block and on the flash route, and nothing falls
    back."""
    from mkg_analogy_tpu_torch.kernels.flash_attention import flash_attention

    q = torch.zeros(1, 8, 257 * 4, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(1, 8, device=cuda)
    for attention in (port.fused_attention, flash_attention):
        with pytest.raises(ValueError, match="head_dim 1 to 256"):
            attention(q, q, q, mask, 4)  # head_dim 257
