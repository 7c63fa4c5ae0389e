"""Port parity of the flash (K-blocked) attention at its ragged edges.

On the card the bf16 tensor-core backward (csrc/flash_attention_bwd_mma.cu)
walks 64-row chunks across JAX's logical (256, 512) tiles, and is held to the
plain PyTorch versions (``flash_attention_reference``,
``flash_attention_bwd_reference``) at ``FLASH_EDGE_CASES``: Lq and Lk of 1,
255, 257, 511, 513 and 611, a batch row whose keys are all masked,
``row_start`` 1, the +290 offset, and chunks that straddle logical tiles of
96 x 160 (tests/test_torch_port_flash.py::test_flash_kernels_match_plain_
versions and chip_smoke.py). So here, on the CPU, the plain versions are
held to the JAX Pallas flash kernels in interpret mode at those same cases
(2 heads of 64, fp32): forward and backward, dropout 0 and 0.1 (the masks
keyed to the logical tiles, bit for bit, or an output would move by a whole
probability)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import flash_attention as port
from test_torch_port_attention_edges import REL_MASKED_ROW, assert_close_by_batch_row

torch.set_num_threads(1)

H, D = 2, 64
# the bars of tests/test_torch_port_flash.py (the JAX flash kernels' bars
# against their einsum oracle)
ATOL, GRAD_ATOL = 1e-5, 2e-5
# (name, B, Lq, Lk, geometry or None, batch row whose keys are all masked or
# None, (block_q, block_k)); every row also pads its last Lk // 8 keys
FLASH_EDGE_CASES = [
    ("1x1", 1, 1, 1, None, None, (256, 512)),
    ("255x257_masked_row", 2, 255, 257, None, 1, (256, 512)),
    ("257x255_rows_from_1", 2, 257, 255, dict(boundary=(100, 200), row_start=1), 0,
     (256, 512)),
    ("511x513", 2, 511, 513, None, 0, (256, 512)),
    ("513x511_offset_290", 2, 513, 511, dict(boundary=(1, 128), row_start=1, offset=290), 1,
     (256, 512)),
    ("611x1", 2, 611, 1, None, None, (256, 512)),
    ("1x611", 2, 1, 611, dict(boundary=(0, 300), row_start=0, text_len=611), 0, (256, 512)),
    ("393x393_tiles_96x160", 2, 393, 393, dict(boundary=(60, 100), row_start=1), 1,
     (96, 160)),
]
FLASH_EDGE_IDS = [c[0] for c in FLASH_EDGE_CASES]


def flash_edge_inputs(case, heads=H, head_dim=D):
    """numpy (q, k, v, g, mask) of a flash edge case from a fixed seed."""
    name, b, lq, lk, _, masked_row, _ = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, g = (rng.standard_normal((b, n, heads * head_dim)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    mask = np.ones((b, lk), np.float32)
    mask[:, lk - lk // 8:] = 0.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    return q, k, v, g, mask


def flash_edge_kwargs(case, lib, device="cpu"):
    """The case's geometry and blocks as keyword arguments of the JAX (``lib``
    = jnp) or the port's (``lib`` = torch) flash_attention."""
    geometry, (block_q, block_k) = case[4], case[6]
    kw = dict(block_q=block_q, block_k=block_k)
    if geometry is not None:
        kw.update(geometry)
        if lib is torch:
            kw.update(boundary=torch.tensor(geometry["boundary"], device=device),
                      w0=torch.tensor([0.3], device=device),
                      w1=torch.tensor([0.7], device=device))
        else:
            kw.update(boundary=lib.asarray(geometry["boundary"]))
    return kw


def jax_flash(case, q, k, v, mask, g, rate, seed):
    """(out, dq, dk, dv, dw0, dw1) of the JAX flash kernels in interpret
    mode, fp32; dw0/dw1 None without a geometry."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.flash_attention import flash_attention as jax_fa

    kw = flash_edge_kwargs(case, jnp)
    geometry = case[4] is not None

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry else {}
        return jax_fa(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32,
                      interpret=True, dropout_rate=rate, deterministic=rate == 0.0,
                      dropout_seed=jnp.asarray(seed, jnp.int32), **kw, **extra)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray([0.3]), jnp.asarray([0.7]))
    grads = vjp(jnp.asarray(g))
    dw = [float(grads[3][0]), float(grads[4][0])] if geometry else [None, None]
    return [np.asarray(x) for x in (out, *grads[:3])] + dw


def one_key_size(q, k, v, g, heads=H, head_dim=D):
    """With one key (Lk = 1) p is 1 and every dS = dP - delta cancels to fp32
    rounding noise on both sides (delta = rowsum(g * out) is summed outside
    the kernels, as JAX does, dP inside): the size dq and dk would have
    without the cancellation, scale * max|dP| * max(|q|, |k|), the scale
    their noise is held to."""
    dp = (g.reshape(*g.shape[:2], heads, head_dim)
          * v.reshape(*v.shape[:2], heads, head_dim)).sum(-1)
    return head_dim ** -0.5 * float(np.abs(dp).max()) * max(float(np.abs(q).max()),
                                                             float(np.abs(k).max()))


def port_kwargs(case, rate, seed):
    return dict(flash_edge_kwargs(case, torch), compute_dtype=torch.float32,
                dropout_rate=rate, deterministic=rate == 0.0, dropout_seed=seed)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=FLASH_EDGE_IDS)
def test_plain_flash_forward_matches_jax_at_the_edges(case, rate):
    """flash_attention_reference against the Pallas forward: every batch row
    within ATOL, the all-masked one within REL_MASKED_ROW of its largest
    value (tests/test_torch_port_attention_edges.py says why)."""
    q, k, v, _, mask = flash_edge_inputs(case)
    want = jax_flash(case, q, k, v, mask, np.zeros_like(q), rate, seed=31)[0]
    got = port.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, mask)), H, **port_kwargs(case, rate, 31))
    assert np.isfinite(want).all()
    assert_close_by_batch_row(got.numpy(), want, case, ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=FLASH_EDGE_IDS)
def test_plain_flash_backward_matches_jax_at_the_edges(case, rate):
    """flash_attention_bwd_reference against jax.vjp of the interpret-mode
    kernels (the Pallas _flash_bwd_kv_kernel and _flash_bwd_q_kernel): dq,
    dk and dv within GRAD_ATOL of the result's largest |value| where that
    exceeds 1 (with one key, dv sums the cotangent over up to 611 rows and
    reaches ~50) and within GRAD_ATOL otherwise (with one key dq and dk of
    one_key_size), the all-masked row within REL_MASKED_ROW of its largest
    value; dw0/dw1 within GRAD_ATOL times Lq
    (sums over up to Lq x Lk terms in another order), zero without a
    geometry."""
    q, k, v, g, mask = flash_edge_inputs(case)
    want = jax_flash(case, q, k, v, mask, g, rate, seed=37)
    got = port.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, mask, g)), H, **port_kwargs(case, rate, 37))
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[1:4]):
        size = max(1.0, float(np.abs(b).max()))
        if case[3] == 1 and name != "dv":
            size = max(size, one_key_size(q, k, v, g))
        atol = GRAD_ATOL * size
        assert_close_by_batch_row(a.numpy(), b, case, atol, name)
    if case[4] is None:
        assert not got[3].any()
    else:
        for i, name in enumerate(("dw0", "dw1")):
            np.testing.assert_allclose(float(got[3][i]), want[4 + i],
                                       atol=GRAD_ATOL * case[2], err_msg=name)


def test_edge_cases_cross_the_logical_tiles():
    """The cases reach what the tensor-core backward's 64-row chunks must
    get right: a ragged last Q tile (257, 513, 611 rows: one row, and 99
    rows past 512), a second K tile of one key (513) and a ragged one (611),
    one key (Lk = 1: p = 1, dS cancels), and 64-row chunks that straddle
    logical tiles (96 x 160 at 393, neither divides 64)."""
    tiles = {c[0]: port._blocks(c[2], c[3], *c[6]) for c in FLASH_EDGE_CASES}
    assert tiles["257x255_rows_from_1"] == (256, 255, 2, 1)
    assert tiles["511x513"] == (256, 512, 2, 2)
    assert tiles["611x1"] == (256, 1, 3, 1)
    assert tiles["1x611"] == (1, 512, 1, 2)
    bq, bk, n_qblk, n_kblk = tiles["393x393_tiles_96x160"]
    assert (n_qblk, n_kblk) == (5, 3) and 64 % bq and bq % 64 and bk % 64
    assert any(c[5] is not None for c in FLASH_EDGE_CASES)
    assert REL_MASKED_ROW == 2e-3
