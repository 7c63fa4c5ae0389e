"""The attention kernels' dropout keyed by the global batch row and head.

A rank of a data- or tensor-parallel mesh holds a slice of the batch rows
and of the heads. It passes ``cell_stride`` (the global head count) and
``cell_offset`` (the global cell of its first row and head, folded into
the seed on the host), and its masks must be the matching slice of the
masks of the whole call, as JAX's are whatever the mesh. On the CPU the
plain versions (masks, forward and backward of both kernel sets); on the
card, each of the eight attention kernel sources (rows 1-5: single-block
and flash, forward and backward, bf16 on the tensor cores and fp32 on the
CUDA cores) against its own launch on the whole call, bit for bit, and
against the plain version."""

import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import flash_attention as flash
from test_torch_port_attention import cuda  # noqa: F401

torch.set_num_threads(1)

B, H, D, L = 4, 6, 8, 20
ROWS, HEADS = slice(1, 3), slice(2, 5)  # a rank's batch rows and heads
OFFSET = ROWS.start * H + HEADS.start   # the global cell of its (0, 0)


def _inputs(device="cpu", dtype=torch.float32, b=B, heads=H, d=D, length=L, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, go = (torch.randn(b, length, heads * d, generator=g).to(device, dtype)
                   for _ in range(4))
    mask = torch.ones(b, length)
    mask[:, length - 3:] = 0.0
    kw = dict(boundary=torch.arange(b, device=device) + length // 3,
              w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))
    return q, k, v, go, mask.to(device), kw


def _part(x, d=D, rows=ROWS, heads=HEADS):
    """A rank's slice of packed (B, L, heads·d) rows."""
    return x[rows, :, heads.start * d:heads.stop * d].contiguous()


def test_single_block_masks_are_slices_of_the_whole_call():
    whole = single.dropout_keep(B, H, 7, 9, 0.4, 123, "cpu")
    part = single.dropout_keep(2, 3, 7, 9, 0.4, 123 + OFFSET, "cpu", stride=H)
    assert torch.equal(part, whole[ROWS, HEADS])
    # stride = the call's own heads and offset 0 are the call's own cells
    own = single.dropout_keep(B, H, 7, 9, 0.4, 123, "cpu", stride=H)
    assert torch.equal(own, whole)


def test_flash_masks_are_slices_of_the_whole_call():
    for qb, kb in ((0, 0), (1, 2)):
        whole = flash._dropout_keep(B, H, 5, 6, 0.4, 77, qb, kb, 2, 3, "cpu")
        # the offset folded into the seed, times the 2 x 3 tiles of a cell
        part = flash._dropout_keep(2, 3, 5, 6, 0.4, 77 + OFFSET * 6, qb, kb, 2, 3, "cpu",
                                   stride=H)
        assert torch.equal(part, whole[ROWS, HEADS])


@pytest.mark.parametrize("route", ["single", "flash"])
def test_plain_versions_on_a_slice_equal_the_slice_of_the_whole(route):
    """Forward and backward of the plain versions, dropout 0.4, the analogy
    geometry on: the slice's call with its cells gives the whole call's
    values on that slice, bit for bit (rows and heads are independent); with
    cell_stride = heads and cell_offset 0 a call is the call without them."""
    q, k, v, go, mask, kw = _inputs()
    kw.update(dropout_rate=0.4, deterministic=False, dropout_seed=9,
              compute_dtype=torch.float32)
    if route == "flash":
        fwd, bwd = flash.flash_attention_reference, flash.flash_attention_bwd_reference
        kw.update(block_q=8, block_k=8)
    else:
        fwd, bwd = single.fused_attention_reference, single.fused_attention_bwd_reference
    whole = fwd(q, k, v, mask, H, **kw)
    assert torch.equal(fwd(q, k, v, mask, H, cell_stride=H, cell_offset=0, **kw), whole)
    pkw = dict(kw, boundary=kw["boundary"][ROWS])
    part = fwd(_part(q), _part(k), _part(v), mask[ROWS], 3, cell_stride=H, cell_offset=OFFSET,
               **pkw)
    assert torch.equal(part, _part(whole))
    # without the cells the slice keys its own rows and heads: other masks
    assert not torch.equal(fwd(_part(q), _part(k), _part(v), mask[ROWS], 3, **pkw),
                           _part(whole))
    grads = bwd(q, k, v, mask, go, H, **kw)
    part_grads = bwd(_part(q), _part(k), _part(v), mask[ROWS], _part(go), 3,
                     cell_stride=H, cell_offset=OFFSET, **pkw)
    for name, a, b in zip(("dq", "dk", "dv"), part_grads[:3], grads[:3]):
        assert torch.equal(a, _part(b)), name


def test_autograd_function_carries_the_cells_to_its_backward():
    """fused_attention on the CPU: the gradient of a slice's call with its
    cells is the slice of the whole call's gradient."""
    q, k, v, go, mask, kw = _inputs()
    kw.update(dropout_rate=0.4, deterministic=False, dropout_seed=3,
              compute_dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (single.fused_attention(*leaves, mask, H, **kw) * go).sum().backward()
    parts = [_part(t).requires_grad_(True) for t in (q, k, v)]
    pkw = dict(kw, boundary=kw["boundary"][ROWS])
    (single.fused_attention(*parts, mask[ROWS], 3, cell_stride=H, cell_offset=OFFSET, **pkw)
     * _part(go)).sum().backward()
    for whole, part in zip(leaves, parts):
        assert torch.equal(part.grad, _part(whole.grad))


# the eight attention kernel sources of rows 1-5: the route, the dtype that
# picks the kernel, the pass
KERNELS = [(route, dtype, pass_) for route in ("single", "flash")
           for dtype in (torch.bfloat16, torch.float32) for pass_ in ("fwd", "bwd")]


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,pass_", KERNELS)
def test_kernel_keys_dropout_by_the_global_cell(cuda, route, dtype, pass_):  # noqa: F811
    """Each kernel on a rank's slice (rows 1:3, heads 2:5 of 4 x 6 heads of
    64, the analogy geometry, dropout 0.3) with its cells, against the same
    kernel on the whole call: the slice of out (and lse), dq, dk and dv,
    bit for bit; and against the plain version on the slice, at the bars of
    tests/test_torch_port_attention.py and test_torch_port_flash.py."""
    d, length = 64, 96
    q, k, v, go, mask, kw = _inputs(cuda, dtype, d=d, length=length)
    pkw = dict(kw, boundary=kw["boundary"][ROWS])

    bq, bk = 32, 64
    tiles = 1 if route == "single" else flash._tile_count(q, k, bq, bk)

    def resolve(x, k_, cell_offset=0):
        return single._resolve(x, k_["boundary"], k_["w0"], k_["w1"], None, 0, 0, 0.3,
                               False, 11, cell_offset, tiles)

    bnd, w, geo, rate, seed = resolve(q, kw)
    # the slice's seed has its first cell folded in; its stride is H
    pbnd, _, _, _, pseed = resolve(_part(q, d), pkw, OFFSET)
    pq, pk, pv, pg = (_part(t, d) for t in (q, k, v, go))
    pmask = mask[ROWS]
    part_args = (3, pbnd, w, geo, rate, pseed)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    if route == "single":
        if pass_ == "fwd":
            got = single._launch_fwd(pq, pk, pv, pmask, *part_args, H)
            whole = single._launch_fwd(q, k, v, mask, H, bnd, w, geo, rate, seed)
            torch.cuda.synchronize()
            assert torch.equal(got, _part(whole, d))
            want = single._plain_fwd(pq, pk, pv, pmask, *part_args, dtype, stride=H)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
            return
        got = single._launch_bwd(pq, pk, pv, pmask, pg, *part_args, H)
        whole = single._launch_bwd(q, k, v, mask, go, H, bnd, w, geo, rate, seed)
        want = single._plain_bwd(pq, pk, pv, pmask, pg, *part_args, dtype, H)
    else:
        got_out, got_lse = flash._launch_fwd(pq, pk, pv, pmask, *part_args, bq, bk, H)
        out, lse = flash._launch_fwd(q, k, v, mask, H, bnd, w, geo, rate, seed, bq, bk)
        torch.cuda.synchronize()
        assert torch.equal(got_out, _part(out, d))
        assert torch.equal(got_lse, lse[ROWS, HEADS])
        if pass_ == "fwd":
            want, _ = flash._plain_fwd(pq, pk, pv, pmask, *part_args, dtype, bq, bk, H)
            torch.testing.assert_close(got_out.float(), want.float(), atol=atol, rtol=0)
            return
        pdelta = flash._delta(pg, got_out, 3)
        got = flash._launch_bwd(pq, pk, pv, pmask, pg, got_lse, pdelta, *part_args, bq, bk, H)
        whole = flash._launch_bwd(q, k, v, mask, go, lse, flash._delta(go, out, H), H, bnd,
                                  w, geo, rate, seed, bq, bk)
        want = flash._plain_bwd(pq, pk, pv, pmask, pg, got_lse, pdelta, *part_args, dtype,
                                bq, bk, H)
    torch.cuda.synchronize()
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, b, p in zip(("dq", "dk", "dv"), got[:3], whole[:3], want[:3]):
        assert torch.equal(a, _part(b, d)), name
        size = p.float().abs().max().item()
        torch.testing.assert_close(a.float(), p.float(), atol=rel * size, rtol=0)
