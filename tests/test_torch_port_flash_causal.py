"""The flash attention's causal mask and value width of its own (rows 3-5;
``kernels/flash_attention.py``): the plain versions against autograd of the
softmax written out, on the CPU; which library a call goes to; and, marked
``cuda``, the tensor-core kernels against the plain versions at latent
attention's widths (queries and keys of 192, values of 128), at 64 and 128
through the libraries of one padded width, and at ragged logical tiles."""

import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import flash_attention as port

# (Lq = Lk, d, d_v, block_q, block_k, geometry): one logical tile, Q and K
# tiles of their own (the last ragged), a value width below the head width
CPU_CASES = [(12, 16, 16, 256, 512, False), (13, 24, 16, 256, 512, True),
             (29, 16, 8, 8, 6, True), (20, 12, 12, 6, 8, False)]


def _inputs(b, n, heads, d, dv, dtype=torch.float64, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, n, heads * d, generator=g, dtype=torch.float64) for _ in range(2))
    v, go = (torch.randn(b, n, heads * dv, generator=g, dtype=torch.float64) for _ in range(2))
    mask = torch.ones(b, n, dtype=torch.float64)
    mask[:, n - 3:] = 0.0
    q, k, v, go = (x.to(device, dtype) for x in (q, k, v, go))
    return q, k, v, go, mask.to(device)


def _geometry(n, device="cpu"):
    return dict(boundary=torch.tensor([n // 3, n // 2], device=device), row_start=1,
                w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))


def written_out(q, k, v, mask, heads, causal, boundary=None, w0=None, w1=None, row_start=0):
    """softmax(d^-1/2 Q Kᵀ · multiplier + (1 - mask) · -1e4, keys after the
    row left out) V, head by head, in q's dtype."""
    b, n, hd = q.shape
    d = hd // heads
    qh, kh = (x.reshape(b, n, heads, d).transpose(1, 2) for x in (q, k))
    vh = v.reshape(b, n, heads, -1).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) * d ** -0.5
    if boundary is not None:
        rows = torch.arange(n)[:, None]
        cols = torch.arange(n)[None, :]
        bnd = boundary.long()[:, None, None]
        answer = cols >= bnd
        example = (rows >= row_start) & (rows < bnd)
        in_scope = example | (rows >= bnd)
        mult = torch.where(answer & in_scope & example, w0.clamp(0, 0.5),
                           torch.where(answer & in_scope, w1.clamp(0.5, 1.0),
                                       torch.ones((), dtype=q.dtype)))
        s = s * mult[:, None]
    s = s + ((1.0 - mask) * -1e4)[:, None, None, :]
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), float("-inf"))
    return (torch.softmax(s, dim=-1) @ vh).transpose(1, 2).reshape(b, n, -1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CPU_CASES)
def test_plain_versions_match_the_softmax_written_out(case, causal):
    """Forward and backward of the plain versions (fp64) against autograd of
    the written-out softmax, with a value width below the head width in two
    cases, over one logical tile and over ragged ones."""
    n, d, dv, bq, bk, geometry = case
    heads = 2
    q, k, v, go, mask = _inputs(2, n, heads, d, dv)
    kw = _geometry(n) if geometry else {}
    out = port.flash_attention_reference(q, k, v, mask, heads, causal=causal,
                                         compute_dtype=torch.float64, block_q=bq,
                                         block_k=bk, **kw)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = written_out(*leaves, mask, heads, causal, **kw)
    torch.testing.assert_close(out, want.detach(), atol=1e-12, rtol=0)
    want.backward(go)
    dq, dk, dvv, _ = port.flash_attention_bwd_reference(
        q, k, v, mask, go, heads, causal=causal, compute_dtype=torch.float64, block_q=bq,
        block_k=bk, **kw)
    for got, leaf in zip((dq, dk, dvv), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-11, rtol=0)


def test_causal_rows_ignore_later_keys_through_autograd():
    """flash_attention on the CPU, causal, value width 8 under 16: a row's
    output is the same whatever the keys and values after it, and the
    gradient of earlier rows' outputs reaches no later key or value."""
    n, heads = 21, 2
    q, k, v, _, mask = _inputs(1, n, heads, 16, 8, dtype=torch.float32)
    mask.fill_(1.0)
    k2, v2 = k.clone(), v.clone()
    k2[:, 11:] += 1.0
    v2[:, 11:] -= 2.0
    a = port.flash_attention(q, k, v, mask, heads, causal=True, compute_dtype=torch.float32)
    b = port.flash_attention(q, k2, v2, mask, heads, causal=True, compute_dtype=torch.float32)
    assert a.shape == (1, n, heads * 8)
    assert torch.equal(a[:, :11], b[:, :11]) and not torch.equal(a[:, 11:], b[:, 11:])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    port.flash_attention(*leaves, mask, heads, causal=True,
                         compute_dtype=torch.float32)[:, :11].sum().backward()
    assert leaves[1].grad[:, 11:].abs().max() == 0 and leaves[2].grad[:, 11:].abs().max() == 0
    assert leaves[1].grad[:, :11].abs().max() > 0


def test_causal_needs_equal_lengths():
    q, k, v, _, mask = _inputs(1, 6, 2, 8, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="Lq = Lk"):
        port.flash_attention(q[:, :5], k, v, mask, 2, causal=True,
                             compute_dtype=torch.float32)


@pytest.mark.parametrize("d,dv,causal,want", [
    (64, 64, False, None), (128, 128, False, None), (64, 64, True, 64),
    (128, 64, False, 128), (192, 128, True, 192), (192, 192, False, 192), (40, 40, True, 48)])
def test_library_of_a_call(d, dv, causal, want):
    """A causal call, or one whose v is narrower, goes to the library of its
    padded width, the instances of 64 and 128 included; the tensor-core
    launchers end with (causal, d_v); the CUDA-core ones take neither."""
    q, v = torch.zeros(1, 4, 2 * d), torch.zeros(1, 4, 2 * dv)
    assert port._shape_args(True, q, v, 2, causal) == (want, (int(causal), dv))
    if causal or dv != d:
        with pytest.raises(ValueError, match="bf16"):
            port._shape_args(False, q, v, 2, causal)
    else:
        assert port._shape_args(False, q, v, 2, causal) == (want, ())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, heads, L, d, d_v, block_q, block_k, geometry, causal): latent
# attention's call (one logical tile of 228 keys, streamed), causal at 64
# and 128 through the libraries of one padded width, ragged logical tiles,
# a narrower value at 64 and at 40, and non-causal narrow values
CARD_CASES = [(2, 4, 228, 192, 128, 256, 512, True, True),
              (2, 4, 228, 192, 128, 256, 512, True, False),
              (2, 3, 130, 64, 64, 48, 72, True, True),
              (2, 3, 100, 128, 128, 256, 512, False, True),
              (2, 3, 200, 128, 64, 256, 96, True, True),
              (2, 3, 96, 64, 32, 256, 512, False, False),
              (2, 2, 150, 40, 24, 256, 512, True, True)]


@pytest.mark.cuda
def test_value_width_is_checked(cuda):
    q, k, v, _, mask = _inputs(1, 6, 2, 8, 4, dtype=torch.bfloat16, device=cuda)
    wide = torch.zeros(1, 6, 2 * 9, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="do not match"):
        single._check_inputs(q, k, wide, mask.float(), 2, torch.bfloat16, value_width=True)
    single._check_inputs(q, k, v, mask.float(), 2, torch.bfloat16, value_width=True)
    with pytest.raises(ValueError, match="do not match"):
        single._check_inputs(q, k, v, mask.float(), 2, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_versions(cuda, case):
    """The bf16 forward, dK/dV and dQ kernels against the plain versions
    with dropout on, as test_torch_port_flash.py holds the other calls:
    outputs within 2e-2 (a bf16 ulp of values ~1), lse within 1e-5, the
    gradients within 2^-7 of each one's largest value."""
    b, heads, n, d, dv, bq, bk, geometry, causal = case
    q, k, v, go, mask = _inputs(b, n, heads, d, dv, dtype=torch.bfloat16, device=cuda)
    mask = mask.float()
    kw = _geometry(n, cuda) if geometry else {}
    bnd, w, geo, rate, seed = single._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), None, kw.get("row_start", 0), 0,
        0.1, False, 7)
    out, lse = port._launch_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed, bq, bk, None,
                                causal)
    got = port._launch_bwd(q, k, v, mask, go, lse, port._delta(go, out, heads), heads, bnd, w,
                           geo, rate, seed, bq, bk, None, causal)
    torch.cuda.synchronize()
    want_out, want_lse = port._plain_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed,
                                         torch.bfloat16, bq, bk, None, causal)
    assert out.shape == (b, n, heads * dv)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    want = port._plain_bwd(q, k, v, mask, go, lse, port._delta(go, out, heads), heads, bnd,
                           w, geo, rate, seed, torch.bfloat16, bq, bk, None, causal)
    for a, b_ in zip(got, want):
        size = b_.float().abs().max().item()
        torch.testing.assert_close(a.float(), b_.float(), atol=2 ** -7 * size, rtol=0)
