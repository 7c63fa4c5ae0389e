"""Port parity of the single-block attention (rows 1-2) at key counts the
CUDA-core kernels once refused: ViLT's 418 x 418 (L = 128 text tokens and
290 image tokens, geometry (row_start 1, text_len 128, offset 0)) and
99 x 1100 (above the 717 keys the bf16 route was once capped at).

The plain PyTorch forward and backward (mkg_analogy_tpu_torch/kernels/
attention.py) against the JAX kernel in interpret mode (``fused_attention``
and ``jax.vjp`` of it, which stages a head's whole K/V of any length) on
the same numpy inputs, B=1, 2 heads of 64, fp32, dropout 0 and 0.1. Then
the wrappers: neither route caps the key count any more, on the CPU; and
the CUDA kernels of both dtypes at 418, 1100 and 1024 x 1024 keys against
their plain versions (need a card)."""

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
# name -> (Lq, Lk, geometry keywords or None)
SHAPES = {
    "vilt_418": (418, 418, dict(boundary=(40,), row_start=1, text_len=128, offset=0)),
    "vision_text_1100": (99, 1100, None),
}


def make_case(lq, lk, seed=0):
    """q, k, v, the cotangent g (B=1, 2 heads of 64) and the mask: the last
    11 keys padded."""
    rng = np.random.default_rng(seed + lk)
    q, g = (rng.standard_normal((1, lq, H * D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, lk, H * D)).astype(np.float32) for _ in range(2))
    mask = np.ones((1, lk), np.float32)
    mask[:, lk - 11:] = 0.0
    return q, k, v, g, mask


def jax_results(q, k, v, g, mask, geometry, rate):
    """(out, dq, dk, dv, dw0, dw1) of the JAX kernel in interpret mode."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention

    kw = {} if geometry is None else dict(geometry, boundary=jnp.asarray(geometry["boundary"]))

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


def port_kwargs(geometry, device="cpu"):
    if geometry is None:
        return {}
    return dict(geometry, boundary=torch.tensor(geometry["boundary"], device=device),
                w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))


def port_results(q, k, v, g, mask, geometry, rate):
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = dict(port_kwargs(geometry), compute_dtype=torch.float32, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=SEED)
    out = single.fused_attention_reference(*t[:4], H, **kw)
    dq, dk, dv, dw = single.fused_attention_bwd_reference(*t, H, **kw)
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_single_block_matches_jax_at_long_keys(shape, rate):
    """Rows 1-2's plain versions at 418 and 1100 keys against the JAX
    kernel: out, dq, dk, dv within 1e-5; with the geometry, dw0 and dw1
    within 1e-5 for each of the 418 keys they sum over (the bar of
    test_torch_port_head_widths.py); the keep masks must agree bit for bit,
    or the bars break."""
    lq, lk, geometry = SHAPES[shape]
    q, k, v, g, mask = make_case(lq, lk)
    got = port_results(q, k, v, g, mask, geometry, rate)
    want = jax_results(q, k, v, g, mask, geometry, rate)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:4], want[:4]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    if geometry is None:
        assert got[4] == 0.0 and got[5] == 0.0
    else:
        for name, a, b in zip(("dw0", "dw1"), got[4:], want[4:]):
            np.testing.assert_allclose(a, b, atol=ATOL * lk, rtol=0, err_msg=name)


class _Lib:
    """A stand-in library: records the key count each launcher is given."""

    def __init__(self, smem=1024):
        self.calls = []
        self.smem = smem

    def __getattr__(self, name):
        if name.endswith("_smem"):
            return lambda *args: self.smem
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrappers_cap_no_key_count(monkeypatch, dtype):
    """Neither route's wrapper caps the key count: at 5,000 keys the bf16
    launchers (the tensor-core kernels, which stream their keys) and the
    fp32 ones (one sweep over key tiles, shared memory set by the head width
    alone) pass the call to the library as it is; the fp32 backward, called
    without the forward's residuals, has the forward kernel rebuild them
    first. The fp32 ones still hold the bytes the library reports against
    the device's limit, which they never pass on an H100."""
    class _Stream:
        cuda_stream = 0

    class _Props:
        shared_memory_per_block_optin = 232448

    lib = _Lib()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda device=None: _NullContext())
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: _Props())
    for name in ("_lib", "_lib_bwd", "_lib_mma", "_lib_bwd_mma"):
        monkeypatch.setattr(single, name, lambda width=None: lib)
    lq, lk = 99, 5000
    q = torch.zeros(1, lq, H * D, dtype=dtype)
    k = torch.zeros(1, lk, H * D, dtype=dtype)
    mask = torch.ones(1, lk)
    bnd, w, geo, rate, seed = single._resolve(q, None, None, None, None, 0, 0, 0.0, True, 0)
    single._launch_fwd(q, k, k, mask, H, bnd, w, geo, rate, seed)
    single._launch_bwd(q, k, k, mask, q, H, bnd, w, geo, rate, seed)
    names = [name for name, _ in lib.calls]
    if dtype == torch.bfloat16:
        assert names == ["mkg_fused_attention_fwd_mma", "mkg_fused_attention_bwd_mma"]
        # (b, lq, lk) follow the pointers: 7 of the forward's, 12 of the backward's
        assert lib.calls[0][1][7:10] == (1, lq, lk)
        assert lib.calls[1][1][12:15] == (1, lq, lk)
    else:
        assert names == ["mkg_fused_attention_fwd", "mkg_fused_attention_fwd",
                         "mkg_fused_attention_bwd"]
        # 8 pointers of the forward's (out and lse among them), 14 of the
        # backward's (the forward's out and lse among them)
        assert lib.calls[0][1][8:11] == lib.calls[1][1][8:11] == (1, lq, lk)
        assert lib.calls[2][1][14:17] == (1, lq, lk)
    lib.smem = 232449
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="not an H100-class card"):
            single._launch_fwd(q, k, k, mask, H, bnd, w, geo, rate, seed)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------- on the card

# name -> (B, Lq, Lk, geometry keywords or None)
KERNEL_SHAPES = {
    "vilt_418": (2, 418, 418, dict(boundary=(40, 60), row_start=1, text_len=128, offset=0)),
    "vision_text_1100": (2, 99, 1100, None),
    "square_1024": (2, 1024, 1024, None),
}


def kernel_inputs(b, lq, lk, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed + lk)
    q, g = (torch.randn(b, lq, H * D, generator=gen).to(device, dtype) for _ in range(2))
    k, v = (torch.randn(b, lk, H * D, generator=gen).to(device, dtype) for _ in range(2))
    mask = torch.ones(b, lk)
    mask[b - 1, lk - 40:] = 0.0
    return q, k, v, g, mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(KERNEL_SHAPES))
def test_single_block_kernels_take_long_keys(cuda, shape, dtype):  # noqa: F811
    """Rows 1-2 on the card at 418, 1100 and 1024 x 1024 keys, dropout 0.1:
    the forward within 2e-5 fp32 / 2e-2 bf16 of the plain version, the
    backward within 2e-5 / 2^-7 of each result's largest, each launch
    counted. The fp32 kernels sweep K and V in tiles at every length, as
    the tensor-core ones do."""
    b, lq, lk, geometry = KERNEL_SHAPES[shape]
    q, k, v, g, mask = kernel_inputs(b, lq, lk, dtype, cuda)
    kw = dict(port_kwargs(geometry, cuda), compute_dtype=dtype, dropout_rate=0.1,
              deterministic=False, dropout_seed=5)
    before = (single.LAUNCHES, single.LAUNCHES_BWD)
    got = single.fused_attention(q, k, v, mask, H, **kw)
    want = single.fused_attention_reference(q, k, v, mask, H, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    bnd, w, geo, rate, seed = single._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
        kw.get("row_start", 0), kw.get("offset", 0), 0.1, False, 5)
    grads = single._launch_bwd(q, k, v, mask, g, H, bnd, w, geo, rate, seed)
    torch.cuda.synchronize()
    assert (single.LAUNCHES, single.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    want = single.fused_attention_bwd_reference(q, k, v, mask, g, H, **kw)
    rel = 2e-5 if dtype == torch.float32 else 2 ** -7
    for a, b_ in zip(grads[:3], want[:3]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b_.float(),
                                   atol=rel * b_.float().abs().max().item() + 1e-30, rtol=0)
    # (dw: chip_smoke.py's kernel phases hold it to the sum of its terms)
