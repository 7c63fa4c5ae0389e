"""Port parity for the fused-attention backward: the plain PyTorch backward
(mkg_analogy_tpu_torch/kernels/attention.py:fused_attention_bwd_reference)
against ``jax.vjp`` of the JAX kernel in interpret mode, which runs the
Pallas ``_bwd_kernel``, on the same numpy inputs and cotangent, across the
mask geometries, cross-length K/V, dropout and bf16; the CPU
``autograd.Function`` against the plain backward and under
``torch.autograd.gradcheck``; and the CUDA kernel against the plain backward
(needs a card)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as port
from test_torch_port_attention import (  # noqa: F401
    CASES, EDGE_CASES, EDGE_IDS, H, MAIN_SHAPES, cuda, edge_inputs, edge_kwargs, make_inputs)

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

# fp32 gradient bar of the JAX kernel against autodiff of its einsum oracle
# (tests/test_fused_attention.py:99): the same fp32 math, summed in another
# order.
ATOL = 2e-5


def make_cotangent(b=2, lq=12, seed=9):
    return np.random.default_rng(seed).standard_normal((b, lq, H * 8)).astype(np.float32)


def geometry_kwargs(case, lib):
    """The case's keyword arguments for the JAX (``lib`` = jnp) or the
    port's (``lib`` = torch) call, w0/w1 excluded."""
    kw = dict(case)
    if "boundary" in case:
        kw["boundary"] = (lib.asarray(case["boundary"]) if lib is not torch
                          else torch.tensor(case["boundary"]))
    return kw


def jax_grads(q, k, v, mask, g, case, rate=0.0, seed=0, dtype=None):
    """(dq, dk, dv, dw0, dw1) of the JAX kernel in interpret mode by
    ``jax.vjp`` (dw0/dw1 None without a geometry)."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused

    dtype = dtype or jnp.float32
    kw = geometry_kwargs(case, jnp)
    geometry = "boundary" in case

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry else {}
        return jax_fused(q, k, v, jnp.asarray(mask), H, compute_dtype=dtype,
                         interpret=True, dropout_rate=rate,
                         deterministic=rate == 0.0,
                         dropout_seed=jnp.asarray(seed, jnp.int32), **kw, **extra)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    args += [jnp.asarray([0.3]), jnp.asarray([0.7])]
    _, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g, dtype))
    out = [np.asarray(x, np.float32) for x in grads[:3]]
    if geometry:
        out += [float(grads[3][0]), float(grads[4][0])]
    else:
        out += [None, None]
    return out


def port_grads(q, k, v, mask, g, case, rate=0.0, seed=0, dtype=torch.float32):
    kw = geometry_kwargs(case, torch)
    if "boundary" in case:
        kw.update(w0=torch.tensor([0.3]), w1=torch.tensor([0.7]))
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return port.fused_attention_bwd_reference(
        *t, torch.from_numpy(mask), torch.from_numpy(g).to(dtype), H,
        compute_dtype=dtype, dropout_rate=rate, deterministic=rate == 0.0,
        dropout_seed=seed, **kw)


def assert_grads_close(got, want, atol, case):
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, err_msg=name)
    if "boundary" in case:
        # dw sums ds * s_raw over a region of the score plane: the bar
        # scales with the number of terms summed
        for i, name in enumerate(("dw0", "dw1")):
            np.testing.assert_allclose(float(got[3][i]), want[3 + i],
                                       atol=atol * got[0].shape[1], err_msg=name)
    else:
        assert not got[3].any()


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_jax_kernel(case):
    q, k, v, mask = make_inputs()
    g = make_cotangent()
    want = jax_grads(q, k, v, mask, g, case)
    assert_grads_close(port_grads(q, k, v, mask, g, case), want, ATOL, case)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]])
def test_plain_bwd_cross_length_kv(case):
    """Lq != Lk: the vision tower attending [text K/V ; vision]."""
    q, _, _, _ = make_inputs(lq=9, lk=9)
    _, k, v, mask = make_inputs(lq=20, lk=20, seed=5)
    g = make_cotangent(lq=9)
    if "boundary" in case:
        case = dict(case, text_len=9)
    want = jax_grads(q, k, v, mask, g, case)
    assert_grads_close(port_grads(q, k, v, mask, g, case), want, ATOL, case)


@pytest.mark.parametrize("seed", [3, 2 ** 31 - 5])
def test_plain_bwd_dropout_matches_jax_kernel(seed):
    """The backward regenerates the forward's keep mask from the seed: the
    same hash on both sides, so the bar stays the fp32 one; the second seed
    wraps the per-cell seed past int32."""
    q, k, v, mask = make_inputs(seed=1)
    g = make_cotangent(seed=4)
    want = jax_grads(q, k, v, mask, g, CASES[1], rate=0.1, seed=seed)
    got = port_grads(q, k, v, mask, g, CASES[1], rate=0.1, seed=seed)
    assert_grads_close(got, want, ATOL, CASES[1])
    # and the mask is not trivial: without dropout the gradients differ
    plain = port_grads(q, k, v, mask, g, CASES[1])
    assert (got[0] - plain[0]).abs().max() > 1e-3


def test_plain_bwd_bf16_matches_jax_kernel():
    """bf16 inputs, cotangent and compute dtype, with the kernel's cast
    points: the probabilities and ds_raw are rounded to bf16 before the
    products. The two sides round values that differ in the last fp32 bits
    (exp and sums differ), so a rounded term can land one bf16 ulp apart,
    and each result is rounded to bf16: the bar is 2 bf16 ulps (2^-7) of
    the largest gradient of each tensor."""
    import jax.numpy as jnp

    q, k, v, mask = make_inputs(seed=2)
    g = make_cotangent(seed=6)
    want = jax_grads(q, k, v, mask, g, CASES[1], dtype=jnp.bfloat16)
    got = port_grads(q, k, v, mask, g, CASES[1], dtype=torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b,
                                   atol=2 ** -7 * np.abs(b).max(), err_msg=name)
    for i, name in enumerate(("dw0", "dw1")):
        np.testing.assert_allclose(float(got[3][i]), want[3 + i],
                                   atol=2 ** -7 * max(abs(want[3]), abs(want[4])),
                                   err_msg=name)


def _autograd(fn, q, k, v, g, w0, w1):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, w0, w1)]
    out = fn(*leaves)
    out.backward(g)
    return [x.grad for x in leaves]


def test_function_on_cpu_takes_plain_backward():
    """On CPU tensors the autograd.Function runs the plain forward and the
    plain backward, and launches nothing; the gradient of (w0, w1) flows
    through the stack of the two scalars."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(seed=3))
    g = torch.from_numpy(make_cotangent(seed=8))
    w0, w1 = torch.tensor([0.3]), torch.tensor([0.7])
    kw = dict(boundary=torch.tensor([5, 7]), row_start=0, compute_dtype=torch.float32,
              dropout_rate=0.1, deterministic=False, dropout_seed=17)
    before = (port.LAUNCHES, port.LAUNCHES_BWD)
    got = _autograd(lambda q, k, v, a, b: port.fused_attention(
        q, k, v, mask, H, w0=a, w1=b, **kw), q, k, v, g, w0, w1)
    assert (port.LAUNCHES, port.LAUNCHES_BWD) == before
    want = port.fused_attention_bwd_reference(q, k, v, mask, g, H, w0=w0, w1=w1, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat([got[3], got[4]]), want[3])


def test_plain_bwd_matches_autograd_of_plain_forward():
    """The formula of _bwd_kernel is the derivative of the forward: autograd
    through the plain forward (the ``--fused_attention 0`` path) gives the
    same gradients in fp32, within the fp32 bar, dropout on."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(seed=4))
    g = torch.from_numpy(make_cotangent(seed=10))
    w0, w1 = torch.tensor([0.3]), torch.tensor([0.7])
    kw = dict(boundary=torch.tensor([5, 7]), row_start=1, compute_dtype=torch.float32,
              dropout_rate=0.2, deterministic=False, dropout_seed=5)
    want = _autograd(lambda q, k, v, a, b: port.fused_attention_reference(
        q, k, v, mask, H, w0=a, w1=b, **kw), q, k, v, g, w0, w1)
    got = port.fused_attention_bwd_reference(q, k, v, mask, g, H, w0=w0, w1=w1, **kw)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    torch.testing.assert_close(got[3], torch.cat(want[3:]), atol=ATOL * 12, rtol=0)


def test_gradcheck_float64_with_dropout():
    """torch.autograd.gradcheck of the Function in float64 (finite
    differences of the plain forward against the plain backward), with the
    analogy geometry and dropout on: the same seed redraws the same mask, so
    the function is deterministic."""
    rng = np.random.default_rng(12)
    b, lq, lk = 2, 6, 7
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, H * 4)))
               .requires_grad_(True) for n in (lq, lk, lk))
    mask = torch.ones(b, lk, dtype=torch.float64)
    mask[:, -1] = 0.0
    w0 = torch.tensor([0.3], dtype=torch.float64, requires_grad=True)
    w1 = torch.tensor([0.7], dtype=torch.float64, requires_grad=True)

    def f(q, k, v, w0, w1):
        return port.fused_attention(
            q, k, v, mask, H, boundary=torch.tensor([2, 4]), w0=w0, w1=w1,
            row_start=0, dropout_rate=0.25, deterministic=False, dropout_seed=3,
            compute_dtype=torch.float64)

    assert torch.autograd.gradcheck(f, (q, k, v, w0, w1), eps=1e-6, atol=1e-7)


def test_bwd_launch_without_nvcc_raises(monkeypatch, tmp_path):
    """The backward kernel that cannot be built raises; nothing falls back
    to the plain backward."""
    from mkg_analogy_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("fused_attention_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,geometry", MAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain_version(cuda, lq, lk, geometry, dtype):  # noqa: F811
    """The CUDA backward against the plain backward on the card at the
    main-path shapes (B=4, 12 heads of 64), dropout on (the same seed, so
    the masks must agree). fp32: the same math summed in another order
    (1e-5 of each tensor's largest value); bf16: a term rounded to bf16 at a
    cast point may land one ulp apart and the results are bf16, so 2 bf16
    ulps (2^-7) of the largest value."""
    g_cpu = torch.Generator(device="cpu").manual_seed(1)
    b, hd = 4, 12 * 64
    q, k, v = (torch.randn(b, n, hd, generator=g_cpu).to(cuda, dtype)
               for n in (lq, lk, lk))
    g = torch.randn(b, lq, hd, generator=g_cpu).to(cuda, dtype)
    mask = torch.ones(b, lk)
    mask[:, lk - 7:] = 0.0
    mask = mask.to(cuda)
    kw = dict(compute_dtype=dtype, dropout_rate=0.1, deterministic=False,
              dropout_seed=11)
    if geometry:
        kw.update(boundary=torch.tensor([40, 60, 80, 100], device=cuda),
                  w0=torch.tensor([0.3], device=cuda),
                  w1=torch.tensor([0.7], device=cuda))
    bnd, w, geo, rate, seed = port._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), None, 0, 0, 0.1, False, 11)
    before = port.LAUNCHES_BWD
    got = port._launch_bwd(q, k, v, mask, g, 12, bnd, w, geo, rate, seed)
    torch.cuda.synchronize()
    assert port.LAUNCHES_BWD == before + 1
    want = port.fused_attention_bwd_reference(q, k, v, mask, g, 12, **kw)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.float(), b_.float(),
                                   atol=rel * b_.float().abs().max().item() + 1e-30,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_tensor_core_bwd_at_the_ragged_edges(cuda, case, rate):  # noqa: F811
    """The bf16 tensor-core backward against the plain backward on the card
    (12 heads of 64) at the ragged edges of its tiles and chunks: dq, dk and
    dv within 2 bf16 ulps (2^-7) of each tensor's largest value, dw within
    2^-7 of the larger of the two (a handful of rounded terms at these
    sizes), every value finite."""
    q, k, v, g, mask = (torch.from_numpy(a).to(cuda) for a in edge_inputs(case, 12, 64))
    q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
    kw = edge_kwargs(case, cuda)
    bnd, w, geo, r, seed = port._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
        kw.get("row_start", 0), kw.get("offset", 0), rate, rate == 0.0, 23)
    before = port.LAUNCHES_BWD
    got = port._launch_bwd(q, k, v, mask, g, 12, bnd, w, geo, r, seed)
    torch.cuda.synchronize()
    assert port.LAUNCHES_BWD == before + 1
    want = port.fused_attention_bwd_reference(
        q, k, v, mask, g, 12, compute_dtype=torch.bfloat16, dropout_rate=rate,
        deterministic=rate == 0.0, dropout_seed=23, **kw)
    for a, b_ in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b_.float(),
                                   atol=2 ** -7 * b_.float().abs().max().item() + 1e-30,
                                   rtol=0)


@pytest.mark.cuda
def test_bwd_launches_counted_through_autograd(cuda):  # noqa: F811
    """One backward through fused_attention launches the backward kernel
    once (and the forward once)."""
    q, k, v = (torch.randn(2, 16, 768, device=cuda, requires_grad=True)
               for _ in range(3))
    mask = torch.ones(2, 16, device=cuda)
    before = (port.LAUNCHES, port.LAUNCHES_BWD)
    out = port.fused_attention(q, k, v, mask, 12, compute_dtype=torch.float32)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (port.LAUNCHES, port.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    assert q.grad is not None and torch.isfinite(q.grad).all()
