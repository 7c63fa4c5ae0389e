"""Port parity: the plain PyTorch fused attention
(mkg_analogy_tpu_torch/kernels/attention.py:fused_attention_reference)
against the JAX Pallas kernel run in interpret mode, on the same numpy
inputs, across the mask geometries of tests/test_fused_attention.py, with
cross-length K/V and with dropout. Plus the wrapper's routing on the CPU,
and the CUDA kernel against the plain version (needs a card)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as port
from mkg_analogy_tpu_torch.kernels import build

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it (see README, "PyTorch port").

torch.set_num_threads(1)

H, D = 3, 8  # heads, head_dim (as tests/test_fused_attention.py)

# (boundary, row_start, text_len, offset): tests/test_fused_attention.py:53-60
CASES = [
    dict(),                                             # padding mask only
    dict(boundary=(5, 7), row_start=0),                 # unimo geometry
    dict(boundary=(5, 7), row_start=1),                 # vilbert/flava
    dict(boundary=(4, 6), row_start=1, text_len=8),     # single-stream fix
    dict(boundary=(3, 5), row_start=5, offset=4),       # compat img offset
]

# fp32 forward bar of the JAX kernel against its einsum oracle
# (tests/test_fused_attention.py:74): both sides compute the same fp32
# math, summed in a different order.
ATOL = 1e-5


def make_inputs(b=2, lq=12, lk=12, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, H * D)).astype(np.float32)
    k = rng.standard_normal((b, lk, H * D)).astype(np.float32)
    v = rng.standard_normal((b, lk, H * D)).astype(np.float32)
    mask = np.ones((b, lk), np.float32)
    mask[:, lk - 2:] = 0.0
    return q, k, v, mask


def run_both(q, k, v, mask, case, rate=0.0, seed=0):
    """(JAX interpret-mode kernel, port plain version) outputs, fp32."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused

    jkw, tkw = dict(case), dict(case)
    if "boundary" in case:
        jkw.update(boundary=jnp.asarray(case["boundary"]),
                   w0=jnp.asarray([0.3]), w1=jnp.asarray([0.7]))
        tkw.update(boundary=torch.tensor(case["boundary"]),
                   w0=torch.tensor([0.3]), w1=torch.tensor([0.7]))
    want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), H, compute_dtype=jnp.float32,
                     interpret=True, dropout_rate=rate,
                     deterministic=rate == 0.0,
                     dropout_seed=jnp.asarray(seed, jnp.int32), **jkw)
    got = port.fused_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), H, compute_dtype=torch.float32,
        dropout_rate=rate, deterministic=rate == 0.0, dropout_seed=seed, **tkw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("case", CASES)
def test_reference_matches_jax_kernel(case):
    want, got = run_both(*make_inputs(), case)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]])
def test_reference_cross_length_kv(case):
    """Lq != Lk: the vision tower attending [text K/V ; vision]."""
    q, _, _, _ = make_inputs(lq=9, lk=9)
    _, k, v, mask = make_inputs(lq=20, lk=20, seed=5)
    if "boundary" in case:
        case = dict(case, text_len=9)
    want, got = run_both(q, k, v, mask, case)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("seed", [3, 2 ** 31 - 5])
def test_reference_dropout_matches_jax_kernel(seed):
    """Same counter hash on both sides, so the keep masks are identical and
    the forward bar stays at 1e-5; the second seed wraps the per-cell seed
    past int32."""
    q, k, v, mask = make_inputs(seed=1)
    want, got = run_both(q, k, v, mask, CASES[1], rate=0.1, seed=seed)
    np.testing.assert_allclose(got, want, atol=ATOL)
    dropped = (got == 0.0).all(axis=-1)  # whole output rows never drop
    assert not dropped.any()


def test_dropout_keep_rate_and_seeds():
    """Keep fraction ~ 1 - rate; distinct (b, head) cells draw distinct
    masks; the same seed redraws the same mask."""
    keep = port.dropout_keep(4, 3, 64, 64, 0.25, 11, "cpu")
    assert abs(keep.float().mean().item() - 0.75) < 0.01
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert not torch.equal(keep[0, 0], keep[1, 0])
    assert torch.equal(keep, port.dropout_keep(4, 3, 64, 64, 0.25, 11, "cpu"))


def test_reference_bf16_compute():
    """bf16 inputs and compute dtype: fp32 scores and softmax, probs rounded
    to bf16 before ·V. Against the JAX kernel (interpret) on the same bf16
    inputs, within two bf16 ulps of outputs of magnitude ~1 (8e-3)."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused

    q, k, v, mask = make_inputs(seed=2)
    case = dict(CASES[1], boundary=jnp.asarray(CASES[1]["boundary"]))
    want = jax_fused(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), H,
                     w0=jnp.asarray([0.3]), w1=jnp.asarray([0.7]),
                     compute_dtype=jnp.bfloat16, interpret=True, **case)
    got = port.fused_attention_reference(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.from_numpy(mask), H,
        boundary=torch.tensor(CASES[1]["boundary"]), w0=torch.tensor([0.3]),
        w1=torch.tensor([0.7]), row_start=0, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=8e-3)


def test_wrapper_on_cpu_takes_plain_version():
    """A CPU tensor goes to the plain version; the launch count stays."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs())
    before = port.LAUNCHES
    got = port.fused_attention(q, k, v, mask, H, compute_dtype=torch.float32)
    want = port.fused_attention_reference(q, k, v, mask, H,
                                          compute_dtype=torch.float32)
    assert port.LAUNCHES == before
    assert torch.equal(got, want)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that is not built and cannot be built raises; nothing falls
    back to the plain version."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("fused_attention_fwd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the three main-path shapes: text (geometry), vision, vision over text K/V
MAIN_SHAPES = [(128, 128, True), (99, 99, False), (99, 227, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,geometry", MAIN_SHAPES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(cuda, lq, lk, geometry, dtype, atol):
    """The CUDA kernel against the plain version on the card, at the
    main-path shapes (B=4, 12 heads of 64). fp32: the same fp32 math in
    another summation order; bf16: one bf16 ulp of outputs of magnitude
    ~1 after the probabilities' rounding may land on either side."""
    g = torch.Generator(device="cpu").manual_seed(0)
    b, hd = 4, 12 * 64
    q, k, v = (torch.randn(b, n, hd, generator=g).to(cuda, dtype)
               for n in (lq, lk, lk))
    mask = torch.ones(b, lk)
    mask[:, lk - 7:] = 0.0
    mask = mask.to(cuda)
    kw = dict(compute_dtype=dtype, dropout_rate=0.1, deterministic=False,
              dropout_seed=5)
    if geometry:
        kw.update(boundary=torch.tensor([40, 60, 80, 100], device=cuda),
                  w0=torch.tensor([0.3], device=cuda),
                  w1=torch.tensor([0.7], device=cuda))
    before = port.LAUNCHES
    got = port.fused_attention(q, k, v, mask, 12, **kw)
    torch.cuda.synchronize()
    assert port.LAUNCHES == before + 1
    want = port.fused_attention_reference(q, k, v, mask, 12, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# The ragged edges of the 64-row tiles and 64-key chunks of the tensor-core
# kernels: (name, B, Lq, Lk, geometry keywords or None, batch row whose keys
# are all masked or None). Lengths of 1, 15, 17, 99, 227 and 418; the
# boundary at row_start, at text_len and past it; row_start 1; the +290
# offset of the single-stream families; B=1.
EDGE_CASES = [
    ("1x1", 1, 1, 1, None, None),
    ("15x17_boundary_at_row_start_and_text_len", 2, 15, 17,
     dict(boundary=(1, 15), row_start=1), 0),
    ("17x15_boundary_at_and_past_text_len", 2, 17, 15,
     dict(boundary=(15, 20), row_start=0, text_len=15), 1),
    ("99x99", 2, 99, 99, None, 0),
    ("99x227", 2, 99, 227, None, 1),
    ("1x227", 2, 1, 227, None, None),
    ("227x1", 2, 227, 1, dict(boundary=(0, 5), row_start=1), None),
    ("418x418_rows_from_1_text_128", 1, 418, 418,
     dict(boundary=(60,), row_start=1, text_len=128), None),
    ("418x418_offset_290", 2, 418, 418,
     dict(boundary=(1, 128), row_start=1, offset=290), 0),
]
EDGE_IDS = [c[0] for c in EDGE_CASES]


def edge_inputs(case, heads, head_dim):
    """numpy (q, k, v, g, mask) of an edge case from a fixed seed; the mask
    pads the last keys of every row and all keys of the case's masked row."""
    name, b, lq, lk, _, masked_row = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, g = (rng.standard_normal((b, n, heads * head_dim)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    mask = np.ones((b, lk), np.float32)
    mask[:, lk - lk // 8:] = 0.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    return q, k, v, g, mask


def edge_kwargs(case, device="cpu"):
    """The port's keyword arguments of an edge case's geometry."""
    geometry = case[4]
    if geometry is None:
        return {}
    return dict(geometry, boundary=torch.tensor(geometry["boundary"], device=device),
                w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_tensor_core_kernel_at_the_ragged_edges(cuda, case, rate):
    """The bf16 tensor-core forward against the plain version on the card
    (12 heads of 64) where tiles and chunks are ragged, a row's keys are all
    masked and the boundary sits on the geometry's edges; the same seed, so
    the dropout masks must agree. The bf16 bar of the main shapes."""
    q, k, v, _, mask = (torch.from_numpy(a).to(cuda) for a in edge_inputs(case, 12, 64))
    q, k, v = (x.bfloat16() for x in (q, k, v))
    kw = dict(edge_kwargs(case, cuda), compute_dtype=torch.bfloat16, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=21)
    before = port.LAUNCHES
    got = port.fused_attention(q, k, v, mask, 12, **kw)
    torch.cuda.synchronize()
    assert port.LAUNCHES == before + 1
    want = port.fused_attention_reference(q, k, v, mask, 12, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_raises_beyond_shared_memory(cuda):
    """Keys beyond the single-block route's limit (bf16: Lk > 717, where the
    CUDA-core kernels' shared memory ended) raise and name the flash kernel;
    nothing falls back."""
    q = torch.zeros(1, 4, 768, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 1024, 768, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(1, 1024, device=cuda)
    with pytest.raises(ValueError, match="flash"):
        port.fused_attention(q, k, k, mask, 12)
