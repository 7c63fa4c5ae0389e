"""Port parity at the ragged edges of the tensor-core attention kernels.

On the card the bf16 kernels are held to the plain PyTorch versions
(``fused_attention_reference``, ``fused_attention_bwd_reference``) at the
edge cases of ``test_torch_port_attention.EDGE_CASES``: lengths of 1, 15,
17, 99, 227 and 418, a batch row whose keys are all masked, the boundary at
``row_start``, at ``text_len`` and past it, ``row_start`` 1, the +290
offset, B=1, dropout 0 and 0.1. So here, on the CPU, the plain versions are
held to the JAX Pallas kernels in interpret mode at those same cases (3
heads of 8): fp32 forward and backward, the dropout masks bit for bit, a
bf16 forward. Plus the build's library names, which must follow an edited
shared header."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as port
from mkg_analogy_tpu_torch.kernels import build
from test_torch_port_attention import EDGE_CASES, EDGE_IDS, H, D, edge_inputs, edge_kwargs

torch.set_num_threads(1)

# fp32 bars of the JAX kernel against its own oracle
# (tests/test_fused_attention.py:74 and :99): the same fp32 math summed in
# another order.
ATOL_FWD = 1e-5
ATOL_BWD = 2e-5
# A batch row whose keys are all masked has every score at s_raw - 1e4, where
# an fp32 ulp is 9.8e-4: a last-bit difference of s_raw between the two sides
# can move the rounded score by one ulp, and with it a probability by 1e-3
# of itself. The port rounds the score as XLA does inside the JAX kernel
# (kernels/attention.py:_score), but its q·k products sum in torch.matmul's
# order, not XLA's dot's; given the JAX dot's products the row holds 1e-5
# (test_masked_row_gap_is_the_dots_summation_order). So that row is held to
# 2e-3 of its largest value instead.
REL_MASKED_ROW = 2e-3


def assert_close_by_batch_row(got, want, case, atol, name=""):
    """(B, L, H*D) results: every batch row within ``atol``, the case's
    all-masked row within REL_MASKED_ROW of its largest value."""
    masked_row = case[5]
    for b in range(got.shape[0]):
        bar = atol
        if b == masked_row:
            bar = max(atol, REL_MASKED_ROW * float(np.abs(want[b]).max()))
        np.testing.assert_allclose(got[b], want[b], atol=bar, rtol=0,
                                   err_msg=f"{name} batch row {b}")


def jax_kwargs(case):
    import jax.numpy as jnp

    geometry = case[4]
    if geometry is None:
        return {}
    return dict(geometry, boundary=jnp.asarray(geometry["boundary"]))


def jax_forward(case, q, k, v, mask, rate, seed, dtype=None):
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused

    dtype = dtype or jnp.float32
    kw = jax_kwargs(case)
    if kw:
        kw.update(w0=jnp.asarray([0.3]), w1=jnp.asarray([0.7]))
    return np.asarray(jax_fused(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(mask), H, compute_dtype=dtype, interpret=True, dropout_rate=rate,
        deterministic=rate == 0.0, dropout_seed=jnp.asarray(seed, jnp.int32), **kw),
        np.float32)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_plain_forward_matches_jax_kernel_at_the_edges(case, rate):
    q, k, v, _, mask = edge_inputs(case, H, D)
    want = jax_forward(case, q, k, v, mask, rate, seed=21)
    got = port.fused_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), H, compute_dtype=torch.float32, dropout_rate=rate,
        deterministic=rate == 0.0, dropout_seed=21, **edge_kwargs(case))
    assert np.isfinite(want).all()
    assert_close_by_batch_row(got.numpy(), want, case, ATOL_FWD)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_plain_backward_matches_jax_kernel_at_the_edges(case, rate):
    """dq, dk, dv and (dw0, dw1) against ``jax.vjp`` of the interpret-mode
    kernel, which runs the Pallas ``_bwd_kernel``. The dw sums run over up
    to Lq x Lk terms in another order: their bar scales with Lq, as in
    tests/test_torch_port_attention_bwd.py."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused

    q, k, v, g, mask = edge_inputs(case, H, D)
    geometry = case[4] is not None
    kw = jax_kwargs(case)

    def f(q, k, v, w0, w1):
        extra = dict(w0=w0, w1=w1) if geometry else {}
        return jax_fused(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32,
                         interpret=True, dropout_rate=rate, deterministic=rate == 0.0,
                         dropout_seed=jnp.asarray(23, jnp.int32), **kw, **extra)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray([0.3]), jnp.asarray([0.7]))
    want = vjp(jnp.asarray(g))
    got = port.fused_attention_bwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), torch.from_numpy(g), H, compute_dtype=torch.float32,
        dropout_rate=rate, deterministic=rate == 0.0, dropout_seed=23,
        **edge_kwargs(case))
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert_close_by_batch_row(a.numpy(), np.asarray(b), case, ATOL_BWD, name)
    if geometry:
        for i, name in enumerate(("dw0", "dw1")):
            np.testing.assert_allclose(float(got[3][i]), float(want[3 + i][0]),
                                       atol=ATOL_BWD * case[2], err_msg=name)
    else:
        assert not got[3].any()


MASKED_ROW_CASES = [c for c in EDGE_CASES if c[5] is not None]


@pytest.mark.parametrize("case", MASKED_ROW_CASES, ids=[c[0] for c in MASKED_ROW_CASES])
def test_masked_row_gap_is_the_dots_summation_order(case):
    """Why the all-masked row holds 2e-3 and not 1e-5: given the JAX kernel's
    own q·k products (XLA's dot_general under jit, which is how the
    interpret-mode kernel runs it), the port's softmax-and-product path
    (``_softmax_scores``, then P·V) gives the JAX kernel's output within
    1e-5 of the masked row's largest value and every other row within
    ATOL_FWD. What is left is the products' summation order, which no plain
    PyTorch call reproduces."""
    import jax
    import jax.numpy as jnp

    q, k, v, _, mask = edge_inputs(case, H, D)
    want = jax_forward(case, q, k, v, mask, 0.0, seed=0)
    b, lq, lk = case[1], case[2], case[3]
    dot = jax.jit(lambda a, c: jax.lax.dot_general(
        a, c, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    qh, kh = (x.reshape(b, -1, H, D).transpose(0, 2, 1, 3) for x in (q, k))
    products = torch.from_numpy(np.stack([np.stack([np.asarray(dot(qh[i, h], kh[i, h]))
                                                    for h in range(H)]) for i in range(b)]))
    kw = edge_kwargs(case)
    bnd, w, geometry, _, _ = port._resolve(
        torch.from_numpy(q), kw.get("boundary"), kw.get("w0"), kw.get("w1"),
        kw.get("text_len"), kw.get("row_start", 0), kw.get("offset", 0), 0.0, True, None)
    _, _, p = port._softmax_scores(products, torch.from_numpy(mask), bnd, w, geometry,
                                   D ** -0.5)
    got = port._merge_heads(torch.matmul(p, port._split_heads(torch.from_numpy(v), H,
                                                              torch.float32)),
                            torch.float32).numpy()
    masked = case[5]
    for i in range(b):
        bar = 1e-5 * float(np.abs(want[i]).max()) if i == masked else ATOL_FWD
        np.testing.assert_allclose(got[i], want[i], atol=bar, rtol=0, err_msg=f"batch row {i}")


@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_dropout_masks_match_jax_bit_for_bit_at_the_edges(case):
    """The keep mask of every (batch row, head) cell against the JAX
    interpret-mode ``_dropout_keep`` with the seeds of ``_cell_seed``; the
    kernels on the card index the same hash by ``row * Lk + col``."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import _dropout_keep

    _, b, lq, lk, _, _ = case
    seed, rate = 2 ** 31 - 9, 0.1  # the cell seeds wrap past int32
    got = port.dropout_keep(b, H, lq, lk, rate, seed, "cpu").numpy()
    for bi in range(b):
        for h in range(H):
            cell = jnp.asarray(seed, jnp.int32) + jnp.asarray(bi * H + h, jnp.int32)
            want = np.asarray(_dropout_keep((lq, lk), rate, cell, interpret=True))
            assert np.array_equal(got[bi, h], want), (bi, h)


@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_plain_forward_bf16_with_dropout_at_the_edges(case):
    """bf16 inputs and compute dtype, dropout on: the same keep mask on both
    sides (a differing mask would move an output by a whole probability),
    within two bf16 ulps of outputs of magnitude ~1 (8e-3), the bar of
    tests/test_torch_port_attention.py::test_reference_bf16_compute."""
    import jax.numpy as jnp

    q, k, v, _, mask = edge_inputs(case, H, D)
    want = jax_forward(case, q, k, v, mask, 0.1, seed=5, dtype=jnp.bfloat16)
    got = port.fused_attention_reference(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.from_numpy(mask), H,
        compute_dtype=torch.bfloat16, dropout_rate=0.1, deterministic=False,
        dropout_seed=5, **edge_kwargs(case))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3)


def test_library_name_follows_shared_headers(monkeypatch, tmp_path):
    """A library is named by its source, every header under csrc/ and the
    flags: editing only a shared header must rebuild the kernels that may
    include it, and an unchanged tree must reuse what is built."""
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("kernel")
    assert build.library_path("kernel") == first
    (tmp_path / "shared.cuh").write_text("// two\n")
    second = build.library_path("kernel")
    assert second != first
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.library_path("kernel") not in (first, second)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    assert build.library_path("kernel") != second


def test_resource_usage_reads_the_compilers_report(monkeypatch, tmp_path):
    """``resource_usage`` parses what ``ptxas -v`` printed at build time
    (registers, spills, static shared memory) from the log kept beside the
    library."""
    (tmp_path / "kernel.cu").write_text("// source\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.library_path("kernel").with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function 'first_kernel' for 'sm_90a'\n"
        "ptxas info    : Function properties for first_kernel\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 140 registers, used 1 barriers, 46592 bytes smem, "
        "476 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z6secondv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z6secondv\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]\n")
    assert build.resource_usage("kernel") == [
        dict(entry="first_kernel", registers=140, spill_store_bytes=0,
             spill_load_bytes=0, static_smem_bytes=46592),
        dict(entry="_Z6secondv", registers=255, spill_store_bytes=8,
             spill_load_bytes=12, static_smem_bytes=0),
    ]
