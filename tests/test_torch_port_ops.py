"""Port parity for ops/: the analogy masks and the ranking metrics of
mkg_analogy_tpu_torch against mkg_analogy_tpu on the same numpy inputs;
plus the port's import hygiene (no JAX, nothing of the JAX package)."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.ops import masks as jmasks
from mkg_analogy_tpu.ops import ranking as jranking
from mkg_analogy_tpu_torch.ops import masks, ranking

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the geometries of tests/test_fused_attention.py:53-60, in ops/masks terms:
# (boundary, row_start, text_len, compat_img_offset)
GEOMETRIES = [
    dict(boundary=(5, 7), row_start=0),
    dict(boundary=(5, 7), row_start=1),
    dict(boundary=(4, 6), row_start=1, text_len=8),
    dict(boundary=(3, 5), row_start=5, compat_img_offset=4),
    dict(boundary=(0, 12), row_start=0),  # boundary at both ends
]


def test_attention_bias_matches_jax():
    rng = np.random.default_rng(0)
    mask = (rng.random((3, 17)) > 0.3).astype(np.int32)
    want = np.asarray(jmasks.attention_bias(jnp.asarray(mask)))
    got = masks.attention_bias(torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 1, 1, 17)
    np.testing.assert_array_equal(got, want)  # 0 / -1e4 exactly


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("w0,w1", [(0.3, 0.7), (0.9, 0.2)])  # second: clamped
def test_analogy_score_multiplier_matches_jax(geom, w0, w1):
    geom = dict(geom)
    boundary = np.asarray(geom.pop("boundary"), np.int32)
    want = jmasks.analogy_score_multiplier(
        jnp.asarray(boundary), 12, jnp.asarray([w0]), jnp.asarray([w1]), **geom)
    got = masks.analogy_score_multiplier(
        torch.from_numpy(boundary), 12, torch.tensor([w0]), torch.tensor([w1]),
        **geom)
    assert got.shape == (2, 1, 12, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # selections only


@pytest.mark.parametrize("w0,w1", [(0.5, 0.5), (0.0, 1.0)])  # each on a bound of its clip
def test_analogy_score_multiplier_gradient_at_the_ties_matches_jax(w0, w1):
    """At a tie with a clip bound (``adaptive_w1`` starts at 0.5) ``jnp.clip``
    passes half the slope to w and ``torch.clamp`` all of it: the port's
    gradients of the multiplier against ``jax.grad`` of the JAX function."""
    import jax

    boundary = np.asarray([5, 7], np.int32)
    weight = np.random.default_rng(3).standard_normal((2, 1, 12, 12)).astype(np.float32)

    def jax_loss(a, b):
        mult = jmasks.analogy_score_multiplier(jnp.asarray(boundary), 12, a, b, row_start=1)
        return jnp.sum(mult * weight)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray([w0]), jnp.asarray([w1]))
    got = [torch.tensor([x], requires_grad=True) for x in (w0, w1)]
    mult = masks.analogy_score_multiplier(torch.from_numpy(boundary), 12, *got, row_start=1)
    (mult * torch.from_numpy(weight)).sum().backward()
    for name, g, w in zip(("w0", "w1"), got, want):
        assert float(w[0]) != 0.0, name
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-6, err_msg=name)


def _scores_with_ties(seed):
    rng = np.random.default_rng(seed)
    # few distinct values, so ties are everywhere, including at the label
    scores = rng.integers(0, 6, (64, 40)).astype(np.float32)
    labels = rng.integers(0, 40, 64).astype(np.int32)
    scores[0] = 1.0  # one row entirely tied
    scores[1, :] = 0.0
    scores[1, labels[1]] = 5.0  # a unique maximum at the label
    return scores, labels


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_ranks_and_ties_match_jax(kind):
    """Stable-sort ranks and tie-group sizes are integers: exact match."""
    if kind == "random":
        rng = np.random.default_rng(1)
        scores = rng.standard_normal((64, 40)).astype(np.float32)
        labels = rng.integers(0, 40, 64).astype(np.int32)
    else:
        scores, labels = _scores_with_ties(2)
    s, lab = torch.from_numpy(scores), torch.from_numpy(labels)
    ranks = ranking.ranks_from_scores(s, lab)
    ties = ranking.tie_counts(s, lab)
    np.testing.assert_array_equal(
        ranks.numpy(), np.asarray(jranking.ranks_from_scores(jnp.asarray(scores),
                                                             jnp.asarray(labels))))
    np.testing.assert_array_equal(
        ties.numpy(), np.asarray(jranking.tie_counts(jnp.asarray(scores),
                                                     jnp.asarray(labels))))
    # the definition: rank = position of the label under a stable sort
    order = np.argsort(-scores, axis=1, kind="stable")
    np.testing.assert_array_equal(
        ranks.numpy(), np.argmax(order == labels[:, None], axis=1) + 1)
    if kind == "ties":
        assert ranks[0] == labels[0] + 1 and ties[0] == 40
        assert ranks[1] == 1 and ties[1] == 1


def test_rank_metrics_and_rank_score_match_jax():
    """Means of fp32 values over 500 ranks: the sums run in another order,
    so a few fp32 ulps of a value <= mean rank apart (bar 1e-7 relative to
    values <= 1, and relative 1e-7 for the mean rank)."""
    ranks = np.random.default_rng(3).integers(1, 60, 500).astype(np.int32)
    want = jranking.rank_metrics(jnp.asarray(ranks))
    got = ranking.rank_metrics(torch.from_numpy(ranks))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-7,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(ranking.rank_score(ranks),
                               jranking.rank_score(ranks), atol=1e-7)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "mkg_analogy_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# Each root tools/*.py: its counterpart in the port (a path under
# mkg_analogy_tpu_torch/), or why the port has none.
HARNESS = ("TPU-only harness (jax.profiler, XLA flags, Pallas on the chip); chip_smoke.py "
           "and mkg_analogy_tpu_torch/tools/time_attention.py measure this on the card")
TOOLS = {
    "analyze_ranks.py": "reads the rank dumps, which the port writes in the same format "
                        "(tests/test_torch_port_leftovers.py runs it on the port's)",
    "attr_trace.py": HARNESS,
    "bench_attention_seq.py": HARNESS,
    "bench_knobs.py": HARNESS,
    "bench_matmul.py": HARNESS,
    "bench_opts.py": HARNESS,
    "calibrate_baseline.py": "measures the reference PyTorch model on the host CPU, no "
                             "package of this repo",
    "check_flash_tpu.py": "the Mosaic lowering and the TPU's random bits; on the card "
                          "chip_smoke.py holds every kernel to its plain version",
    "collect_quality.py": "parses the CLI's logs, which the port writes alike",
    "cpu_cli.py": "selects JAX's CPU platform; the port's CLIs take --device cpu",
    "encode_images.py": "tools/encode_images.py",
    "fit_gelu_poly.py": "fits gelu_poly's coefficients offline (numpy); "
                        "kernels/gelu_poly.py holds the fitted ones",
    "prepare_data.py": "tools/prepare_data.py",
    "profile_step.py": HARNESS,
    "race_base_so.py": "races the native sampler against the reference's prebuilt "
                       "library (ctypes), no JAX; the port's sampler is the same source",
}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "mkg_analogy_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    walked = {str(f.relative_to(ROOT / "mkg_analogy_tpu_torch")) for f in files[:-1]}
    # every module of the JAX package has its counterpart at the same path,
    # so none escapes the walk
    jax_modules = {str(f.relative_to(ROOT / "mkg_analogy_tpu"))
                   for f in (ROOT / "mkg_analogy_tpu").rglob("*.py")}
    assert len(jax_modules) > 60
    missing = sorted(jax_modules - walked)
    assert not missing, f"JAX modules with no counterpart in the port: {missing}"
    # every root tool is mapped: to the port's counterpart, or to a reason
    tools = {f.name for f in (ROOT / "tools").glob("*.py")}
    assert tools == set(TOOLS), sorted(tools ^ set(TOOLS))
    for name, where in TOOLS.items():
        if where.endswith(".py") and " " not in where:
            assert where in walked, (name, where)
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # the native sampler builds from the port's own source into build/native
    from mkg_analogy_tpu_torch.native import build as native_build

    port = ROOT / "mkg_analogy_tpu_torch"
    assert native_build.SRC.parent == port / "native"
    assert native_build.library_path().parent == ROOT / "build" / "native"
    for f in (port / "native").glob("*.py"):
        assert "mkg_analogy_tpu/" not in f.read_text(), f
