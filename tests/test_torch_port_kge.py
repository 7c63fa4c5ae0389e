"""The port's KGE building blocks against the JAX package, on the CPU: the
scorers and their gradients, the numpy samplers and the native sampler (bit
for bit), torch_adagrad, PV-DM, and the evaluation functions on the same
energies. The models are in tests/test_torch_port_kge_models.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.kge import eval as jeval
from mkg_analogy_tpu.kge import pvdm as jpvdm
from mkg_analogy_tpu.kge import sampling as jsampling
from mkg_analogy_tpu.kge import scorers as jscorers
from mkg_analogy_tpu.ops import ranking as jranking
from mkg_analogy_tpu.train.optim import torch_adagrad as jax_torch_adagrad
from mkg_analogy_tpu_torch.kge import eval as peval
from mkg_analogy_tpu_torch.kge import pvdm as ppvdm
from mkg_analogy_tpu_torch.kge import sampling as psampling
from mkg_analogy_tpu_torch.kge import scorers as pscorers
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.train.optim import torch_adagrad

torch.set_num_threads(1)

E, R = 64, 6


def t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def assert_rel(got, want, rel, what=""):
    """|got - want| <= rel * max|want| (a relative bar on the array's
    scale, so entries near 0 are held to the same absolute error)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} * {scale}"


def grads_match(jgrads, model, rel=1e-5):
    """Every gradient leaf of the port within ``rel`` of the largest value
    of JAX's, leaf by leaf (names through the converter)."""
    want = params_from_jax({"params": jax.device_get(jgrads)})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name]
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        assert_rel(g, w.numpy(), rel, name)


# ---------------------------------------------------------------- scorers
def _scorer_cases():
    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    h, tt, r = arr(5, 1, 12), arr(1, 7, 12), arr(5, 1, 12)
    nine = [arr(4, 6) for _ in range(9)]
    lhs, rel, rhs = arr(4, 10), arr(4, 10), arr(4, 10)
    p, n = arr(6), arr(6, 5)
    return {
        "l2_normalize": (lambda m, x: m.l2_normalize(x), [arr(5, 12)]),
        "transe_l1": (lambda m, a, b, c: m.transe_distance(a, b, c, 1), [h, tt, r]),
        "transe_l2": (lambda m, a, b, c: m.transe_distance(a, b, c, 2, False), [h, tt, r]),
        "transe_l3": (lambda m, a, b, c: m.transe_distance(a, b, c, 3), [h, tt, r]),
        "analogy_energy": (lambda m, *x: m.analogy_energy(*x), nine),
        "complex_score": (lambda m, a, b, c: m.complex_score(a, b, c, 5), [lhs, rel, rhs]),
        "complex_queries": (lambda m, a, b: m.complex_queries(a, b, 5), [lhs, rel]),
        "split_complex": (lambda m, a: m.split_complex(a, 5)[1], [lhs]),
        "distmult_score": (lambda m, a, b, c: m.distmult_score(a, b, c), [lhs, rel, rhs]),
        "margin_loss": (lambda m, a, b: m.margin_loss(a, b, 0.5), [p, n]),
        "softplus_loss": (lambda m, a, b: m.softplus_loss(a, b), [p * 8, n * 8]),
    }


@pytest.mark.parametrize("name", sorted(_scorer_cases()))
def test_scorer_and_its_gradient_match_jax(name):
    """Values and the gradient of sum(out * w) w.r.t. every input, 1e-6 of
    each array's largest value."""
    fn, inputs = _scorer_cases()[name]
    want = fn(jscorers, *map(jnp.asarray, inputs))
    xs = [t(x).requires_grad_() for x in inputs]
    got = fn(pscorers, *xs)
    assert_rel(got.detach().numpy(), want, 1e-6, name)
    w = np.random.default_rng(1).standard_normal(np.shape(want)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(fn(jscorers, *a) * w), argnums=tuple(range(len(xs))))(
        *map(jnp.asarray, inputs))
    torch.sum(got * t(w)).backward()
    for i, (x, g) in enumerate(zip(xs, jg)):
        assert_rel(x.grad.numpy(), g, 1e-6, f"{name} d/dx{i}")


def test_margin_loss_splits_the_tie_gradient_as_jax():
    """p - n == -margin exactly: jnp.maximum hands half the slope to each
    side; so must the port (torch.maximum, not clamp)."""
    p, n = np.array([0.0, 1.0], np.float32), np.array([[0.5], [3.0]], np.float32)
    jg = jax.grad(lambda a: jscorers.margin_loss(a, jnp.asarray(n), 0.5))(jnp.asarray(p))
    x = t(p).requires_grad_()
    pscorers.margin_loss(x, t(n), 0.5).backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    assert x.grad[0] == 0.25


# --------------------------------------------------------------- sampling
def _triples(seed=0, n=150, n_ent=30, n_rel=5):
    rng = np.random.default_rng(seed)
    rows = set()
    while len(rows) < n:
        rows.add((int(rng.integers(n_ent)), int(rng.integers(n_rel)),
                  int(rng.integers(n_ent))))
    return np.array(sorted(rows), np.int64), n_ent, n_rel


def _stores():
    rows, n_ent, n_rel = _triples()
    return (jsampling.TripleStore.from_arrays(rows, n_ent, n_rel),
            psampling.TripleStore.from_arrays(rows, n_ent, n_rel))


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode, bern", [("normal", True), ("normal", False),
                                        ("cross", True)])
def test_negative_sampler_batches_are_bit_identical(mode, bern):
    js, ps = _stores()
    kw = dict(batch_size=16, neg_ent=4, neg_rel=3 if mode == "normal" else 0,
              bern=bern, sampling_mode=mode, seed=5)
    jb = [b for _ in range(2) for b in jsampling.NegativeSampler(js, **kw)]
    pb = [b for _ in range(2) for b in psampling.NegativeSampler(ps, **kw)]
    assert len(jb) == len(pb) == 2 * (150 // 16)
    for a, b in zip(jb, pb):
        _assert_batches_equal(a, b)
    for key in ("lef_mean", "rig_mean"):
        assert getattr(js, key) == getattr(ps, key)


def test_split_store_is_bit_identical():
    js, ps = _stores()
    for a, b in zip(jsampling.split_store(js, 0.1, seed=3),
                    psampling.split_store(ps, 0.1, seed=3)):
        for col in ("heads", "tails", "rels"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    with pytest.raises(ValueError):
        psampling.split_store(ps, 0.5)


# --------------------------------------------------------- native sampler
def _openke_dir(root):
    rows, n_ent, n_rel = _triples(seed=1, n=120, n_ent=25, n_rel=4)
    root.mkdir(parents=True, exist_ok=True)
    (root / "entity2id.txt").write_text(
        f"{n_ent}\n" + "".join(f"e{i}\t{i}\n" for i in range(n_ent)))
    (root / "relation2id.txt").write_text(
        f"{n_rel}\n" + "".join(f"r{i}\t{i}\n" for i in range(n_rel)))
    for name, part in (("train", rows[:90]), ("test", rows[90:110]),
                       ("valid", rows[110:])):
        (root / f"{name}2id.txt").write_text(
            f"{len(part)}\n" + "".join(f"{h} {tt} {r}\n" for h, r, tt in part))
    return str(root)


def test_native_library_is_the_ports_own_build():
    from mkg_analogy_tpu.native import build as jbuild
    from mkg_analogy_tpu_torch.native import build as pbuild

    path = pbuild.build()
    assert path != jbuild.LIB and "libkgsampler.so" not in path
    assert path.startswith(str(pbuild.BUILD_DIR)) and pbuild.BUILD_DIR.parts[-2:] == (
        "build", "native")
    assert pbuild.build() == path  # reused, not rebuilt
    assert pbuild.SRC.read_bytes() == open(jbuild.SRC, "rb").read()


@pytest.mark.parametrize("mode", ["normal", "cross"])
def test_native_batches_match_the_jax_loader(tmp_path, mode):
    """The port's library and the JAX package's, both loaded in this
    process, at the same seed and thread count: the same batches."""
    from mkg_analogy_tpu.native import api as japi
    from mkg_analogy_tpu_torch.native import api as papi

    d = _openke_dir(tmp_path / "kg")
    kw = dict(batch_size=12, neg_ent=3, neg_rel=2 if mode == "normal" else 0,
              threads=3, sampling_mode=mode)
    jl, pl = japi.NativeTrainLoader(d, **kw), papi.NativeTrainLoader(d, **kw)
    assert pl.klib.lib._name != jl.klib.lib._name
    for a, b in zip(jl, pl):  # buffers are reused: compare batch by batch
        _assert_batches_equal(a, b)
    jt, pt = japi.NativeTestLoader(d), papi.NativeTestLoader(d)
    for a, b in zip(jt.classification_batch(), pt.classification_batch()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------- torch_adagrad
def test_torch_adagrad_matches_jax_over_five_steps():
    """Identical gradients (RSME's scale: params ~1e-3, gradients ~1e-9,
    some exactly 0) into both optimizers: parameters within 1e-7 after each
    of 5 steps (the first step is lr * sign(g))."""
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal((40, 8)) * 1e-3).astype(np.float32)
    grads = [(rng.standard_normal((40, 8)) * 1e-9).astype(np.float32) for _ in range(5)]
    for g in grads:
        g[::7] = 0.0
    tx = jax_torch_adagrad(1e-2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(t(p0))
    opt = torch_adagrad([param], 1e-2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state)
        jp = jp + upd
        param.grad = t(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-7)


# -------------------------------------------------------------------- PV-DM
CATS = ["the cat sat on the mat with another cat",
        "cat and kitten play with the cat toy",
        "the kitten chased the cat around the mat",
        "a cat and a kitten nap on the mat"]
PHYS = ["quantum physics equations describe particle fields",
        "particle physics uses quantum field equations",
        "the quantum equations govern particle physics fields",
        "fields and particles obey quantum physics equations"]


def test_pvdm_steps_from_the_same_tables_match_jax():
    """JAX's initial tables (its PRNG draw) into the port: the document
    table after one epoch of two steps (same windows, negatives, clip and
    Adam) within 1e-6. (The first step moves only the output table, which
    starts at 0; the second moves the document table.)"""
    cfg = dict(vector_size=8, epochs=1, window=2, min_count=1, lr=0.05, seed=0,
               batch_size=29)
    want = jpvdm.train_pvdm(CATS + PHYS, jpvdm.PVDMConfig(**cfg))
    H = cfg["vector_size"]
    docs = [jpvdm.simple_preprocess(s) for s in CATS + PHYS]
    V = len(jpvdm._build_vocab(docs, 1))
    assert V == len(ppvdm._build_vocab(docs, 1))
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    tables = {"doc": np.asarray(jax.random.uniform(k1, (8, H), jnp.float32, -0.5 / H,
                                                   0.5 / H)),
              "word": np.asarray(jax.random.uniform(k2, (V, H), jnp.float32, -0.5 / H,
                                                    0.5 / H))}
    got = ppvdm.train_pvdm(CATS + PHYS, ppvdm.PVDMConfig(**cfg), tables=tables)
    assert not np.allclose(got, tables["doc"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ppvdm.simple_preprocess("Hello, World! A x22 bb") == ["hello", "world", "bb"]


def test_pvdm_learns_similarity():
    """tests/test_kge_transae.py's check of the port's own training: topic
    clusters closer within than across."""
    cfg = ppvdm.PVDMConfig(vector_size=8, epochs=400, window=2, min_count=1,
                           lr=0.05, seed=0)
    vecs = ppvdm.train_pvdm(CATS + PHYS, cfg)
    assert vecs.shape == (8, 8)
    v = vecs / (np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-9)
    sim = v @ v.T
    within = (sim[:4, :4].sum() - 4 + sim[4:, 4:].sum() - 4) / (2 * 12)
    across = sim[:4, 4:].mean()
    assert within > across, (within, across)


# --------------------------------------------------------------- evaluation
def assert_metrics_equal(got, want):
    """The metrics of equal ranks: fp32 means of up to 140 values, which
    torch and XLA sum in other orders (and XLA multiplies by 1/n where torch
    divides), so each is held to 1e-6 relative (about 8 ulps; a sequential
    fp32 sum of n terms may be off by up to n ulps); the ranks themselves
    are compared exactly where the test has them. The port adds one key,
    ``nonfinite_gold``, the count of rows whose gold score is not finite
    (none here)."""
    assert set(got) == set(want) | {"nonfinite_gold"}
    assert got["nonfinite_gold"] == 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)


def _energy_table(seed=0, ties=True):
    """(E, R, E) energies, rounded so that some candidates tie the gold."""
    table = np.random.default_rng(seed).standard_normal((E, R, E)).astype(np.float32)
    return np.round(table, 1) if ties else table


@pytest.mark.parametrize("task_mode", ["text", "random"])
def test_link_prediction_matches_jax_on_the_same_energies(task_mode):
    """Energies from one table (ties included) through both functions:
    identical ranks, metrics equal; the random test-time modes are the same
    numpy draws."""
    rows, _, _ = _triples(seed=2, n=150, n_ent=E, n_rel=R)
    test = psampling.TripleStore.from_arrays(rows[:70], E, R)
    filters = peval.build_filters(psampling.TripleStore.from_arrays(rows, E, R))
    jfilters = jeval.build_filters(jsampling.TripleStore.from_arrays(rows, E, R))
    assert filters == jfilters
    table = _energy_table()
    seen = {"jax": [], "port": []}

    def energies(anchor, r, tm, corrupt, who):
        anchor, r, tm = (np.asarray(x) for x in (anchor, r, tm))
        seen[who].append(tm.copy())
        e = table[anchor, r] if corrupt == "tail" else table[:, r, anchor].T
        return e + tm[:, None].astype(np.float32) * 0.0

    want = jeval.link_prediction(lambda *a: energies(*a, who="jax"),
                                 jsampling.TripleStore.from_arrays(rows[:70], E, R),
                                 jfilters, E, batch_size=16, task_mode=task_mode, seed=4)
    got, ranks = peval.link_prediction(
        lambda *a: torch.from_numpy(energies(*a, who="port")), test, filters, E,
        batch_size=16, task_mode=task_mode, seed=4, return_ranks=True)
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)
    assert_metrics_equal(got, want)
    assert (ranks["filter"] <= ranks["raw"]).all() and (ranks["filter"] < ranks["raw"]).any()


def test_analogical_reasoning_and_triple_classification_match_jax():
    rng = np.random.default_rng(5)
    tuples = np.stack([rng.integers(0, E, 50), rng.integers(0, E, 50),
                       rng.integers(0, E, 50), rng.integers(0, E, 50),
                       rng.integers(0, R, 50), np.arange(50) % 3], axis=1)
    table = np.round(rng.standard_normal((E, E)), 1).astype(np.float32)
    want = jeval.analogical_reasoning(lambda eh, et, q, tm: jnp.asarray(table)[q],
                                      tuples, batch_size=16)
    got, ranks, ties = peval.analogical_reasoning(
        lambda eh, et, q, tm: torch.from_numpy(table)[q], tuples, batch_size=16,
        return_ranks=True)
    assert_metrics_equal(got, want)
    np.testing.assert_array_equal(ranks, jranking.ranks_from_scores(
        jnp.asarray(table)[tuples[:, 2]], jnp.asarray(tuples[:, 3])))
    s_gold = table[tuples[:, 2], tuples[:, 3]]
    np.testing.assert_array_equal(ties, (table[tuples[:, 2]] == s_gold[:, None]).sum(1))
    assert (ties > 1).any()

    rows, _, _ = _triples(seed=6, n=60, n_ent=E, n_rel=R)
    pos = psampling.TripleStore.from_arrays(rows[:30], E, R)
    neg = psampling.TripleStore.from_arrays(rows[30:], E, R)
    scores = _energy_table(7)

    def score(h, tl, r, tm):
        return scores[np.asarray(h), np.asarray(r), np.asarray(tl)]

    want = jeval.triple_classification(
        lambda *a: jnp.asarray(score(*a)), jsampling.TripleStore.from_arrays(rows[:30], E, R),
        jsampling.TripleStore.from_arrays(rows[30:], E, R))
    got = peval.triple_classification(lambda *a: torch.from_numpy(score(*a)), pos, neg)
    assert got == want
    s = np.random.default_rng(8).standard_normal(40)
    y = (np.arange(40) % 2).astype(np.float64)
    assert peval.best_threshold(s, y) == jeval.best_threshold(s, y)
