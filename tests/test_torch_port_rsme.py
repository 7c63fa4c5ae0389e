"""The port's RSME silo against the JAX package, on the CPU: RSMEModel
(ComplEx and Analogy, gate on and off, compat_ref_mode1_gold) and CPModel on
converted weights, one training step's loss and gradients under N3 and F2,
filtered ranks on both sides, and the dataset helpers. ``cli.rsme`` is in
tests/test_torch_port_rsme_cli.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.kge import rsme as jrsme
from mkg_analogy_tpu_torch.kge import rsme as prsme
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.train import checkpoint
from tests.test_torch_port_kge import assert_metrics_equal, assert_rel, grads_match

torch.set_num_threads(1)

E, R, RANK, IMG = 64, 5, 16, 24


def _features(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((E, IMG)).astype(np.float32)
    img[3] = 0.0  # an entity without an image: the cosine's 1e-8 floor
    pd = rng.integers(0, 2, size=(2 * R,)).astype(np.float32)
    return img, pd


def _pair(model="complex", gate=True, compat=False, init=1e-3, cols=4):
    """(JAX module, its variables, port module on the same weights)."""
    img, pd = _features()
    if model == "cp":
        jm = jrsme.CPModel(E, R, RANK, init)
        pm = prsme.CPModel(E, R, RANK, init)
    else:
        kw = dict(rank=RANK, img_dim=IMG, model=model, forget_gate=gate,
                  compat_ref_mode1_gold=compat, init_size=init)
        jm = jrsme.RSMEModel(jrsme.RSMEConfig(E, R, **kw), img_vec=img, rel_pd=pd)
        pm = prsme.RSMEModel(prsme.RSMEConfig(E, R, **kw), img_vec=img, rel_pd=pd)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((2, cols), jnp.int32)))
    pm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, pm


def _queries(n, seed, cols=4):
    rng = np.random.default_rng(seed)
    q = np.stack([rng.integers(0, E, n), rng.integers(0, 2 * R, n),
                  rng.integers(0, E, n), np.arange(n) % 3], axis=1)
    if cols == 6:  # [e_h, e_t, q, a, r, mode]
        q = np.stack([q[:, 0], q[:, 2], rng.integers(0, E, n), rng.integers(0, E, n),
                      q[:, 1], q[:, 3]], axis=1)
    return q.astype(np.int64)


CASES = [("complex", True), ("complex", False), ("analogy", True), ("analogy", False)]


@pytest.mark.parametrize("model, gate", CASES)
def test_rsme_outputs_match_jax(model, gate):
    """__call__ (predictions and the three factors), finetune_forward,
    ranking_scores and gold_scores (with and without
    compat_ref_mode1_gold): 1e-5 of each output's largest value."""
    for compat in (False, True):
        jm, v, pm = _pair(model, gate, compat, init=0.1)
        q4, q6 = _queries(30, 2), _queries(30, 3, cols=6)

        def jit(method):
            return jax.jit(lambda x: jm.apply(v, x, method=method))

        with torch.no_grad():
            jp, jf = jit(None)(jnp.asarray(q4))
            pp, pf = pm(torch.from_numpy(q4))
            assert_rel(pp, jp, 1e-5, "preds")
            for a, b in zip(pf, jf):
                assert_rel(a, b, 1e-5, "factors")
            jp, jf = jit(type(jm).finetune_forward)(jnp.asarray(q6))
            pp, pf = pm.finetune_forward(torch.from_numpy(q6))
            assert_rel(pp, jp, 1e-5, "finetune preds")
            for a, b in zip(pf, jf):
                assert_rel(a, b, 1e-5, "finetune factors")
            for method in ("ranking_scores", "gold_scores"):
                want = jit(getattr(type(jm), method))(jnp.asarray(q4))
                assert_rel(getattr(pm, method)(torch.from_numpy(q4)), want, 1e-5, method)


def test_cp_outputs_match_jax():
    jm, v, pm = _pair("cp", init=0.1)
    q = _queries(20, 4)
    with torch.no_grad():
        jp, jf = jm.apply(v, jnp.asarray(q))
        pp, pf = pm(torch.from_numpy(q))
        assert_rel(pp, jp, 1e-5, "preds")
        for a, b in zip(pf, jf):
            assert_rel(a, b, 1e-5, "factors")
        want = jm.apply(v, jnp.asarray(q), method=jrsme.CPModel.ranking_scores)
        assert_rel(pm.ranking_scores(torch.from_numpy(q)), want, 1e-5, "ranking")


STEP_CASES = [(m, reg, ft) for m in ("complex", "analogy") for reg in ("n3", "f2")
              for ft in (False, True)] + [("cp", "n3", False), ("cp", "f2", False)]


@pytest.mark.parametrize("model, reg, finetune", STEP_CASES)
def test_training_step_matches_jax(model, reg, finetune):
    """One step at the reference init (1e-3): the loss (CE + regularizer)
    within 1e-5 relative, every gradient leaf within 1e-5 of its largest
    value. The optimizer is held on identical gradients in
    tests/test_torch_port_kge.py (an Adagrad step from two backends moves a
    cancellation-sized gradient by 2 lr where its sign differs)."""
    cols = 6 if finetune else 4
    jm, v, pm = _pair(model, cols=cols)
    cfg = dict(regularizer=reg, reg_weight=0.05, batch_size=32)
    jt = jrsme.RSMETrainer(jm, jrsme.RSMETrainConfig(**cfg), finetune=finetune)
    pt = prsme.RSMETrainer(pm, prsme.RSMETrainConfig(**cfg), finetune=finetune)
    batch = _queries(32, 5, cols=cols)
    if not finetune:
        batch[:, 1] %= R  # reciprocal rows are in the second half of rel
        batch = prsme.reciprocal_augment(batch, R)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, v.get("frozen", {}), jnp.asarray(batch, jnp.int32))))(v["params"])
    state = pt.init_state()
    ploss = pt.step(state, torch.from_numpy(batch))
    assert_rel(ploss, jloss, 1e-5, "loss")
    grads_match(jgrads, pm)
    assert state.step == 1 and isinstance(state.optimizer, torch.optim.Adagrad)


@pytest.fixture(scope="module")
def kg():
    """Triples with modes, split as the CLI splits them."""
    rng = np.random.default_rng(0)
    rows = set()
    while len(rows) < 300:
        rows.add((int(rng.integers(E)), int(rng.integers(R)), int(rng.integers(E))))
    triples = np.array(sorted(rows), np.int64)
    modes = prsme.assign_modes(len(triples), np.random.default_rng(1))
    np.testing.assert_array_equal(modes, jrsme.assign_modes(len(triples),
                                                            np.random.default_rng(1)))
    data4 = np.column_stack([triples, modes])
    aug = prsme.reciprocal_augment(data4, R)
    np.testing.assert_array_equal(aug, jrsme.reciprocal_augment(data4, R))
    skip = prsme.build_to_skip(aug[:, :3])
    assert skip == jrsme.build_to_skip(aug[:, :3])
    return data4[:60], {"rhs": skip["rhs"], "lhs": skip["rhs"]}


@pytest.mark.parametrize("model, gate, compat", [("complex", True, False),
                                                 ("analogy", True, True),
                                                 ("analogy", False, False)])
def test_filtered_ranks_equal_jax(kg, model, gate, compat):
    """filtered_eval on each side and eval_both_sides on converted weights:
    ranks exactly JAX's (ties counted against the gold, ``>=``)."""
    test, to_skip = kg
    jm, v, pm = _pair(model, gate, compat, init=0.1)
    assert_metrics_equal(prsme.eval_both_sides(pm, test, to_skip, R),
                         jrsme.eval_both_sides(jm, v, test, to_skip, R))
    for side in ("rhs", "lhs"):
        q = test.copy()
        if side == "lhs":
            q[:, [0, 2]] = q[:, [2, 0]]
            q[:, 1] += R
        for bs in (25, 500):
            np.testing.assert_array_equal(
                prsme.filtered_eval(pm, q, to_skip[side], batch_size=bs),
                jrsme.filtered_eval(jm, v, q, to_skip[side], batch_size=bs))


def test_filtered_eval_counts_ties_against_the_gold():
    """All-zero weights: every candidate ties the gold, so the rank is one
    plus the candidates that are not filtered (the ``>=`` convention)."""
    _, _, pm = _pair("complex", init=0.1)
    with torch.no_grad():
        for p in pm.parameters():
            p.zero_()
    q = np.array([[0, 1, 2, 0], [5, 2, 7, 0]], np.int64)
    ranks = prsme.filtered_eval(pm, q, {(0, 1): {2, 9, 11}})
    np.testing.assert_array_equal(ranks, [E - 2, E])


def test_cp_filtered_eval_runs():
    """The JAX filtered_eval reads ``model.cfg``, which CPModel lacks, so
    CP's evaluation raises there; the port ranks CP from its candidate row."""
    _, _, pm = _pair("cp", init=0.1)
    q = _queries(10, 6)
    q[:, 3] = 0
    ranks = prsme.filtered_eval(pm, q, {})
    with torch.no_grad():
        s = pm.ranking_scores(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(ranks, (s >= s[np.arange(10), q[:, 2]][:, None]).sum(1))


def test_rsme_buffers_round_trip_a_checkpoint(tmp_path):
    _, _, pm = _pair("analogy")
    assert set(dict(pm.named_buffers())) == {"img_vec", "rel_pd"}
    state = prsme.RSMETrainer(pm, prsme.RSMETrainConfig()).init_state()
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert in_opt == {id(p) for p in pm.parameters()}
    ckpt = checkpoint.Checkpointer(str(tmp_path))
    ckpt.save(1, pm.state_dict())
    ckpt.close()
    fresh = prsme.RSMEModel(pm.cfg)
    fresh.load_state_dict(checkpoint.load(str(tmp_path)), strict=True)
    for (n, a), b in zip(pm.state_dict().items(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
