"""The port's IKRL / TransAE models against the Flax modules on converted
weights, on the CPU: per-row energies in every task mode, candidate energies
on both corrupt sides, fine-tune scores, ANALOGY's regularization, one
pre-train step (margin, softplus, the reference's softplus sign, regul)
with the task modes JAX draws injected, one fine-tune step, the task-mode
law, and the frozen tables as buffers through a checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.kge import ikrl as jikrl
from mkg_analogy_tpu.kge import sampling as jsampling
from mkg_analogy_tpu.kge import trainer as jtrainer
from mkg_analogy_tpu.kge import transae as jtransae
from mkg_analogy_tpu_torch.kge import ikrl as pikrl
from mkg_analogy_tpu_torch.kge import trainer as ptrainer
from mkg_analogy_tpu_torch.kge import transae as ptransae
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.train import checkpoint
from tests.test_torch_port_kge import _triples, assert_rel, grads_match, t

torch.set_num_threads(1)

E, R, DIM, VIS = 64, 6, 16, 32


@pytest.fixture(autouse=True)
def _threefry():
    """Pin JAX's PRNG implementation to its default: the JAX CLI sets a
    process-wide ``jax_default_prng_impl`` (``--prng``, default unsafe_rbg),
    so a CLI test run earlier in the same worker would change the task modes
    drawn below (tests/test_quirks.py pins it likewise)."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


# ------------------------------------------------------------------ models
def _visual(seed=0):
    return np.random.default_rng(seed).standard_normal((E + 1, VIS)).astype(np.float32)


def _jax_and_port(kind):
    """(JAX module, its variables as numpy, port module on the same
    weights) for "transe", "analogy" or "transae"."""
    vis = _visual()
    if kind == "transae":
        text = np.random.default_rng(1).standard_normal((E + 1, 8)).astype(np.float32)
        kw = dict(dim=DIM, text_dim=8, visual_dim=VIS, visual_hidden=12)
        jm = jtransae.TransAETransE(jtransae.TransAEConfig(E, R, **kw), text, vis)
        pm = ptransae.TransAETransE(ptransae.TransAEConfig(E, R, **kw), text, vis)
    else:
        kw = dict(dim=DIM, visual_dim=VIS, scorer=kind)
        jm = jikrl.create_ikrl(jikrl.IKRLConfig(E, R, **kw), vis)
        pm = pikrl.create_ikrl(pikrl.IKRLConfig(E, R, **kw), vis)
    z = jnp.zeros((4,), jnp.int32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), z, z, z, z))
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return jm, variables, pm


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, E, n), rng.integers(0, E, n), rng.integers(0, R, n),
            rng.integers(0, 3, n))


KINDS = ["transe", "analogy", "transae"]


@pytest.mark.parametrize("kind", KINDS)
def test_model_outputs_match_jax(kind):
    """Per-row energies in all three task modes, candidate energies on both
    corrupt sides, fine-tune scores and (ANALOGY) the regularization term:
    1e-5 of each output's largest value."""
    jm, v, pm = _jax_and_port(kind)
    h, tl, r, tm = _rows(30, 2)
    J = [jnp.asarray(x) for x in (h, tl, r, tm)]
    P = [t(x) for x in (h, tl, r, tm)]

    def jit(method, **static):
        return jax.jit(lambda *a: jm.apply(v, *a, method=method, **static))

    forward = jit(None)
    with torch.no_grad():
        for mode in (0, 1, 2):
            jmode = jnp.full_like(J[3], mode)
            assert_rel(pm(*P[:3], torch.full_like(P[3], mode)),
                       forward(*J[:3], jmode), 1e-5, f"mode {mode}")
        assert_rel(pm(*P), forward(*J), 1e-5, "mixed modes")
        for corrupt in ("tail", "head"):
            want = jit(type(jm).candidate_energies, corrupt=corrupt)(J[0][:9], J[2][:9],
                                                                     J[3][:9])
            got = pm.candidate_energies(P[0][:9], P[2][:9], P[3][:9], corrupt)
            assert_rel(got, want, 1e-5, f"candidate_energies {corrupt}")
        want = jit(type(jm).finetune_scores)(J[0], J[1], J[0][::-1], J[3])
        got = pm.finetune_scores(P[0], P[1], P[0].flip(0), P[3])
        assert_rel(got, want, 1e-5, "finetune_scores")
        if kind == "analogy":
            want = jit(type(jm).regularization)(*J[:3])
            assert_rel(pm.regularization(*P[:3]), want, 1e-5, "regularization")


PRETRAIN_CASES = [("transe", "margin", False, 0.0), ("analogy", "softplus", False, 1.0),
                  ("analogy", "softplus", True, 1.0), ("transae", "margin", False, 0.0)]


@pytest.mark.parametrize("kind, loss, compat, regul", PRETRAIN_CASES)
def test_pretrain_step_matches_jax(kind, loss, compat, regul):
    """One pre-train step on a NegativeSampler batch, the task modes JAX
    draws for it injected into the port: the loss within 1e-5 relative,
    every gradient leaf within 1e-5 of its largest value; then the port's
    SGD update is the step the gradients give."""
    jm, v, pm = _jax_and_port(kind)
    rows, _, _ = _triples(seed=4, n=80, n_ent=E, n_rel=R)
    store = jsampling.TripleStore.from_arrays(rows, E, R)
    bs, neg_ent, neg_rel = 8, 3, 2
    batch = next(iter(jsampling.NegativeSampler(store, batch_size=bs, neg_ent=neg_ent,
                                                neg_rel=neg_rel, seed=1)))
    kw = dict(loss=loss, compat_ref_softplus_sign=compat, regul_rate=regul, margin=5.0)
    jt = jtrainer.KGETrainer(jm, jtrainer.KGETrainConfig(**kw), bs, neg_ent + neg_rel)
    pt = ptrainer.KGETrainer(pm, ptrainer.KGETrainConfig(**kw), bs, neg_ent + neg_rel)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("batch_h", "batch_t", "batch_r")}
    rng = jax.random.PRNGKey(3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt._pretrain_loss(p, v.get("frozen", {}), jbatch, rng)))(v["params"])
    task_mode = t(jtrainer.draw_task_mode(rng, len(batch["batch_h"])), np.int64)
    assert set(task_mode.tolist()) == {0, 1, 2}
    # TransAE adds one scalar (the reconstruction loss) to the image-mode
    # rows, so its decoders' gradient is that scalar's coefficient in the
    # margin loss: (5 * image positives - image negatives) / 40. Where the
    # draw makes it 0, both gradients are summation-order noise of ~1e-9
    # that no bar can hold; this draw gives 8.
    img = (task_mode != 0).numpy()
    assert (neg_ent + neg_rel) * img[:bs].sum() - img[bs:].sum() == 8
    pbatch = pt.device_batch(batch, "cpu")
    state = pt.init_state()
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    ploss = pt.pretrain_step(state, pbatch, task_mode)
    assert_rel(ploss, jloss, 1e-5, "loss")
    grads_match(jgrads, pm)
    for n, p in pm.named_parameters():  # SGD, lr 1
        torch.testing.assert_close(p.detach(), before[n] - p.grad, rtol=0, atol=1e-6)
    assert state.step == 1


@pytest.mark.parametrize("kind", KINDS)
def test_finetune_step_matches_jax(kind):
    """One fine-tune step (log-softmax CE over the fine-tune scores): loss
    within 1e-5 relative, every gradient leaf within 1e-5 of its largest
    value."""
    jm, v, pm = _jax_and_port(kind)
    rng = np.random.default_rng(3)
    rows = np.stack([rng.integers(0, E, 12), rng.integers(0, E, 12), rng.integers(0, E, 12),
                     rng.integers(0, E, 12), rng.integers(0, R, 12),
                     np.arange(12) % 3], axis=1)
    cfg = dict(finetune_batch_size=12)
    jt = jtrainer.KGETrainer(jm, jtrainer.KGETrainConfig(**cfg), 4, 5)
    pt = ptrainer.KGETrainer(pm, ptrainer.KGETrainConfig(**cfg), 4, 5)
    jb = dict(e_head=rows[:, 0], e_tail=rows[:, 1], q_head=rows[:, 2], q_tail=rows[:, 3],
              task_mode=rows[:, 5])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt._finetune_loss(p, v.get("frozen", {}),
                                    {k: jnp.asarray(x) for k, x in jb.items()}),
        has_aux=True))(v["params"])
    state = pt.init_state(finetune=True)
    ploss = pt.finetune_step(state, pt.tuple_batch(rows, "cpu"))
    assert_rel(ploss, jloss, 1e-5, "loss")
    grads_match(jgrads, pm)
    assert isinstance(state.optimizer, torch.optim.Adam)


def test_draw_task_mode_is_0_4_0_3_0_3():
    """Chi-square of 60,000 draws against 0.4 / 0.3 / 0.3 (p > 0.001)."""
    from scipy.stats import chisquare

    modes = ptrainer.draw_task_mode(torch.Generator().manual_seed(0), 60000)
    counts = np.bincount(modes.numpy(), minlength=3)
    assert counts.sum() == 60000 and len(counts) == 3
    assert chisquare(counts, np.array([0.4, 0.3, 0.3]) * 60000).pvalue > 1e-3


def test_frozen_tables_are_buffers_and_round_trip_a_checkpoint(tmp_path):
    """The feature tables never reach the optimizer; a state dict written by
    the port's Checkpointer restores with strict=True, buffers included."""
    for kind in KINDS:
        _, _, pm = _jax_and_port(kind)
        buffers = dict(pm.named_buffers())
        assert buffers and all("features" in n for n in buffers)
        state = ptrainer.KGETrainer(pm, ptrainer.KGETrainConfig(), 4, 5).init_state()
        in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
        assert not in_opt & {id(b) for b in buffers.values()}
        assert in_opt == {id(p) for p in pm.parameters()}
        ckpt = checkpoint.Checkpointer(str(tmp_path / kind))
        ckpt.save(3, pm.state_dict())
        ckpt.close()
        fresh = _jax_and_port(kind)[2]
        for p in list(fresh.parameters()) + list(fresh.buffers()):
            torch.nn.init.zeros_(p.data)
        fresh.load_state_dict(checkpoint.load(str(tmp_path / kind)), strict=True)
        for (n, a), b in zip(pm.state_dict().items(), fresh.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
