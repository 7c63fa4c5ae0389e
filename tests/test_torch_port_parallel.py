"""Data and tensor parallelism of the port (core/mesh.py, parallel/) on the
CPU: gloo processes, one a rank, meeting through a file under the test's
``tmp_path`` (so that concurrent workers never share a port), one thread
each; each mesh runs its processes in one spawn.

- For the 2x1, 1x2 and 2x2 meshes: two fine-tune steps and two triple
  pre-train steps (the first at the warmup's learning rate 0, the second
  updating the parameters, gradients clipped to a global norm of 0.5), the
  MKGformer at tests/util.tiny_unimo_config, fp32, against the
  single-process port step and against JAX's ``MarTTrainer`` on a
  ``make_mesh`` of the same shape over the conftest's virtual devices;
  then the eval ranks. Bars: the losses and the gradient norm within 1e-5
  relative (the bar of one op: the same fp32 math summed in other orders),
  the updated parameters within 2e-4 absolute (the model bar; the updates
  are AdamW's, about 1e-3 each), the ranks identical. With dropout on (no
  JAX: its masks are jax.random's), the meshes against the port's own
  single process: the same masks, so the same bars, and the losses equal
  bit for bit where the mesh splits no sum (dp alone).
- The triple batch puts its two relation rows on one dp rank: the loss is
  the global-count mean (ops/losses.py), where a mean of the ranks' means
  is not.
- The tp-sharded ranking against ``ranks_from_scores`` on whole scores,
  with ties and a NaN gold.
- A checkpoint written under 1x2 restores under 1x1 and 2x2.
- With the fused Q/K/V projection (``fused_qkv``; JAX's ``USE_FUSED_QKV``,
  set inside the fixture and restored after it), the 1x2 and 2x2 meshes,
  dropout off: the ``qkv`` leaf whole on every tp rank, as JAX keeps it,
  each rank projecting its heads' rows; the steps and ranks against the
  fused single process and JAX's fused meshes at the same bars.

The meshes' processes run on a thread of this process while it computes the
single-process and the JAX steps. tests/test_torch_port_parallel_blocks.py
holds the sharding rules of the five families and ``dryrun_multichip``.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.core.mesh import AXES, axis_rank, make_mesh
from mkg_analogy_tpu_torch.models import unimo
from mkg_analogy_tpu_torch.models.common import DropoutRNG
from mkg_analogy_tpu_torch.ops.ranking import nonfinite_gold, ranks_from_scores, tie_counts
from mkg_analogy_tpu_torch.parallel.collectives import ShardedLogits
from mkg_analogy_tpu_torch.parallel.launch import spawn
from mkg_analogy_tpu_torch.train import checkpoint
from mkg_analogy_tpu_torch.train.optim import make_optimizer
from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig
from tests.util import make_tiny_dataset

# JAX is imported inside the fixtures and tests: the ranks' processes import
# this module to find their function, and need no JAX.

torch.set_num_threads(1)

SEQ, B, LR = 48, 4, 1e-3
MESHES = [(2, 1), (1, 2), (2, 2)]
FUSED_MESHES = [(1, 2), (2, 2)]  # fused_qkv under tp
# (dp, tp, fused_qkv) of the step and rank tests; the unfused cases keep the
# ids they had before the fused ones came
MESH_CASES = ([pytest.param(dp, tp, False, id=f"{dp}-{tp}") for dp, tp in MESHES]
              + [pytest.param(dp, tp, True, id=f"{dp}-{tp}-fused_qkv")
                 for dp, tp in FUSED_MESHES])
KINDS = ("finetune", "triple")
OPT = dict(lr=LR, total_steps=4, warmup_ratio=0.25, weight_decay=0.01, eps=1e-3,
           max_grad_norm=0.5)
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-4


def _trainer(inputs, kind, dropout, mesh=None, state="state", fused=False):
    """A port trainer on the inputs' weights: fp32, the tiny config with
    ``dropout`` as both rates (``fused``: one qkv projection a core, on the
    fused weights)."""
    text = dataclasses.replace(unimo.TextConfig(**inputs["text"]), hidden_dropout=dropout,
                               attention_dropout=dropout)
    cfg = unimo.UnimoConfig(text=text, vision=unimo.VisionConfig(**inputs["vision"]),
                            fusion_start=inputs["fusion_start"], dtype="float32",
                            fused_qkv=fused)
    model = unimo.UnimoForMaskedLM(cfg)
    model.load_state_dict(inputs["state_fused" if fused and state == "state" else state])
    tcfg = TrainConfig(lr=LR, batch_size=B, eval_batch_size=4, alpha=0.43,
                       pretrain=kind == "triple", track_grad_norm=True)
    return MarTTrainer(model, inputs["vocab"][kind], tcfg, device="cpu", mesh=mesh)


def _whole_grads(model):
    """Every parameter's gradient, whole (a tp rank's part gathered)."""
    from mkg_analogy_tpu_torch.parallel.collectives import shard_of, whole

    return {name: None if p.grad is None else whole(p.grad, shard_of(p)).clone()
            for name, p in model.named_parameters()}


def _steps(trainer, batch, kind):
    """Two train steps on ``batch``: (their losses, their grad norms, the
    whole parameters after them, the first step's whole gradients after
    the dp sum)."""
    trainer._parallelize()
    opt = make_optimizer(trainer.model, mesh=trainer.mesh, **OPT)
    grads, real_step = {}, opt.step

    def step():
        opt.sync_gradients()
        if not grads:
            grads.update(_whole_grads(trainer.model))
        return real_step()

    opt.step = step
    losses, norms = [], []
    for i in (0, 1):
        m = trainer._train_step(opt, trainer._put_batch(batch), i, loss_kind=kind)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.clone() for k, v in trainer.state_dict().items()}, grads


def _sharded_ranking(scores, labels, mesh):
    """ranks, ties and non-finite flags of ``scores`` split by columns over
    tp, interleaved (as the analogy entities' ids fall on the shards)."""
    tp_rank, tp = axis_rank(mesh, AXES.tp), mesh.mesh.shape[1]
    cols = torch.arange(scores.shape[1])[tp_rank::tp]
    sl = ShardedLogits(scores[:, cols], cols, scores.shape[1], mesh.get_group(AXES.tp))
    return ranks_from_scores(sl, labels), tie_counts(sl, labels), nonfinite_gold(sl, labels)


def _mesh_rank(rank, dp, tp, root, work, fused=False):
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    mesh = make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    out = {}
    if fused:  # dropout off: the steps and the ranks
        for kind in KINDS:
            out[kind, 0.0] = _steps(_trainer(inputs, kind, 0.0, mesh, fused=True),
                                    inputs["batch"][kind], kind)
            dump = os.path.join(work, f"ranks_{dp}x{tp}_{kind}.npz")
            out[kind, "eval"] = _trainer(inputs, kind, 0.0, mesh, fused=True).evaluate(
                inputs["eval"][kind], dump_path=dump)
        if rank == 0:
            torch.save(out, os.path.join(work, "result.pt"))
        return
    for kind in KINDS:
        for dropout in (0.0, 0.1):
            trainer = _trainer(inputs, kind, dropout, mesh)
            out[kind, dropout] = _steps(trainer, inputs["batch"][kind], kind)
        trainer = _trainer(inputs, kind, 0.0, mesh)
        dump = os.path.join(work, f"ranks_{dp}x{tp}_{kind}.npz")
        out[kind, "eval"] = trainer.evaluate(inputs["eval"][kind], dump_path=dump)
    if tp > 1:
        out["ranking"] = _sharded_ranking(inputs["scores"], inputs["labels"], mesh)
    name = f"{dp}x{tp}"
    if name == "1x2":
        ckpt = checkpoint.Checkpointer(inputs["ckpt_1x2"], mesh=mesh)
        ckpt.save(2, out["finetune", 0.0][2])
        ckpt.close()
    if name == "2x2" and os.path.isdir(inputs["ckpt_1x2"]):
        trainer = _trainer(inputs, "finetune", 0.0, mesh)
        trainer._parallelize()
        ckpt = checkpoint.Checkpointer(inputs["ckpt_1x2"], mesh=mesh)
        trainer.model.load_state_dict(ckpt.restore(model=trainer.model))
        ckpt.close()
        out["restored"] = trainer.state_dict()
    if rank == 0:
        torch.save(out, os.path.join(work, "result.pt"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny dataset, the JAX and port data modules of both formats, a
    Flax init of the tiny MKGformer carried into the port's names, the
    batches (the triple one with its relation rows last) and the eval
    features."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.data.module import KGCDataModule as JaxDataModule
    from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
    from mkg_analogy_tpu_torch.data.module import KGCDataModule
    from mkg_analogy_tpu_torch.models.convert import fuse_qkv, unimo_params_from_jax
    from tests.util import tiny_unimo_config

    root = tmp_path_factory.mktemp("port_parallel")
    markg_dir, mars_dir = make_tiny_dataset(str(root), n_analogy=40)
    data = {}
    for kind in KINDS:
        kw = dict(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=SEQ,
                  text_vocab_size=200, image_size=16, pretrain=kind == "triple")
        data[kind] = (JaxDataModule(**kw), KGCDataModule(**kw))
    cfg = tiny_unimo_config(vocab_size=256)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_dropout=0.0, attention_dropout=0.0))
    rng = np.random.default_rng(0)
    batch, evals = {}, {}
    for kind in KINDS:
        feats = data[kind][0].features("train")
        if kind == "triple":
            ent, rel = np.flatnonzero(feats["pre_type"] != 2), np.flatnonzero(feats["pre_type"] == 2)
            rows = np.concatenate([ent[:B // 2], rel[:B // 2]])
        else:
            rows = np.arange(B)
        batch[kind] = {k: v[rows] for k, v in feats.items()}
        batch[kind]["pixel_values"] = rng.standard_normal((B, 2, 3, 16, 16)).astype(np.float32)
        ev = data[kind][0].features("test" if kind == "finetune" else "train")
        ev = {k: v[:10] for k, v in ev.items()}
        ev["pixel_values"] = rng.standard_normal((10, 2, 3, 16, 16)).astype(np.float32)
        evals[kind] = ev
    sample = {k: jnp.asarray(v[:2]) for k, v in dict(
        input_ids=batch["finetune"]["input_ids"],
        attention_mask=batch["finetune"]["attention_mask"],
        token_type_ids=batch["finetune"]["token_type_ids"],
        pixel_values=batch["finetune"]["pixel_values"],
        positions=np.zeros((B, 5), np.int32), boundary=np.full((B,), 6, np.int32)).items()}
    flax_model = FlaxUnimo(cfg)
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(3), **sample,
                                            deterministic=True))
    scores = torch.from_numpy(rng.integers(-3, 4, (6, 20)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 20, 6))
    scores[1, labels[1]] = float("nan")
    scores[2, labels[2]] = float("inf")
    inputs = dict(
        text={f: getattr(cfg.text, f) for f in cfg.text.__dataclass_fields__},
        vision={f: getattr(cfg.vision, f) for f in cfg.vision.__dataclass_fields__},
        fusion_start=cfg.fusion_start, state=unimo_params_from_jax(params),
        state_fused=fuse_qkv(unimo_params_from_jax(params)),
        vocab={k: data[k][1].vocab for k in KINDS}, batch=batch, eval=evals,
        scores=scores, labels=labels, ckpt_1x2=str(root / "ckpt_1x2"))
    torch.save(inputs, root / "inputs.pt")
    return dict(root=root, inputs=inputs, data=data, flax_model=flax_model, params=params,
                params_fused=fuse_qkv(params))


@pytest.fixture(scope="module")
def single(setup):
    """The single-process port: each kind and dropout's steps, the eval."""
    inputs = setup["inputs"]
    out = {"init": inputs["state"], "init_fused": inputs["state_fused"]}
    for kind in KINDS:
        for dropout in (0.0, 0.1):
            out[kind, dropout] = _steps(_trainer(inputs, kind, dropout),
                                        inputs["batch"][kind], kind)
        out[kind, "fused"] = _steps(_trainer(inputs, kind, 0.0, fused=True),
                                    inputs["batch"][kind], kind)
        dump = str(setup["root"] / f"ranks_single_{kind}.npz")
        out[kind, "eval"] = _trainer(inputs, kind, 0.0).evaluate(inputs["eval"][kind],
                                                                  dump_path=dump)
        out[kind, "eval_fused"] = _trainer(inputs, kind, 0.0, fused=True).evaluate(
            inputs["eval"][kind],
            dump_path=str(setup["root"] / f"ranks_single_fused_{kind}.npz"))
    return out


def _mesh_dir(setup, dp, tp, fused=False):
    return setup["root"] / f"mesh_{dp}x{tp}{'_fused' if fused else ''}"


def _spawn_mesh(setup, dp, tp, fused=False):
    work = str(_mesh_dir(setup, dp, tp, fused))
    os.makedirs(work, exist_ok=True)
    spawn(_mesh_rank, ["cpu"] * (dp * tp), work,
          args=(dp, tp, str(setup["root"]), work, fused), threads=1)
    return torch.load(os.path.join(work, "result.pt"), weights_only=False)


class _Background:
    """The meshes' spawns on a thread of their own, while this process
    computes the single-process and the JAX steps: 1x2, 2x1 and the fused
    1x2 together, then 2x2, which restores 1x2's checkpoint, and the fused
    2x2."""

    def __init__(self, setup):
        self.results, self.errors = {}, []
        self.thread = threading.Thread(target=self._run, args=(setup,))
        self.thread.start()

    def _run(self, setup):
        try:
            for wave in (((1, 2), (2, 1), (1, 2, True)), ((2, 2), (2, 2, True))):
                threads = [threading.Thread(target=self._one, args=(setup, m)) for m in wave]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        except BaseException as e:  # surfaced in the tests
            self.errors.append(e)

    def _one(self, setup, mesh):
        try:
            self.results[mesh] = _spawn_mesh(setup, *mesh)
        except BaseException as e:
            self.errors.append(e)

    def __getitem__(self, mesh):
        self.thread.join()
        if self.errors:
            raise self.errors[0]
        return self.results[mesh]


@pytest.fixture(scope="module")
def mesh_runs(setup):
    """Each mesh's results, by (dp, tp) or (dp, tp, True) for fused_qkv
    (started first, read when a test needs them)."""
    runs = _Background(setup)
    yield runs
    runs.thread.join()


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's MarTTrainer on a make_mesh of each shape: the two steps of each
    kind (dropout 0) and the eval ranks; by (dp, tp, kind), and by (dp, tp,
    kind, True) with ``USE_FUSED_QKV`` on (set for those runs, restored after
    them) from the fused weights."""
    import jax
    from mkg_analogy_tpu.models import common as jcommon

    out = {}
    for dp, tp in MESHES:
        out.update(_jax_mesh_runs(setup, dp, tp, setup["params"]))
    saved = jcommon.USE_FUSED_QKV
    jcommon.USE_FUSED_QKV = True
    try:
        for dp, tp in FUSED_MESHES:
            jax.clear_caches()  # the flag is read while tracing
            out.update({k + (True,): v for k, v in _jax_mesh_runs(
                setup, dp, tp, setup["params_fused"], tag="_fused").items()})
    finally:
        jcommon.USE_FUSED_QKV = saved
        jax.clear_caches()
    return out


def _jax_mesh_runs(setup, dp, tp, init_params, tag=""):
    """{(dp, tp, kind): (losses, grad norms, updated params in the port's
    names, eval ranks)} of JAX's trainer on a (dp, tp) mesh."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.core.mesh import make_mesh as jax_mesh
    from mkg_analogy_tpu.parallel.shardings import make_shardings, shard_params_spec
    from mkg_analogy_tpu.train import optim as joptim
    from mkg_analogy_tpu.train import trainer as jtrainer
    from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax

    out = {}
    inputs = setup["inputs"]
    mesh = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    for kind in KINDS:
        jdata = setup["data"][kind][0]
        jt = jtrainer.MarTTrainer(
            setup["flax_model"], jdata.vocab,
            jtrainer.TrainConfig(lr=LR, batch_size=B, eval_batch_size=4, alpha=0.43,
                                 pretrain=kind == "triple", track_grad_norm=True),
            mesh=mesh)
        opt = {k: v for k, v in OPT.items() if k != "lr"}
        tx = joptim.make_optimizer(LR, **opt)
        with mesh:
            params = jax.device_put(init_params, make_shardings(
                mesh, shard_params_spec(init_params)))
            state = jtrainer.TrainState.create(apply_fn=setup["flax_model"].apply,
                                               params=params, tx=tx)
            step = jax.jit(jt._train_step)
            dbatch = jt._put_batch(inputs["batch"][kind])
            like = (state.params, state.opt_state)
            losses, norms = [], []
            for i in (0, 1):
                if i:  # the first call's placement, so that no second compile runs
                    params, opt_state = jax.tree.map(
                        lambda x, x0: jax.device_put(x, x0.sharding) if x0.committed
                        else jnp.asarray(np.asarray(x)), (state.params, state.opt_state),
                        like)
                    state = state.replace(step=i, params=params, opt_state=opt_state)
                state, m = step(state, dbatch, jax.random.PRNGKey(1))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        dump = str(setup["root"] / f"ranks_jax_{dp}x{tp}{tag}_{kind}.npz")
        jt.evaluate(init_params, inputs["eval"][kind], dump_path=dump)
        out[dp, tp, kind] = (losses, norms,
                             unimo_params_from_jax(jax.device_get(state.params)),
                             np.load(dump)["ranks"])
    return out


def _close(got, want, rtol, what):
    for g, w in zip(got, want):
        assert abs(g - w) <= rtol * abs(w), (what, got, want)


def _params_close(got, want, what):
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= PARAM_ATOL, (what, name, err)


def _grads_close(got, want, what):
    """Each leaf within 1e-4 of its largest |gradient| plus 1e-7 of the
    model's largest (tests/test_torch_port_train.py's bar; the floor covers
    the key biases, whose exact gradient is 0); a leaf the loss does not
    reach has no gradient, or zeros where the dp sum gave it some."""
    top = max(float(w.abs().max()) for w in want.values() if w is not None)
    for name, w in want.items():
        if w is None or got[name] is None:
            other = got[name] if w is None else w
            assert other is None or not other.any(), (what, name)
            continue
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7 * top, (what, name, err)


@pytest.mark.parametrize("dp,tp,fused", MESH_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_steps_match_single_process_and_jax(mesh_runs, single, jax_runs, dp, tp, fused, kind):
    """Dropout off: the mesh's two steps against the single-process port and
    against JAX on a mesh of the same shape (losses, grad norms, updated
    parameters; the first step's gradients, leaf by leaf, against the single
    process), and the parameters did move; with ``fused_qkv``, the fused
    single process and JAX's fused mesh, the qkv leaf whole on the ranks."""
    key = (dp, tp, True) if fused else (dp, tp)
    losses, norms, state, grads = mesh_runs[key][kind, 0.0]
    s_losses, s_norms, s_state, s_grads = single[kind, "fused" if fused else 0.0]
    j_losses, j_norms, j_state, _ = jax_runs[(dp, tp, kind) + ((True,) if fused else ())]
    if fused:
        assert any(".attn.qkv." in name for name in state)
    _grads_close(grads, s_grads, "vs single")
    _close(losses, s_losses, LOSS_RTOL, "loss vs single")
    _close(norms, s_norms, LOSS_RTOL, "grad norm vs single")
    _close(losses, j_losses, LOSS_RTOL, "loss vs jax")
    _close(norms, j_norms, LOSS_RTOL, "grad norm vs jax")
    _params_close(state, s_state, "vs single")
    _params_close(state, j_state, "vs jax")
    init = single["init_fused" if fused else "init"]
    moved = max(float((state[k] - v).abs().max()) for k, v in init.items())
    assert moved > 1e-4


@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_dropout_on_matches_single_process(mesh_runs, single, dp, tp, kind):
    """Dropout 0.1 (hidden and attention): the masks are the global batch
    row's and head's, so the mesh's steps are the single process's at the
    bars above; under dp alone, where no sum is split in the forward, the
    losses are equal bit for bit."""
    losses, norms, state, grads = mesh_runs[dp, tp][kind, 0.1]
    s_losses, s_norms, s_state, s_grads = single[kind, 0.1]
    _grads_close(grads, s_grads, "dropout on")
    assert s_losses != list(single[kind, 0.0][0])  # dropout changed the loss
    _close(losses, s_losses, LOSS_RTOL, "loss")
    _close(norms, s_norms, LOSS_RTOL, "grad norm")
    _params_close(state, s_state, "dropout on")
    if tp == 1:
        assert losses[0] == s_losses[0]


@pytest.mark.parametrize("dp,tp,fused", MESH_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_eval_ranks_match_single_process_and_jax(setup, mesh_runs, single, jax_runs,
                                                 dp, tp, fused, kind):
    """The padded eval batches split over dp, the decoder over tp: the ranks
    are the single process's and JAX's, and so are the metrics (with
    ``fused_qkv``, the fused ones')."""
    root = setup["root"]
    got = np.load(_mesh_dir(setup, dp, tp, fused) / f"ranks_{dp}x{tp}_{kind}.npz")["ranks"]
    want = np.load(root / f"ranks_single{'_fused' if fused else ''}_{kind}.npz")["ranks"]
    assert len(got) == 10
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_runs[(dp, tp, kind) + ((True,) if fused else ())][3])
    key = (dp, tp, True) if fused else (dp, tp)
    assert mesh_runs[key][kind, "eval"] == single[kind, "eval_fused" if fused else "eval"]


def test_global_count_ce_with_the_relation_rows_on_one_rank(setup, mesh_runs, single):
    """The triple batch's two relation rows both sit on dp rank 1: each
    rank's loss is its rows' sum over the global count, and the mesh's loss
    is the single process's; the mean of the two ranks' own means is not."""
    inputs = setup["inputs"]
    batch = inputs["batch"]["triple"]
    assert batch["pre_type"][:B // 2].tolist() == [1] * (B // 2)
    assert (batch["pre_type"][B // 2:] == 2).all()
    halves = []
    for rows in (slice(0, B // 2), slice(B // 2, B)):
        trainer = _trainer(inputs, "triple", 0.0)
        loss, _ = trainer._pretrain_loss(
            trainer._put_batch({k: v[rows] for k, v in batch.items()}),
            DropoutRNG.from_seed(0, "cpu"))
        halves.append(loss.item())
    want = single["triple", 0.0][0][0]
    assert abs(sum(halves) / 2 - want) > 1e-3
    for dp, tp in ((2, 1), (2, 2)):
        _close(mesh_runs[dp, tp]["triple", 0.0][0], single["triple", 0.0][0], LOSS_RTOL,
               f"{dp}x{tp}")


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_tp_sharded_ranking_matches_whole_scores(setup, mesh_runs, dp, tp):
    """Columns interleaved over tp, integer-valued scores (many ties), a NaN
    and an infinite gold: ranks, tie counts and the non-finite flags of the
    whole scores."""
    scores, labels = setup["inputs"]["scores"], setup["inputs"]["labels"]
    ranks, ties, nonfinite = mesh_runs[dp, tp]["ranking"]
    assert torch.equal(ranks, ranks_from_scores(scores, labels))
    assert torch.equal(ties, tie_counts(scores, labels))
    assert torch.equal(nonfinite, nonfinite_gold(scores, labels))
    assert ranks[1] == ranks[2] == scores.shape[1] and (ties > 1).any()


def test_checkpoint_written_under_1x2_restores_under_1x1_and_2x2(setup, mesh_runs):
    """Whole tensors on disk: under 1x1 the state is the one 1x2 gathered
    and saved, and 2x2 restores it onto its own parts and gathers it back
    unchanged."""
    saved = mesh_runs[1, 2]["finetune", 0.0][2]
    on_disk = checkpoint.load(setup["inputs"]["ckpt_1x2"])
    assert set(on_disk) == set(saved)
    for k, v in saved.items():
        assert torch.equal(on_disk[k], v), k
    model = _trainer(setup["inputs"], "finetune", 0.0).model
    model.load_state_dict(on_disk)  # the 1x1 mesh: the whole model
    restored = mesh_runs[2, 2]["restored"]
    for k, v in saved.items():
        assert torch.equal(restored[k], v), k
