"""``MarTTrainer._prefetch``, the JAX trainer's input pipeline
(mkg_analogy_tpu/train/trainer.py:374-400), on the CPU: ``fit`` through it
takes the batches, and gives the losses, of the loop it replaced (each batch
assembled and copied on the loop's thread), fine-tune and mixed diet, with
and without a ``limit_train_batches`` break; a worker's error is raised in
the loop; no worker outlives its loop. The tiny model of the other tests
(MKGformer, 2 layers of width 32, fp32, dropout on). One ``cuda`` test holds
the pinned, side-stream copy to the blocking one on the card."""

import threading

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.data.module import KGCDataModule
from mkg_analogy_tpu_torch.models.registry import create_model
from mkg_analogy_tpu_torch.train.optim import make_optimizer
from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

torch.set_num_threads(1)


def prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "mkg-prefetch" and t.is_alive()]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # imported here: the card runs the `cuda` test without tests/conftest.py,
    # which puts the repository root on the path
    from tests.util import make_tiny_dataset

    markg_dir, mars_dir = make_tiny_dataset(str(tmp_path_factory.mktemp("port_prefetch_kg")))
    kw = dict(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=48,
              text_vocab_size=256, image_size=16)
    return KGCDataModule(**kw), KGCDataModule(pretrain=True, seed=3, **kw)


def make_trainer(module, device="cpu", **flags):
    """A trainer of the tiny model from seed 0, with a zero image table."""
    model = create_model("MKGformerKGC", vocab_size=module.vocab.padded_vocab_size,
                         dtype="float32", attention="plain", hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64)
    model.to(device)
    trainer = MarTTrainer(model, module.vocab, TrainConfig(check_val_every_n_epoch=100,
                                                           **flags), device=device)
    trainer.init_params(0)
    trainer.set_image_table(np.zeros((module.markg.num_entities + 1, 3, 224, 224), np.float32))
    return trainer


def train_features(module, mixed):
    if mixed:
        return module.features("train", fmt="triple"), module.features("train", fmt="analogy")
    return module.features("train")


def legacy_fit(trainer, features):
    """The loop ``fit`` ran before ``_prefetch`` (evaluation left out): each
    batch assembled by the epoch generator on this thread, copied with
    ``_put_batch``, then stepped. Returns (kind, input ids, loss) a step."""
    cfg = trainer.config
    steps_per_epoch, epoch_batches = trainer._epoch_schedule(features)
    limit = cfg.limit_train_batches
    if limit:
        steps_per_epoch = min(steps_per_epoch, limit)
    optimizer = make_optimizer(trainer.model, cfg.lr, steps_per_epoch * cfg.max_epochs,
                               cfg.warmup_ratio, cfg.weight_decay)
    optimizer.zero_grad()
    steps, global_step = [], 0
    for _ in range(cfg.max_epochs):
        for epoch_steps, (kind, batch) in enumerate(epoch_batches()):
            if limit and epoch_steps >= limit:
                break
            batch.pop("valid")
            dbatch = trainer._put_batch(batch)
            metrics = trainer._train_step(optimizer, dbatch, global_step, trainer.image_table,
                                          loss_kind=kind)
            steps.append((kind, dbatch["input_ids"].numpy().tobytes(), metrics["loss"].item()))
            global_step += 1
    return steps


def recorded_fit(trainer, features, monkeypatch):
    """``fit`` with its steps recorded as (kind, input ids, loss)."""
    steps = []
    real = trainer._train_step

    def step(optimizer, batch, global_step, image_table=None, loss_kind=None):
        metrics = real(optimizer, batch, global_step, image_table, loss_kind=loss_kind)
        steps.append((loss_kind, batch["input_ids"].numpy().tobytes(), metrics["loss"].item()))
        return metrics

    monkeypatch.setattr(trainer, "_train_step", step)
    n, _ = trainer.fit(features, None)
    assert n == len(steps)
    return steps


@pytest.mark.parametrize("mixed, limit", [(False, None), (False, 2), (True, None), (True, 1)])
def test_fit_takes_the_old_loops_batches_and_losses(data, monkeypatch, mixed, limit):
    """Two epochs through ``_prefetch`` against the old loop from the same
    weights: the same batches in the same order, each step's loss equal
    bit for bit. The mixed diet interleaves triple and analogy batches in
    a seeded order; under the limit the worker reads the one batch past it
    that the old loop read, so the next epoch's draws are the same (at
    seed 5 the batch past a limit of 1 is the epoch's first analogy batch,
    whose read draws that iterator's order: without it the second epoch's
    first batch would differ)."""
    finetune, pretrain = data
    module = pretrain if mixed else finetune
    flags = dict(max_epochs=2, batch_size=8 if mixed else 4, lr=1e-3, seed=5,
                 limit_train_batches=limit)
    if mixed:
        flags.update(pretrain=True, analogy_pretrain=True, mixed_pretrain=True)
    feats = train_features(module, mixed)
    want = legacy_fit(make_trainer(module, **flags), feats)
    got = recorded_fit(make_trainer(module, **flags), feats, monkeypatch)
    assert len(got) == len(want) == 2 * (limit or len(want) // 2)
    assert [s[:2] for s in got] == [s[:2] for s in want]
    assert [s[2] for s in got] == [s[2] for s in want]
    if mixed:
        assert {s[0] for s in got} == {"triple", "finetune"}
    assert not prefetch_threads()


def test_a_worker_error_is_raised_in_the_loop(data, monkeypatch):
    """A batch that fails to assemble on the worker fails ``fit`` with that
    error, after the steps before it, and leaves no worker behind."""
    finetune, _ = data
    trainer = make_trainer(finetune, max_epochs=1, batch_size=4)
    calls = []
    real = trainer._put_batch_async

    def put(batch):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("batch 3 cannot be assembled")
        return real(batch)

    monkeypatch.setattr(trainer, "_put_batch_async", put)
    with pytest.raises(ValueError, match="batch 3 cannot be assembled"):
        trainer.fit(finetune.features("train"), None)
    assert not prefetch_threads()


def test_prefetch_order_lookahead_close_and_errors():
    """The generic ``_prefetch``: items in order, the worker at most
    ``lookahead`` + 1 items ahead of the loop (two queued, one waiting to be
    queued); closing it early stops and joins the worker and closes the
    source; an error of the source is raised after the items before it."""
    trainer = MarTTrainer.__new__(MarTTrainer)
    made, closed = [], []

    def source(n, fail_at=None):
        try:
            for i in range(n):
                if i == fail_at:
                    raise KeyError(i)
                made.append(i)
                yield i
        finally:
            closed.append(n)

    out = []
    for item in trainer._prefetch(source(10), lambda i: i * 10, lookahead=2):
        assert len(made) <= len(out) + 1 + 3
        out.append(item)
    assert out == [i * 10 for i in range(10)] and not prefetch_threads()

    made.clear()
    gen = trainer._prefetch(source(100), lambda i: i, lookahead=2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    assert not prefetch_threads() and closed[-1] == 100 and len(made) <= 3 + 3

    got = []
    with pytest.raises(KeyError):
        for item in trainer._prefetch(source(10, fail_at=4), lambda i: i, lookahead=2):
            got.append(item)
    assert got == [0, 1, 2, 3] and not prefetch_threads()


def test_evaluate_leaves_no_worker(data):
    finetune, _ = data
    trainer = make_trainer(finetune, eval_batch_size=4)
    metrics = trainer.evaluate(finetune.features("test"))
    assert 0.0 < metrics["Eval_entity/mrr"] <= 1.0 and not prefetch_threads()


@pytest.mark.cuda
def test_pinned_side_stream_copy_equals_the_blocking_copy():
    """On the card: a batch staged by ``_put_batch_async`` (pinned memory,
    the side stream, an event) equals ``_put_batch``'s, fp32 arrays rounded
    to bf16 the same way, once the current stream has waited on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream copy has no CPU mode")
    trainer = MarTTrainer.__new__(MarTTrainer)
    trainer.device, trainer._copy_stream = torch.device("cuda"), None
    rng = np.random.default_rng(0)
    batch = dict(ids=rng.integers(0, 1000, (32, 128)).astype(np.int32),
                 pixels=rng.standard_normal((32, 3, 64, 64)).astype(np.float32),
                 flag=rng.random(32) > 0.5)
    for _ in range(4):
        staged = trainer._ready(trainer._put_batch_async(batch))
        want = trainer._put_batch(batch)
        assert set(staged) == set(want)
        for k in want:
            assert staged[k].dtype == want[k].dtype and torch.equal(staged[k], want[k]), k
