"""Multi-process dry run of the training path (``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n_devices)`` runs, on a (dp, tp) mesh of ``n_devices``
processes (tp = 2 where n >= 4 and even, dp the rest): one fine-tune train
step of the flagship topology (12 lockstep layers, cross-modal flow from
layer 8) at tiny widths, or at full width with ``full_width=True``; the
eval loop; and a checkpoint save -> restore under the same mesh, checked
leaf for leaf. Rank 0 prints the final line, which names dp, tp, the loss
and the MRR.

``device="cuda"`` (the default) puts rank r on visible GPU r mod the GPU
count (gloo where ranks share a card, NCCL where each has its own) and
raises where PyTorch sees no GPU; ``device="cpu"`` runs the ranks on the
CPU (gloo), any count.

    python -c "from mkg_analogy_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
    python -c "from mkg_analogy_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .launch import spawn


def synthetic_batch(batch_size: int, seq_len: int, vocab_size: int, image_size: int,
                    n_analogy: int, seed: int = 0):
    """A seeded fine-tune batch (``__graft_entry__._synthetic_batch``)."""
    rng = np.random.default_rng(seed)
    length = seq_len
    sep = np.sort(rng.integers(4, length - 2, size=(batch_size, 6)), axis=1)
    return dict(
        input_ids=rng.integers(5, vocab_size - 1, size=(batch_size, length)).astype(np.int32),
        attention_mask=np.ones((batch_size, length), np.int32),
        token_type_ids=np.zeros((batch_size, length), np.int32),
        pixel_values=rng.standard_normal(
            (batch_size, 2, 3, image_size, image_size)).astype(np.float32),
        label=rng.integers(0, n_analogy, size=(batch_size,)).astype(np.int32),
        sep_idx=sep.astype(np.int32),
        rel_idx=np.stack([sep[:, 0] - 1, sep[:, 3] - 1], axis=1).astype(np.int32),
        q_head_idx=np.ones((batch_size,), np.int32),
        a_head_idx=(sep[:, 2] + 1).astype(np.int32),
        mask_idx=(sep[:, 5] - 1).astype(np.int32),
    )


class _FakeVocab:
    """The id layout of the dry run's vocabulary (tiny, or the full MarKG
    one at full width)."""

    def __init__(self, full_width: bool, n_analogy: int, vocab_size: int):
        if full_width:
            self.analogy_entity_ids = np.arange(2063, dtype=np.int32) + 8192
            self.analogy_relation_ids = np.arange(27, dtype=np.int32) + 19484
            self.r_token_id = 19676
            self.entity_id_st, self.entity_id_ed = 8192, 19484
            self.relation_id_st, self.relation_id_ed = 19484, 19676
        else:
            self.analogy_entity_ids = np.arange(n_analogy, dtype=np.int32) + 100
            self.analogy_relation_ids = np.arange(8, dtype=np.int32) + 400
            self.r_token_id = 450
            self.entity_id_st, self.entity_id_ed = 100, 400
            self.relation_id_st, self.relation_id_ed = 400, 440
        self.padded_vocab_size = vocab_size


def _rank(rank: int, dp: int, tp: int, full_width: bool, devices, out_dir: str) -> None:
    from ..core.mesh import make_mesh
    from ..models.unimo import TextConfig, UnimoConfig, UnimoForMaskedLM, VisionConfig
    from ..train.checkpoint import Checkpointer
    from ..train.optim import make_optimizer
    from ..train.trainer import MarTTrainer, TrainConfig

    device = torch.device(devices[rank])
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    if full_width:
        vocab_size, n_analogy, batch_size, seq, img = 19712, 2063, 32, 128, 224
        cfg = UnimoConfig(text=TextConfig(vocab_size=vocab_size),
                          dtype="bfloat16" if device.type == "cuda" else "float32")
    else:
        vocab_size, n_analogy, batch_size, seq, img = 512, 32, dp * 2, 32, 16
        small = dict(hidden_size=64, num_layers=12, num_heads=4, intermediate_size=128)
        cfg = UnimoConfig(
            text=TextConfig(vocab_size=vocab_size, max_position_embeddings=64, **small),
            vision=VisionConfig(image_size=16, patch_size=8, **small),
            fusion_start=8, dtype="float32", attention="plain")
    with torch.device(device):
        model = UnimoForMaskedLM(cfg)
    tcfg = TrainConfig(lr=1e-3, batch_size=batch_size, max_epochs=1,
                       eval_batch_size=batch_size)
    trainer = MarTTrainer(model, _FakeVocab(full_width, n_analogy, vocab_size), tcfg,
                          device=device, mesh=mesh)
    trainer.init_params(0)
    trainer._parallelize()
    optimizer = make_optimizer(model, tcfg.lr, 10, mesh=mesh)
    batch = synthetic_batch(batch_size, seq, vocab_size, img, n_analogy)
    metrics = trainer._train_step(optimizer, trainer._put_batch(batch), 0)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"rank {rank}: loss {loss}")

    # the eval loop under the same mesh
    feats = dict(batch, valid=np.ones((batch_size,), bool))
    eval_metrics = trainer.evaluate(feats)
    if not np.isfinite(eval_metrics["Eval_entity/mrr"]):
        raise RuntimeError(f"rank {rank}: {eval_metrics}")

    # checkpoint save -> restore of the split parameters, under the same mesh
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"), mesh=mesh)
    ckpt.save(1, trainer.state_dict(), metrics=eval_metrics)
    restored = ckpt.restore(step=1, model=model)
    ckpt.close()
    for name, value in model.state_dict().items():
        if not torch.equal(restored[name].to(value.device), value):
            raise RuntimeError(f"rank {rank}: {name} differs after the round trip")
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump({"loss": loss, "eval_mrr": eval_metrics["Eval_entity/mrr"]}, f)


def dryrun_multichip(n_devices: int, full_width: bool = False, device: str = "cuda") -> dict:
    """One train step, the eval loop and a checkpoint round trip on a mesh
    of ``n_devices`` processes; prints the result line and returns its
    numbers."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // tp
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda', but PyTorch sees no CUDA device "
                               "(pass device='cpu' to run the ranks on the CPU)")
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(n_devices)]
    elif device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    with tempfile.TemporaryDirectory() as td:
        spawn(_rank, devices, td, args=(dp, tp, full_width, devices, td),
              threads=1 if device == "cpu" else None)
        with open(os.path.join(td, "result.json")) as f:
            result = json.load(f)
    print(f"dryrun_multichip OK: {n_devices} devices (dp={dp}, tp={tp}), "
          f"full_width={full_width}, loss={result['loss']:.4f}, "
          f"eval_mrr={result['eval_mrr']:.4f}, ckpt roundtrip ok")
    return dict(result, dp=dp, tp=tp)
