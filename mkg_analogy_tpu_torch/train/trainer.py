"""MarT trainer (``mkg_analogy_tpu/train/trainer.py``): fine-tuning,
pre-training and evaluation, on one device.

- fine-tune loss = label-smoothed CE over the 2,063 analogy-entity logits
                   + alpha * relaxation loss (transformer.py:92-109);
- pre-train loss = entity-range CE (pre_type != 2) + relation-range CE
                   (pre_type == 2) at the mask position, one decoder product
                   over [entities ; relations] (transformer.py:72-90): the
                   ``triple`` format. The ``analogy`` format is the
                   fine-tune loss with the decoder over every MarKG entity;
                   ``mixed`` interleaves batches of both in a seeded order;
- eval           = ranks -> Hits@k / MR / MRR, tie statistics and per-mode
                   metrics under the reference's metric names
                   (transformer.py:129-166), entity and relation ranks in
                   the triple format; ranks stay on the device until one
                   transfer at the end of the split;
- early stopping on Eval_entity/mrr (patience 5) and best-checkpoint on
  Eval_entity/hits10 (main.py:141-148).

Each training step draws its dropout from generators seeded by (seed,
step), as the JAX step folds the step into its key, so a step's masks do
not depend on what ran before it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..data.batching import BatchIterator
from ..models.common import DropoutRNG
from ..ops.losses import label_smoothing_cross_entropy, relaxation_loss
from ..ops.ranking import rank_metrics, ranks_from_scores, tie_counts
from ..utils.logging import MetricLogger
from ..utils.profiling import StepTimer, trace
from .optim import global_norm, make_optimizer


@dataclass
class TrainConfig:
    lr: float = 5e-5
    max_epochs: int = 15
    batch_size: int = 32
    eval_batch_size: int = 128
    alpha: float = 0.43
    label_smoothing: float = 0.1
    warmup_ratio: float = 0.1
    weight_decay: float = 0.01
    grad_accum_steps: int = 1
    pretrain: bool = False
    # pseudo-analogy pre-training: the fine-tune prompt geometry and losses,
    # the masked-entity decoder over the whole MarKG entity range
    analogy_pretrain: bool = False
    # mixed diet: every epoch interleaves triple-format and pseudo-analogy
    # batches in a seeded order; evaluation in the analogy geometry.
    # Requires analogy_pretrain.
    mixed_pretrain: bool = False
    seed: int = 7
    patience: int = 5
    check_val_every_n_epoch: int = 1
    log_every: int = 50
    max_grad_norm: Optional[float] = None
    # pl parity: no grad-norm metric unless asked (--track_grad_norm)
    track_grad_norm: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 5..10
    # pl parity: float in (0,1] = epoch fraction; int = exact batch count
    limit_train_batches: Optional[float] = None
    fused_adamw: bool = False


def step_seed(seed: int, step: int) -> int:
    """A 63-bit seed for (seed, step), as ``jax.random.fold_in`` derives a
    key: a splitmix64 finaliser of the pair, so neighbouring steps get
    unrelated streams."""
    x = (seed * 0x9E3779B97F4A7C15 + step + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) >> 1


def finetune_positions(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, 5) gather positions: [mask, rel_ex, rel_q, q_head, a_head]."""
    return torch.stack(
        [
            batch["mask_idx"],
            batch["rel_idx"][:, 0],
            batch["rel_idx"][:, 1],
            batch["q_head_idx"],
            batch["a_head_idx"],
        ],
        dim=1,
    )


class MarTTrainer:
    def __init__(self, model, vocab, config: TrainConfig, device="cuda",
                 logger: Optional[MetricLogger] = None):
        self.model = model
        self.vocab = vocab
        self.config = config
        self.device = torch.device(device)
        self.logger = logger or MetricLogger()
        self.analogy_entity_ids = torch.as_tensor(
            vocab.analogy_entity_ids, device=self.device).long()
        self.image_table = None  # optional device-resident feature table
        self.image_kind = "pixels"

    def set_image_table(self, table, kind: str = "pixels") -> None:
        """Keep the entity image features on the device (bf16) and gather
        them by img0/img1 index per batch, so only indices cross to the
        device. The last row must be the zero pad row for -1 slots."""
        self.image_kind = kind
        self.image_table = torch.as_tensor(table).to(self.device, torch.bfloat16)

    # ------------------------------------------------------------------ init
    def init_params(self, seed: int) -> None:
        """Random parameters from a seeded ``torch.Generator`` on the
        trainer's device, then the [R] embedding init."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.init_params(gen)
        self._init_r_token()

    @torch.no_grad()
    def _init_r_token(self) -> None:
        """[R] embedding <- mean of analogy-relation embeddings
        (transformer.py:41-54)."""
        if self.vocab.analogy_relation_ids.size == 0:
            return
        table = self.model.word_embeddings
        ids = torch.as_tensor(self.vocab.analogy_relation_ids, device=table.device)
        table[self.vocab.r_token_id] = table[ids.long()].mean(dim=0)

    # ---------------------------------------------------------------- model io
    def _gather_images(self, batch, image_table):
        """Device-side feature gather: (B,) img0/img1 entity ids -> model
        visual inputs (-1 maps to the zero pad row)."""
        pad_row = image_table.shape[0] - 1
        idx = torch.stack([batch["img0"], batch["img1"]], dim=1).long()  # (B, 2)
        valid = idx >= 0
        # -1 and out-of-range ids (1-row zero tables) go to the pad row
        idx = torch.where(valid & (idx < pad_row), idx, pad_row)
        feats = image_table[idx]  # (B, 2, ...)
        if self.image_kind == "regions":
            b, _, n_reg, d = feats.shape
            vam = valid.to(torch.float32).repeat_interleave(n_reg, dim=1)
            return feats.reshape(b, 2 * n_reg, d), vam
        return feats, None

    def _format(self) -> str:
        """The prompt format of a single-format run: "triple" for triple
        pre-training, else "finetune" (the analogy geometry)."""
        cfg = self.config
        return "triple" if cfg.pretrain and not cfg.analogy_pretrain else "finetune"

    def _model_inputs(self, batch, image_table=None, fmt=None):
        """The model's keyword inputs for a batch of format ``fmt`` (default
        the run's): the triple format gathers the mask position only and has
        no analogy boundary."""
        if (fmt or self._format()) == "triple":
            positions, boundary = batch["mask_idx"][:, None], None
        else:
            positions, boundary = finetune_positions(batch), batch["sep_idx"][:, 2]
        if image_table is not None:
            pixel_values, vam = self._gather_images(batch, image_table)
        else:
            pixel_values = batch["pixel_values"]
            vam = batch.get("visual_attention_mask")
        inputs = dict(
            input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"],
            token_type_ids=batch["token_type_ids"],
            pixel_values=pixel_values,
            positions=positions,
            boundary=boundary,
        )
        if vam is not None:
            inputs["visual_attention_mask"] = vam
        return inputs

    def _answer_logits(self, trans_cls):
        """Masked-entity decoder slice: the 2,063 analogy entities for
        fine-tuning, the whole MarKG entity range for pseudo-analogy
        pre-training."""
        if self.config.analogy_pretrain:
            v = self.vocab
            return self.model.logits(trans_cls, vocab_start=v.entity_id_st,
                                     vocab_end=v.entity_id_ed)
        return self.model.logits(trans_cls, vocab_ids=self.analogy_entity_ids)

    def _triple_logits(self, trans_cls):
        """(entity logits, relation logits) of one contiguous decoder
        product over [entities ; relations]."""
        v = self.vocab
        logits = self.model.logits(trans_cls, vocab_start=v.entity_id_st,
                                   vocab_end=v.relation_id_ed)
        n_ent = v.entity_id_ed - v.entity_id_st
        return logits[:, :n_ent], logits[:, n_ent:]

    # ---------------------------------------------------------------- losses
    def _finetune_loss(self, batch, rng: DropoutRNG, image_table=None):
        """Label-smoothed CE over the analogy entities + alpha * relaxation
        over the gathered [mask, rel_ex, rel_q, q_head, a_head] states."""
        cfg = self.config
        inputs = self._model_inputs(batch, image_table=image_table, fmt="finetune")
        trans = self.model(**inputs, deterministic=False, rng=rng)
        logits = self._answer_logits(trans[:, 0])
        ce = label_smoothing_cross_entropy(logits, batch["label"], cfg.label_smoothing)
        sim = relaxation_loss(trans[:, 3], trans[:, 4], trans[:, 1], trans[:, 2])
        loss = ce + cfg.alpha * sim
        return loss, {"loss": loss, "ce": ce, "sim": sim}

    def _pretrain_loss(self, batch, rng: DropoutRNG, image_table=None):
        """Triple pre-training: label-smoothed CE over the entity range for
        link prediction (pre_type 1) plus over the relation range for
        relation prediction (pre_type 2), labels -100 where a row belongs to
        the other term; a batch without rows of one kind adds 0 for it."""
        cfg = self.config
        inputs = self._model_inputs(batch, image_table=image_table, fmt="triple")
        trans = self.model(**inputs, deterministic=False, rng=rng)
        ent_logits, rel_logits = self._triple_logits(trans[:, 0])
        label = batch["label"]
        is_rel = batch["pre_type"] == 2
        ignore = torch.full_like(label, -100)
        ent_loss = label_smoothing_cross_entropy(
            ent_logits, torch.where(is_rel, ignore, label), cfg.label_smoothing)
        rel_loss = label_smoothing_cross_entropy(
            rel_logits, torch.where(is_rel, label, ignore), cfg.label_smoothing)
        zero = ent_loss.new_zeros(())
        ent_loss = torch.where((~is_rel).any(), ent_loss, zero)
        rel_loss = torch.where(is_rel.any(), rel_loss, zero)
        loss = ent_loss + rel_loss
        return loss, {"loss": loss, "ent_loss": ent_loss, "rel_loss": rel_loss}

    def _train_step(self, optimizer, batch, step: int, image_table=None, loss_kind=None):
        """One micro-batch: forward and backward with the dropout of (seed,
        step), then ``optimizer.step()``. ``loss_kind`` "triple" takes the
        pre-train loss, "finetune" the fine-tune loss (default: the run's
        format). Returns the metrics as device tensors (no sync)."""
        cfg = self.config
        rng = DropoutRNG.from_seed(step_seed(cfg.seed, step), self.device)
        loss_fn = (self._pretrain_loss if (loss_kind or self._format()) == "triple"
                   else self._finetune_loss)
        loss, metrics = loss_fn(batch, rng, image_table=image_table)
        loss.backward()
        if cfg.track_grad_norm:
            metrics["grad_norm"] = global_norm(
                [p.grad for p in self.model.parameters() if p.grad is not None])
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def _eval_step(self, batch, image_table=None):
        inputs = self._model_inputs(batch, image_table=image_table)
        trans = self.model(**inputs)
        if self._format() == "triple":
            ent_logits, rel_logits = self._triple_logits(trans[:, 0])
            label = batch["label"]
            ent_ranks = ranks_from_scores(ent_logits, label)
            # labels mix entity indices (pre_type 1) and relation indices
            # (pre_type 2); the clip only keeps entity labels in range in the
            # relation lane, whose ranks those rows discard
            rel_ranks = ranks_from_scores(
                rel_logits, label.clamp(0, rel_logits.shape[1] - 1))
            is_rel = batch["pre_type"] == 2
            return {"ranks": torch.where(is_rel, rel_ranks, ent_ranks),
                    "is_rel": is_rel, "valid": batch["valid"]}
        logits = self._answer_logits(trans[:, 0])
        ranks = ranks_from_scores(logits, batch["label"])
        out = {"ranks": ranks, "is_rel": torch.zeros_like(ranks, dtype=torch.bool),
               "valid": batch["valid"],
               "tie": tie_counts(logits, batch["label"])}
        if "mode" in batch:  # per-mode rank diagnostics (Hits@k anatomy)
            out["mode"] = batch["mode"]
        return out

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        # float inputs (pixels) go to the device as bfloat16, as in the JAX
        # trainer: the model's inputs are rounded the same way on both.
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.to(self.device, torch.bfloat16 if t.dtype == torch.float32
                          else t.dtype)
        return out

    # ------------------------------------------------------------------- loops
    def evaluate(self, features, attach=None, dump_path=None) -> Dict[str, float]:
        cfg = self.config
        it = BatchIterator(features, cfg.eval_batch_size, shuffle=False,
                           attach=attach, pad_tail=True)
        with torch.inference_mode():
            outs = [self._eval_step(self._put_batch(b), self.image_table) for b in it]
            # one device-to-host transfer per output at the end of the split
            outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]
        ranks = np.concatenate([o["ranks"][o["valid"]] for o in outs])
        is_rel = np.concatenate([o["is_rel"][o["valid"]] for o in outs])
        ties = (np.concatenate([o["tie"][o["valid"]] for o in outs])
                if "tie" in outs[0] else None)
        modes = (np.concatenate([o["mode"][o["valid"]] for o in outs])
                 if "mode" in outs[0] else None)
        metrics: Dict[str, float] = {}
        ent_ranks = ranks[~is_rel]
        if ent_ranks.size:
            for k, val in rank_metrics(torch.from_numpy(ent_ranks)).items():
                metrics[f"Eval_entity/{k}"] = float(val)
            if ties is not None:
                ent_ties = ties[~is_rel]
                metrics["Eval_entity/tie_mean"] = float(ent_ties.mean())
                metrics["Eval_entity/tie_frac"] = float((ent_ties > 1).mean())
            if modes is not None:
                # per-mode anatomy of the Hits@k curve (modes 0/1/2,
                # dataset/README.md:49-58)
                ent_modes = modes[~is_rel]
                for m in (0, 1, 2):
                    sel = ent_ranks[ent_modes == m]
                    if sel.size:
                        mm = rank_metrics(torch.from_numpy(sel), ks=(1, 10))
                        for k in ("hits1", "hits10", "mrr"):
                            metrics[f"Eval_entity/{k}_mode{m}"] = float(mm[k])
        rel_ranks = ranks[is_rel]
        if rel_ranks.size:
            for k, val in rank_metrics(torch.from_numpy(rel_ranks)).items():
                metrics[f"Eval_relation/{k}"] = float(val)
        if dump_path:
            # raw per-example ranks for offline histogram analysis
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            np.savez(dump_path, ranks=ranks, is_rel=is_rel,
                     **({"tie": ties} if ties is not None else {}),
                     **({"mode": modes} if modes is not None else {}))
        return metrics

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _epoch_schedule(self, train_features, attach=None):
        """(the number of batches an epoch, a function that yields one
        epoch's (loss kind, batch) pairs). The mixed diet
        (``train_features`` = (triple, analogy) features) keeps one iterator
        per format, seeds ``seed`` and ``seed + 1``, and takes them in the
        order of a seeded shuffle of their batch tags each epoch; a single
        format yields (None, batch). As the JAX trainer draws one batch to
        shape its state before the first epoch, this draws one too, so the
        two take their batches in the same order."""
        cfg = self.config
        if cfg.mixed_pretrain:
            triple_feats, analogy_feats = train_features
            it_t = BatchIterator(triple_feats, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed, attach=attach)
            it_a = BatchIterator(analogy_feats, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed + 1, attach=attach)
            sched_rng = np.random.default_rng(cfg.seed)

            def epoch_batches():
                tags = np.concatenate([np.zeros(len(it_t), np.int8),
                                       np.ones(len(it_a), np.int8)])
                sched_rng.shuffle(tags)
                gen_t, gen_a = iter(it_t), iter(it_a)
                for tag in tags:
                    yield ("finetune" if tag else "triple"), next(gen_a if tag else gen_t)

            first, steps = it_a, len(it_t) + len(it_a)
        else:
            train_it = BatchIterator(train_features, cfg.batch_size, shuffle=True,
                                     seed=cfg.seed, attach=attach)

            def epoch_batches():
                for b in train_it:
                    yield None, b

            first, steps = train_it, len(train_it)
        next(iter(first))  # the JAX trainer's init_state sample
        return steps, epoch_batches

    def fit(self, train_features, dev_features, attach=None, checkpointer=None,
            eval_attach=None, init_params_fn=None):
        """Train the model in place from its current parameters
        (``init_params_fn``: state dict -> state dict, applied first, for a
        transfer from a checkpoint): fine-tuning, or pre-training in the
        config's format (``train_features`` a (triple, analogy) pair for the
        mixed diet). Returns (the number of steps taken, the dev metrics of
        the best-Hits@10 evaluation)."""
        cfg = self.config
        steps_per_epoch, epoch_batches = self._epoch_schedule(train_features, attach)
        limit_batches = cfg.limit_train_batches
        if limit_batches and isinstance(limit_batches, float) and limit_batches <= 1.0:
            # only FLOATS in (0, 1] are fractions; an int 1 means exactly one
            # batch (pl.Trainer semantics, base.py:79-82)
            limit_batches = max(1, int(steps_per_epoch * limit_batches))
        limit_batches = int(limit_batches) if limit_batches else None
        if limit_batches:
            steps_per_epoch = min(steps_per_epoch, limit_batches)
        total_steps = steps_per_epoch * cfg.max_epochs
        if init_params_fn is not None:
            # pretrain->finetune transfer (main.py:133-134 strict=False parity)
            self.model.load_state_dict(init_params_fn(self.model.state_dict()))
        optimizer = make_optimizer(
            self.model, cfg.lr, total_steps, cfg.warmup_ratio, cfg.weight_decay,
            grad_accum_steps=cfg.grad_accum_steps, max_grad_norm=cfg.max_grad_norm,
            fused=cfg.fused_adamw)
        optimizer.zero_grad()

        best_mrr, best_hits10, since_best = -1.0, -1.0, 0
        best_metrics: Dict[str, float] = {}
        global_step = 0
        timer = StepTimer()
        with contextlib.ExitStack() as profile:  # the trace of steps 5..10
            for epoch in range(cfg.max_epochs):
                t_epoch = time.time()
                n_examples = 0
                metrics = {}
                for epoch_steps, (kind, batch) in enumerate(epoch_batches()):
                    if limit_batches and epoch_steps >= limit_batches:
                        break
                    if global_step == 0 and hasattr(self.vocab, "decode"):
                        # decoded-sample print at batch 0 (transformer.py:111)
                        for row in batch["input_ids"][:2]:
                            print(self.vocab.decode(row[row != 0][:48]))
                    if cfg.profile_dir and global_step == 5:
                        profile.enter_context(trace(cfg.profile_dir))
                    batch.pop("valid")
                    dbatch = self._put_batch(batch)
                    timer.start()
                    metrics = self._train_step(optimizer, dbatch, global_step,
                                               self.image_table, loss_kind=kind)
                    timer.stop()
                    global_step += 1
                    n_examples += cfg.batch_size
                    if global_step == 1:
                        # the first step's one-off costs (kernel builds, cuBLAS
                        # set-up) stay out of the epoch-0 throughput
                        self._sync()
                        t_epoch = time.time()
                        n_examples = 0
                    if global_step == 10:
                        profile.close()
                    if global_step % cfg.log_every == 0:
                        self.logger.log(global_step, {k: float(v) for k, v in metrics.items()},
                                        prefix="train/")
                self._sync()
                dt = time.time() - t_epoch
                epoch_stats = {"epoch": epoch, "examples_per_sec": n_examples / max(dt, 1e-9)}
                epoch_stats.update(timer.stats())
                # the epoch's last step, so a run's losses can be compared
                epoch_stats.update({f"last_{k}": float(v) for k, v in metrics.items()})
                self.logger.log(global_step, epoch_stats, prefix="train/")
                if (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                    eval_metrics = self.evaluate(dev_features, attach=eval_attach or attach)
                    self.logger.log(global_step, eval_metrics)
                    mrr = eval_metrics.get("Eval_entity/mrr", 0.0)
                    hits10 = eval_metrics.get("Eval_entity/hits10", 0.0)
                    if hits10 > best_hits10:
                        best_hits10 = hits10
                        best_metrics = eval_metrics
                        if checkpointer is not None:
                            checkpointer.save(global_step, self.model.state_dict(),
                                              metrics=eval_metrics)
                    if mrr > best_mrr:
                        best_mrr, since_best = mrr, 0
                    else:
                        since_best += 1
                        if since_best >= cfg.patience:
                            self.logger.log(global_step, {"early_stop": 1.0})
                            break
        return global_step, best_metrics
