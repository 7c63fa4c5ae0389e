"""MarT trainer (``mkg_analogy_tpu/train/trainer.py``): fine-tuning,
pre-training and evaluation, on one device or a (dp, tp) mesh.

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
                   transfer at the end of the split; unlike JAX, a row whose
                   gold logit is not finite ranks last (ops/ranking.py) and
                   ``Eval_*/nonfinite_gold`` counts such rows;
- early stopping on Eval_entity/mrr (patience 5) and best-checkpoint on
  Eval_entity/hits10 (main.py:141-148).

Each training step draws its dropout from generators seeded by (seed,
step), as the JAX step folds the step into its key, so a step's masks do
not depend on what ran before it.

``fit`` and ``evaluate`` take their batches through ``_prefetch``, as the
JAX trainer does: a worker thread assembles each batch and starts its copy
to the device two steps ahead. On a CUDA device the copy runs from pinned
memory on a side stream, and the step's stream waits on its event.

While ``utils/profiling.recording()`` is open the loops record spans (names
in the docstrings of ``fit``, ``_epochs``, ``_prefetch`` and ``evaluate``;
``sync`` around ``_sync``), each with the id of the step or batch it serves.

On a mesh (``mesh``, ``core/mesh.py``; one process a rank) the trainer does
what JAX's GSPMD does for its sharded step:
- the model's parameters are split over ``tp`` by the rules of
  ``parallel/shardings.py`` before its first forward (``_parallelize``), so
  it is built, initialised and loaded whole; ``state_dict`` and
  ``load_state_dict`` take whole tensors whatever the mesh;
- each rank takes its ``batch_size / dp`` rows of every global batch, in
  the single-process order (``batch_size % dp`` must be 0), and draws the
  dropout of the global batch's rows (``DropoutRNG.rows``);
- each rank's loss is its share of the global mean, its gradients are
  summed over ``dp`` before clipping (``train/optim.py``), and the logged
  metrics are the sums of the shares;
- evaluation splits each padded eval batch over ``dp`` and brings every
  rank's ranks to every rank once per split, by an all-reduce into zeros,
  so every rank takes the same early-stopping and checkpoint decisions;
- only rank 0 logs, prints, dumps ranks and writes checkpoints.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core import mesh as meshes
from ..core.mesh import AXES, axis_group, axis_rank, axis_size
from ..data.batching import BatchIterator
from ..models.common import DropoutRNG
from ..ops.losses import label_smoothing_cross_entropy, relaxation_loss
from ..ops.ranking import nonfinite_gold, rank_metrics, ranks_from_scores, tie_counts
from ..parallel.collectives import ShardedLogits, all_reduce_, gather_rows, shard_of
from ..parallel.shardings import (
    batch_spec, gather_state_dict, make_shardings, shard_module, shard_state_dict)
from ..utils.logging import MetricLogger
from ..utils.profiling import set_step, span, trace
from .optim import make_optimizer


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
    # one device unless ``mesh`` says otherwise
    mesh, dp, dp_rank, dp_group, is_main = None, 1, 0, None, True

    def __init__(self, model, vocab, config: TrainConfig, device="cuda",
                 logger: Optional[MetricLogger] = None, mesh=None):
        self.model = model
        self.vocab = vocab
        self.config = config
        self.device = torch.device(device)
        self.logger = logger or MetricLogger()
        self.mesh = mesh  # a (dp, tp) DeviceMesh (core/mesh.make_mesh) or None
        self.dp = axis_size(mesh, AXES.dp)
        self.dp_rank = axis_rank(mesh, AXES.dp)
        self.dp_group = axis_group(mesh, AXES.dp)
        self.is_main = meshes.is_main(mesh)
        self._sharded = False
        self.analogy_entity_ids = torch.as_tensor(
            vocab.analogy_entity_ids, device=self.device).long()
        self.image_table = None  # optional device-resident feature table
        self.image_kind = "pixels"
        self._copy_stream = None  # the prefetch worker's CUDA stream, made at first use

    def set_image_table(self, table, kind: str = "pixels") -> None:
        """Keep the entity image features on the device (bf16) and gather
        them by img0/img1 index per batch, so only indices cross to the
        device. The last row must be the zero pad row for -1 slots."""
        self.image_kind = kind
        self.image_table = torch.as_tensor(table).to(self.device, torch.bfloat16)

    # ------------------------------------------------------------------ init
    def init_params(self, seed: int) -> None:
        """Random parameters from a seeded ``torch.Generator`` on the
        trainer's device, then the [R] embedding init. The same draws on
        every rank: the model is whole until its first forward."""
        if self._sharded:
            raise RuntimeError("init_params draws whole parameters: call it before the "
                               "first step or evaluation, or load_state_dict after")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.init_params(gen)
        self._init_r_token()

    @torch.no_grad()
    def _init_r_token(self) -> None:
        """[R] embedding <- mean of analogy-relation embeddings
        (transformer.py:41-54). Over a vocab-parallel table the rows come
        from every rank's shard, and the rank that holds [R] writes it."""
        if self.vocab.analogy_relation_ids.size == 0:
            return
        table = self.model.word_embeddings
        ids = torch.as_tensor(self.vocab.analogy_relation_ids, device=table.device)
        mean = gather_rows(table, ids).mean(dim=0)
        row, shard = self.vocab.r_token_id, shard_of(table)
        if shard is None:
            table[row] = mean
        elif shard.start <= row < shard.stop:
            table[row - shard.start] = mean

    def _parallelize(self) -> None:
        """Split the model over the mesh's tp axis (once, before its first
        forward)."""
        if not self._sharded:
            shard_module(self.model, self.mesh)
            self._sharded = True

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state with whole tensors, whatever the mesh (a
        collective under tp: every rank calls it)."""
        return gather_state_dict(self.model)

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load whole tensors onto the model, split as the model is."""
        self.model.load_state_dict(shard_state_dict(self.model, state))

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
        if isinstance(logits, ShardedLogits):  # a tp rank's columns
            return logits.split(n_ent)
        return logits[:, :n_ent], logits[:, n_ent:]

    # ---------------------------------------------------------------- losses
    def _finetune_loss(self, batch, rng: DropoutRNG, image_table=None):
        """Label-smoothed CE over the analogy entities + alpha * relaxation
        over the gathered [mask, rel_ex, rel_q, q_head, a_head] states."""
        cfg = self.config
        self._parallelize()
        inputs = self._model_inputs(batch, image_table=image_table, fmt="finetune")
        trans = self.model(**inputs, deterministic=False, rng=rng)
        logits = self._answer_logits(trans[:, 0])
        ce = label_smoothing_cross_entropy(logits, batch["label"], cfg.label_smoothing,
                                           dp_group=self.dp_group)
        sim = relaxation_loss(trans[:, 3], trans[:, 4], trans[:, 1], trans[:, 2],
                              dp_group=self.dp_group)
        loss = ce + cfg.alpha * sim
        return loss, {"loss": loss, "ce": ce, "sim": sim}

    def _pretrain_loss(self, batch, rng: DropoutRNG, image_table=None):
        """Triple pre-training: label-smoothed CE over the entity range for
        link prediction (pre_type 1) plus over the relation range for
        relation prediction (pre_type 2), labels -100 where a row belongs to
        the other term; a batch without rows of one kind adds 0 for it.
        Under dp each term is this rank's share of the global batch's mean,
        whatever share of the -100 rows the rank holds."""
        cfg = self.config
        self._parallelize()
        inputs = self._model_inputs(batch, image_table=image_table, fmt="triple")
        trans = self.model(**inputs, deterministic=False, rng=rng)
        ent_logits, rel_logits = self._triple_logits(trans[:, 0])
        label = batch["label"]
        is_rel = batch["pre_type"] == 2
        ignore = torch.full_like(label, -100)
        ent_loss = label_smoothing_cross_entropy(
            ent_logits, torch.where(is_rel, ignore, label), cfg.label_smoothing,
            dp_group=self.dp_group)
        rel_loss = label_smoothing_cross_entropy(
            rel_logits, torch.where(is_rel, label, ignore), cfg.label_smoothing,
            dp_group=self.dp_group)
        zero = ent_loss.new_zeros(())
        # whether the global batch has rows of each kind
        n_rel = all_reduce_(is_rel.sum(), self.dp_group)
        ent_loss = torch.where(n_rel < is_rel.numel() * self.dp, ent_loss, zero)
        rel_loss = torch.where(n_rel > 0, rel_loss, zero)
        loss = ent_loss + rel_loss
        return loss, {"loss": loss, "ent_loss": ent_loss, "rel_loss": rel_loss}

    def _train_step(self, optimizer, batch, step: int, image_table=None, loss_kind=None):
        """One micro-batch: forward and backward with the dropout of (seed,
        step), then ``optimizer.step()``. ``loss_kind`` "triple" takes the
        pre-train loss, "finetune" the fine-tune loss (default: the run's
        format). Returns the metrics as device tensors (no sync)."""
        cfg = self.config
        rows = None
        if self.dp > 1:
            n = batch["input_ids"].shape[0]
            rows = (self.dp_rank * n, self.dp * n)
        rng = DropoutRNG.from_seed(step_seed(cfg.seed, step), self.device, rows=rows)
        loss_fn = (self._pretrain_loss if (loss_kind or self._format()) == "triple"
                   else self._finetune_loss)
        with span("step.forward"):
            loss, metrics = loss_fn(batch, rng, image_table=image_table)
        with span("step.backward"):
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.dp_group is not None:
            # the global batch's losses: the sums of the ranks' shares
            names = sorted(metrics)
            summed = all_reduce_(torch.stack([metrics[k] for k in names]), self.dp_group)
            metrics = dict(zip(names, summed.unbind()))
        if cfg.track_grad_norm:
            optimizer.sync_gradients()
            metrics["grad_norm"] = optimizer.grad_norm()
        with span("step.optimizer"):
            optimizer.step()
        return metrics

    def _eval_step(self, batch, image_table=None):
        self._parallelize()
        inputs = self._model_inputs(batch, image_table=image_table)
        trans = self.model(**inputs)
        if self._format() == "triple":
            ent_logits, rel_logits = self._triple_logits(trans[:, 0])
            label = batch["label"]
            ent_ranks = ranks_from_scores(ent_logits, label)
            # labels mix entity indices (pre_type 1) and relation indices
            # (pre_type 2); the clip only keeps entity labels in range in the
            # relation lane, whose ranks those rows discard
            rel_label = label.clamp(0, rel_logits.shape[1] - 1)
            rel_ranks = ranks_from_scores(rel_logits, rel_label)
            is_rel = batch["pre_type"] == 2
            return {"ranks": torch.where(is_rel, rel_ranks, ent_ranks),
                    "is_rel": is_rel, "valid": batch["valid"],
                    "nonfinite": torch.where(is_rel, nonfinite_gold(rel_logits, rel_label),
                                             nonfinite_gold(ent_logits, label))}
        logits = self._answer_logits(trans[:, 0])
        ranks = ranks_from_scores(logits, batch["label"])
        out = {"ranks": ranks, "is_rel": torch.zeros_like(ranks, dtype=torch.bool),
               "valid": batch["valid"],
               "tie": tie_counts(logits, batch["label"]),
               "nonfinite": nonfinite_gold(logits, batch["label"])}
        if "mode" in batch:  # per-mode rank diagnostics (Hits@k anatomy)
            out["mode"] = batch["mode"]
        return out

    def _rows(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's rows of a global batch (batch_spec over dp); the
        whole batch without dp. Raises where dp does not divide the batch,
        as JAX's device_put does."""
        if self.dp == 1:
            return batch
        n = len(next(iter(batch.values())))
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not split over dp={self.dp}")
        shardings = make_shardings(self.mesh, batch_spec(batch))
        return {k: shardings[k].local(v) for k, v in batch.items()}

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        # float inputs (pixels) go to the device as bfloat16, as in the JAX
        # trainer: the model's inputs are rounded the same way on both.
        out = {}
        for k, v in self._rows(batch).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.to(self.device, torch.bfloat16 if t.dtype == torch.float32
                          else t.dtype)
        return out

    def _put_batch_async(self, batch: Dict[str, np.ndarray]):
        """``_put_batch`` for the prefetch worker: (tensors, ready event or
        None). On a CUDA device each array is staged in pinned memory (fp32
        rounded to bf16 on the host, the same rounding) and copied on the
        side stream without blocking; ``ready`` marks the copies' end. The
        pinned buffers come from PyTorch's caching host allocator, which
        reuses none before the copy that reads it has run. Elsewhere the
        plain ``_put_batch``."""
        if self.device.type != "cuda":
            return self._put_batch(batch), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in self._rows(batch).items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if t.dtype == torch.float32:
                    t = t.to(torch.bfloat16)
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return out, ready

    def _ready(self, staged) -> Dict[str, torch.Tensor]:
        """On the loop's thread: the tensors of a ``_put_batch_async``
        result, with the current stream made to wait for their copies. Each
        tensor is recorded on that stream, so the caching allocator, which
        allocated it on the side stream, reuses its memory only once the
        work queued here has passed."""
        tensors, ready = staged
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors

    def _prefetch(self, iterable, transform, lookahead: int = 2, wait: str = "step.wait",
                  first_id: int = 0):
        """Yield ``transform(b)`` for each ``b`` of ``iterable``, computed on
        a worker thread up to ``lookahead`` items ahead (the JAX trainer's
        ``_prefetch``: batch assembly and the copy to the device leave the
        loop's thread). An error in the worker is raised here. Close the
        generator when leaving early (``contextlib.closing``): closing stops
        and joins the worker, so none outlives its loop, where the JAX
        version leaves its thread blocked on the full queue.

        Spans: ``stage`` on the worker around each ``transform``, and
        ``wait`` on the loop's thread while it blocks on the queue, each with
        the id of the item it serves, counted from ``first_id``."""
        q: "queue.Queue" = queue.Queue(maxsize=lookahead)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for i, b in enumerate(iterable, first_id):
                    with span("stage", step=i):
                        item = transform(b)
                    if not put(("item", item)):
                        return
                put(("end", None))
            except BaseException as e:  # surfaced in the loop
                put(("err", e))
            finally:
                close = getattr(iterable, "close", None)
                if close is not None:
                    close()

        thread = threading.Thread(target=worker, name="mkg-prefetch", daemon=True)
        thread.start()
        try:
            for i in itertools.count(first_id):
                with span(wait, step=i):
                    kind, payload = q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            thread.join()

    # ------------------------------------------------------------------- loops
    def _every_ranks_rows(self, outs):
        """Every rank's rows of each eval output, on every rank: the split's
        (n_batches, local rows) stacked, written at the rank's rows of
        zeros and summed over dp, in one all-reduce per output."""
        gathered = []
        for k in outs[0]:
            local = torch.stack([o[k] for o in outs])
            whole = torch.zeros(local.shape[0], local.shape[1] * self.dp,
                                dtype=torch.int64, device=local.device)
            n = local.shape[1]
            whole[:, self.dp_rank * n:(self.dp_rank + 1) * n] = local
            gathered.append((k, all_reduce_(whole, self.dp_group).to(local.dtype)))
        return [{k: v[i] for k, v in gathered} for i in range(len(outs))]

    def evaluate(self, features, attach=None, dump_path=None) -> Dict[str, float]:
        """Rank every example of ``features``; returns the metrics. Spans:
        ``evaluate``; for each batch ``eval.wait`` (its queue wait),
        ``eval.batch`` and in it ``eval.forward``; ``eval.gather``, the
        transfer at the split's end and the host metrics."""
        cfg = self.config
        with span("evaluate"):
            it = BatchIterator(features, cfg.eval_batch_size, shuffle=False,
                               attach=attach, pad_tail=True)
            outs = []
            with torch.inference_mode(), contextlib.closing(
                    self._prefetch(it, self._put_batch_async, wait="eval.wait")) as batches:
                for i, b in enumerate(batches):
                    set_step(i)
                    with span("eval.batch"):
                        b = self._ready(b)
                        with span("eval.forward"):
                            outs.append(self._eval_step(b, self.image_table))
            with span("eval.gather"):
                with torch.inference_mode():
                    if self.dp_group is not None:
                        outs = self._every_ranks_rows(outs)
                    # one device-to-host transfer per output at the end of the split
                    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]
                return self._split_metrics(outs, dump_path)

    def _split_metrics(self, outs, dump_path) -> Dict[str, float]:
        """The metrics of a split from its batches' outputs on the host; with
        ``dump_path``, the ranks written there."""
        ranks = np.concatenate([o["ranks"][o["valid"]] for o in outs])
        is_rel = np.concatenate([o["is_rel"][o["valid"]] for o in outs])
        nonfinite = np.concatenate([o["nonfinite"][o["valid"]] for o in outs])
        ties = (np.concatenate([o["tie"][o["valid"]] for o in outs])
                if "tie" in outs[0] else None)
        modes = (np.concatenate([o["mode"][o["valid"]] for o in outs])
                 if "mode" in outs[0] else None)
        metrics: Dict[str, float] = {}
        ent_ranks = ranks[~is_rel]
        if ent_ranks.size:
            for k, val in rank_metrics(torch.from_numpy(ent_ranks)).items():
                metrics[f"Eval_entity/{k}"] = float(val)
            metrics["Eval_entity/nonfinite_gold"] = float(nonfinite[~is_rel].sum())
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
            metrics["Eval_relation/nonfinite_gold"] = float(nonfinite[is_rel].sum())
        if dump_path and self.is_main:
            # raw per-example ranks for offline histogram analysis
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            np.savez(dump_path, ranks=ranks, is_rel=is_rel,
                     **({"tie": ties} if ties is not None else {}),
                     **({"mode": modes} if modes is not None else {}))
        return metrics

    def _log(self, step, metrics, prefix="") -> None:
        if self.is_main:
            self.logger.log(step, metrics, prefix=prefix)

    def _sync(self) -> None:
        with span("sync"):
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
        the best-Hits@10 evaluation). Spans: ``fit``, and in it
        ``fit.setup`` (the schedule and the optimizer) and ``_epochs``'s."""
        cfg = self.config
        with span("fit"):
            with span("fit.setup"):
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
                    self.load_state_dict(init_params_fn(self.state_dict()))
                self._parallelize()  # before the optimizer takes the parameters
                optimizer = make_optimizer(
                    self.model, cfg.lr, total_steps, cfg.warmup_ratio, cfg.weight_decay,
                    grad_accum_steps=cfg.grad_accum_steps, max_grad_norm=cfg.max_grad_norm,
                    fused=cfg.fused_adamw, mesh=self.mesh)
                optimizer.zero_grad()
            return self._epochs(optimizer, epoch_batches, limit_batches, dev_features,
                                eval_attach or attach, checkpointer)

    def _epochs(self, optimizer, epoch_batches, limit_batches, dev_features, eval_attach,
                checkpointer):
        """``fit``'s epochs, each followed by an evaluation every
        ``check_val_every_n_epoch``. Spans: ``step`` for each step, around
        ``_ready`` and ``_train_step`` (which holds ``step.forward``,
        ``step.backward`` and ``step.optimizer``); ``step.wait`` and
        ``stage`` from ``_prefetch``."""
        cfg = self.config
        best_mrr, best_hits10, since_best = -1.0, -1.0, 0
        best_metrics: Dict[str, float] = {}
        global_step = 0

        def stage(tagged):
            # on the prefetch worker: host assembly and the copy to the device
            kind, batch = tagged
            ids_preview = batch["input_ids"][:2]
            batch = {k: v for k, v in batch.items() if k != "valid"}
            return kind, ids_preview, self._put_batch_async(batch)

        with contextlib.ExitStack() as profile:  # the trace of steps 5..10
            for epoch in range(cfg.max_epochs):
                t_epoch = time.time()
                n_examples = 0
                metrics = {}
                batches = epoch_batches()
                if limit_batches:
                    # the worker assembles one batch past the limit, as the
                    # loop did before it, so the iterators' seeded draws of
                    # the next epoch stay where they were
                    batches = itertools.islice(batches, limit_batches + 1)
                with contextlib.closing(self._prefetch(batches, stage,
                                                       first_id=global_step)) as prefetched:
                    for epoch_steps, (kind, ids_preview, sbatch) in enumerate(prefetched):
                        if limit_batches and epoch_steps >= limit_batches:
                            break
                        if global_step == 0 and self.is_main and hasattr(self.vocab, "decode"):
                            # decoded-sample print at batch 0 (transformer.py:111)
                            for row in ids_preview:
                                print(self.vocab.decode(row[row != 0][:48]))
                        if cfg.profile_dir and global_step == 5:
                            profile.enter_context(trace(cfg.profile_dir))
                        set_step(global_step)
                        with span("step"):
                            dbatch = self._ready(sbatch)
                            metrics = self._train_step(optimizer, dbatch, global_step,
                                                       self.image_table, loss_kind=kind)
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
                        if global_step % cfg.log_every == 0 and self.is_main:
                            self.logger.log(global_step,
                                            {k: float(v) for k, v in metrics.items()},
                                            prefix="train/")
                self._sync()
                dt = time.time() - t_epoch
                epoch_stats = {"epoch": epoch, "examples_per_sec": n_examples / max(dt, 1e-9)}
                # the epoch's last step, so a run's losses can be compared
                epoch_stats.update({f"last_{k}": float(v) for k, v in metrics.items()})
                self._log(global_step, epoch_stats, prefix="train/")
                if (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                    eval_metrics = self.evaluate(dev_features, attach=eval_attach)
                    self._log(global_step, eval_metrics)
                    mrr = eval_metrics.get("Eval_entity/mrr", 0.0)
                    hits10 = eval_metrics.get("Eval_entity/hits10", 0.0)
                    if hits10 > best_hits10:
                        best_hits10 = hits10
                        best_metrics = eval_metrics
                        if checkpointer is not None:
                            # every rank gathers; the checkpointer of rank 0 writes
                            checkpointer.save(global_step, self.state_dict(),
                                              metrics=eval_metrics)
                    if mrr > best_mrr:
                        best_mrr, since_best = mrr, 0
                    else:
                        since_best += 1
                        if since_best >= cfg.patience:
                            self._log(global_step, {"early_stop": 1.0})
                            break
        return global_step, best_metrics
