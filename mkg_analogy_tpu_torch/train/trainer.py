"""MarT trainer, evaluation half (``mkg_analogy_tpu/train/trainer.py``).

Evaluation ranks the masked-entity logits over the 2,063 analogy entities
with the stable-sort rank of ops/ranking.py and reports Hits@k / MR / MRR,
tie statistics and per-mode metrics under the reference's metric names
(lit_models/transformer.py:129-166). Batches run on the trainer's device;
ranks stay there until one transfer at the end of the split.

Training (losses, AdamW, checkpoints, the attention backward kernel) is the
next slice of the port; ``fit`` says so.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..data.batching import BatchIterator
from ..ops.ranking import rank_metrics, ranks_from_scores, tie_counts
from ..utils.logging import MetricLogger


@dataclass
class TrainConfig:
    eval_batch_size: int = 128


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

    def _model_inputs(self, batch, image_table=None):
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
            positions=finetune_positions(batch),
            boundary=batch["sep_idx"][:, 2],
        )
        if vam is not None:
            inputs["visual_attention_mask"] = vam
        return inputs

    def _answer_logits(self, trans_cls):
        """Masked-entity decoder slice: the 2,063 analogy entities."""
        return self.model.logits(trans_cls, vocab_ids=self.analogy_entity_ids)

    def _eval_step(self, batch, image_table=None):
        inputs = self._model_inputs(batch, image_table=image_table)
        trans = self.model(**inputs)
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
        ties = np.concatenate([o["tie"][o["valid"]] for o in outs])
        modes = (np.concatenate([o["mode"][o["valid"]] for o in outs])
                 if "mode" in outs[0] else None)
        metrics: Dict[str, float] = {}
        ent_ranks = ranks[~is_rel]
        if ent_ranks.size:
            for k, val in rank_metrics(torch.from_numpy(ent_ranks)).items():
                metrics[f"Eval_entity/{k}"] = float(val)
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
        if dump_path:
            # raw per-example ranks for offline histogram analysis
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            np.savez(dump_path, ranks=ranks, is_rel=is_rel, tie=ties,
                     **({"mode": modes} if modes is not None else {}))
        return metrics

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "training is not ported to PyTorch yet: the losses, AdamW, "
            "checkpoints and the fused-attention backward kernel are the "
            "next slice of the port (ROADMAP.md); run with --only_test"
        )
