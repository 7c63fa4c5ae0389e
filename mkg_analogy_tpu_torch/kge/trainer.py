"""KGE training loops (IKRL / TransAE pretrain + finetune;
``mkg_analogy_tpu/kge/trainer.py``).

Replaces the reference Trainer (IKRL.py:18-168): margin/softplus negative-
sampling pretrain over the Bernoulli sampler, Adam CE finetune over MARS
6-tuples. The model (its tables on the device) is the state; each batch's
three index columns go to the device in one copy, the task modes are drawn
there, and the losses stay there until a logged epoch sums them (one sync
per logged epoch, none per step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.optim import torch_adagrad
from .scorers import margin_loss, softplus_loss


@dataclass
class KGETrainConfig:
    train_times: int = 2000
    lr: float = 1.0  # reference: SGD alpha=1.0 pretrain, Adam 1e-4 finetune
    optimizer: str = "sgd"
    loss: str = "margin"  # "margin" | "softplus"
    # opt-in reference quirk: feed RAW energies to the softplus logistic
    # loss like IKRL.py:1030-1040 does (inverted w.r.t. its own
    # smaller-is-better evaluator) instead of the corrected negation
    compat_ref_softplus_sign: bool = False
    margin: float = 5.0
    regul_rate: float = 0.0
    finetune_lr: float = 1e-4
    finetune_epochs: int = 1000
    finetune_batch_size: int = 128
    seed: int = 0


@dataclass
class KGEState:
    """What the JAX package's train state holds: the model (parameters and
    frozen buffers), its optimizer and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def draw_task_mode(generator: torch.Generator, n: int) -> torch.Tensor:
    """Random per-row task mode, 0.4/0.3/0.3 (IKRL.py:75-85), on the
    generator's device."""
    u = torch.randint(0, 10, (n,), generator=generator, device=generator.device)
    return torch.where(u < 4, 0, torch.where(u < 7, 1, 2))


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class KGETrainer:
    def __init__(self, model, cfg: KGETrainConfig, batch_size: int,
                 neg_total: int):
        self.model = model
        self.cfg = cfg
        self.batch_size = batch_size
        self.neg_total = neg_total  # neg_ent + neg_rel

    def _make_tx(self, lr: float, name: str) -> torch.optim.Optimizer:
        params = list(self.model.parameters())
        name = name.lower()
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if name == "adam":
            return torch.optim.Adam(params, lr=lr)
        if name == "adagrad":
            return torch_adagrad(params, lr)
        raise KeyError(name)

    def init_state(self, finetune: bool = False) -> KGEState:
        """The optimizer over the model's parameters (its buffers, the frozen
        tables, are not parameters), step 0. The model is initialised where
        it is built, from its generator."""
        tx = (self._make_tx(self.cfg.finetune_lr, "adam") if finetune
              else self._make_tx(self.cfg.lr, self.cfg.optimizer))
        return KGEState(self.model, tx)

    # ---------------------------------------------------------------- pretrain
    def _pretrain_loss(self, batch: Dict[str, torch.Tensor],
                       task_mode: torch.Tensor) -> torch.Tensor:
        bs = self.batch_size
        energies = self.model(batch["batch_h"], batch["batch_t"], batch["batch_r"],
                              task_mode)
        # OpenKE layout: first bs rows positive, rest negatives (column-major
        # blocks); NegativeSampling reshapes to (bs, n_neg) — same here.
        p = energies[:bs]
        n = energies[bs:].reshape(self.neg_total, bs).T
        if self.cfg.loss == "margin":
            loss = margin_loss(p, n, self.cfg.margin)
        elif self.cfg.compat_ref_softplus_sign:
            # the reference feeds raw ANALOGY energies to SoftplusLoss
            # (IKRL.py:1030-1040), inverted w.r.t. its own evaluator
            loss = softplus_loss(p, n)
        else:
            # energies are lower-is-better; the logistic loss wants
            # higher-is-better scores, so negate
            loss = softplus_loss(-p, -n)
        if self.cfg.regul_rate and hasattr(self.model, "regularization"):
            reg = self.model.regularization(batch["batch_h"], batch["batch_t"],
                                            batch["batch_r"])
            loss = loss + self.cfg.regul_rate * reg
        return loss

    def pretrain_step(self, state: KGEState, batch: Dict[str, torch.Tensor],
                      task_mode: torch.Tensor) -> torch.Tensor:
        """One update; returns the loss, detached, on the device."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._pretrain_loss(batch, task_mode)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @staticmethod
    def device_batch(batch, device) -> Dict[str, torch.Tensor]:
        """The three index columns of a sampler batch on ``device``, in one
        host-to-device copy."""
        cols = np.stack([batch["batch_h"], batch["batch_t"], batch["batch_r"]])
        idx = torch.from_numpy(cols.astype(np.int64, copy=False)).to(device)
        return dict(batch_h=idx[0], batch_t=idx[1], batch_r=idx[2])

    def pretrain(self, sampler, state: Optional[KGEState] = None,
                 log_every: int = 50, logger=None) -> KGEState:
        if state is None:
            state = self.init_state()
        device = model_device(self.model)
        generator = torch.Generator(device=device).manual_seed(self.cfg.seed)
        self.model.train()
        for epoch in range(self.cfg.train_times):
            losses = []
            for batch in sampler:
                dev_batch = self.device_batch(batch, device)
                task_mode = draw_task_mode(generator, dev_batch["batch_h"].shape[0])
                losses.append(self.pretrain_step(state, dev_batch, task_mode))
            if logger and (epoch % log_every == 0 or epoch == self.cfg.train_times - 1):
                total = float(torch.stack(losses).sum())
                logger.log(state.step, {"epoch_loss": total, "epoch": epoch},
                           prefix="kge_pretrain/")
        return state

    # ---------------------------------------------------------------- finetune
    def _finetune_loss(self, batch: Dict[str, torch.Tensor]):
        scores = self.model.finetune_scores(batch["e_head"], batch["e_tail"],
                                            batch["q_head"], batch["task_mode"])
        logp = F.log_softmax(scores.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, 1, batch["q_tail"][:, None])
        return torch.mean(nll), scores

    def finetune_step(self, state: KGEState, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = self._finetune_loss(batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @staticmethod
    def tuple_batch(rows: np.ndarray, device) -> Dict[str, torch.Tensor]:
        """(B, 6) [e_h, e_t, q, a, r, mode] rows -> the fine-tune batch on
        ``device``, in one host-to-device copy."""
        idx = torch.from_numpy(np.ascontiguousarray(rows.T, dtype=np.int64)).to(device)
        return dict(e_head=idx[0], e_tail=idx[1], q_head=idx[2], q_tail=idx[3],
                    task_mode=idx[5])

    def finetune(self, tuples: np.ndarray, state: KGEState,
                 logger=None, log_every: int = 10) -> KGEState:
        """tuples: (N, 6) int array [e_h, e_t, q_head, q_tail(answer), r, mode]."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        bs = cfg.finetune_batch_size
        n = len(tuples)
        device = model_device(self.model)
        self.model.train()
        for epoch in range(cfg.finetune_epochs):
            order = rng.permutation(n)
            losses = []  # on the device; one sync per logged epoch
            for b in range(n // bs):
                rows = tuples[order[b * bs : (b + 1) * bs]]
                losses.append(self.finetune_step(state, self.tuple_batch(rows, device)))
            if logger and (epoch % log_every == 0 or epoch == cfg.finetune_epochs - 1):
                total = float(torch.stack(losses).sum()) if losses else 0.0
                logger.log(state.step, {"epoch_loss": total, "epoch": epoch},
                           prefix="kge_finetune/")
        return state


def mars_finetune_tuples(mars, markg) -> Dict[str, np.ndarray]:
    """MARS splits -> (N, 6) [e_h, e_t, q, a, r, mode] id arrays — the
    in-memory equivalent of data/analogy/{train,valid,test}2id_ft.txt
    (IKRL.py:944-953 AnalogyFinetuneDataset)."""
    out = {}
    for split in ("train", "dev", "test"):
        rows = [
            (
                markg.ent2id[e.head], markg.ent2id[e.tail],
                markg.ent2id[e.question], markg.ent2id[e.answer],
                markg.rel2id[e.relation], e.mode,
            )
            for e in mars.split(split)
        ]
        out[split] = np.asarray(rows, dtype=np.int64)
    return out
