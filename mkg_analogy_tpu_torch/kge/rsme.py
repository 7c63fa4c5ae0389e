"""RSME: ComplEx / ANALOGY factorization with gated image fusion
(``mkg_analogy_tpu/kge/rsme.py``; M-KGE/RSME/{models,optimizers,
regularizers}.py).

- per-row Python mode loops (models.py:227-243, 302-328) become vectorized
  ``torch.where`` over the mode column;
- full-vocabulary scoring is one matmul against the α-fused entity table;
  reciprocal relations double the relation table (datasets.py:35-41);
- the forget gate (mode-dependent blend of structural score and image
  cosine similarity, models.py:69-78) is computed batched:
      mode 0 -> s_str | mode 1 -> β·s_str | mode 2 -> β·s_str + (1-β)·cos·pd
- regularizers: F2 / N3 over the factor magnitudes (regularizers.py:14-38).

The frozen ViT table and the forget gate are buffers (``img_vec``,
``rel_pd``; the JAX package's ``frozen`` collection); the parameters carry
the Flax names (``ent``, ``rel``, ``ent_d``, ``rel_d``, ``post_mats``), so
``models.convert.params_from_jax`` maps the JAX variables onto them.

Deviation from the reference (documented, as in the JAX package): in
filtered ranking the reference computes the gold target through ``score()``
whose mode-1 branch skips the β scaling that ``get_ranking`` applies to
candidate rows (models.py:69-78 vs models.py:252-266) — we score gold and
candidates through the SAME blended path, which is self-consistent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.optim import torch_adagrad
from .eval import rank_metrics_of
from .ikrl import default_generator, xavier_uniform_
from .scorers import complex_queries, split_complex
from .trainer import KGEState


@dataclass(frozen=True)
class RSMEConfig:
    num_entities: int
    num_relations: int  # base count; reciprocal doubles it internally
    rank: int = 1000
    init_size: float = 1e-3
    img_dim: int = 1000
    alpha: float = 0.7  # constant image-fusion weight (config.py:1)
    beta: float = 0.5  # structural/image blend (config.py:2)
    forget_gate: bool = True
    model: str = "complex"  # "complex" | "analogy" | "cp"
    # opt-in reference quirk: during filtered ranking, score the GOLD
    # through score() whose mode-1 branch skips the beta blend applied to
    # every candidate (models.py:252-266 vs :69-78) — inflating mode-1
    # gold scores; default scores gold and candidates identically
    compat_ref_mode1_gold: bool = False

    @property
    def n_pred(self) -> int:
        return 2 * self.num_relations


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.maximum(n, torch.tensor(1e-8, device=x.device))


class RSMEModel(nn.Module):
    """ComplEx (+ optional ANALOGY real term) with image fusion."""

    def __init__(self, cfg: RSMEConfig, img_vec: Optional[np.ndarray] = None,
                 rel_pd: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        E, P, w = cfg.num_entities, cfg.n_pred, 2 * cfg.rank
        self.ent = _normal((E, w), cfg.init_size, g)
        self.rel = _normal((P, w), cfg.init_size, g)
        if cfg.model == "analogy":
            self.ent_d = _normal((E, w), cfg.init_size, g)
            self.rel_d = _normal((P, w), cfg.init_size, g)
        self.post_mats = nn.Parameter(torch.empty(cfg.img_dim, w))
        xavier_uniform_(self.post_mats, g)
        img = (torch.tensor(np.asarray(img_vec, np.float32)) if img_vec is not None
               else torch.zeros(E, cfg.img_dim))
        pd = (torch.tensor(np.asarray(rel_pd, np.float32).reshape(-1))
              if rel_pd is not None else torch.ones(P))
        self.register_buffer("img_vec", img)
        self.register_buffer("rel_pd", pd)

    # ------------------------------------------------------------- fusion
    def _img_embeddings(self):
        return self.img_vec @ self.post_mats  # (E, 2r)

    def _fused(self, table, img_emb, ids, fuse_mask):
        """(1-α)·struct + α·img where fuse_mask, else struct."""
        a = self.cfg.alpha
        struct = F.embedding(ids, table)
        img = F.embedding(ids, img_emb)
        fused = (1.0 - a) * struct + a * img
        return torch.where(fuse_mask[:, None], fused, struct)

    def _fused_table(self, table, img_emb):
        a = self.cfg.alpha
        return (1.0 - a) * table + a * img_emb

    def _img_cosine(self, lhs_ids, rhs_ids=None):
        iv = self.img_vec
        l = _unit_rows(iv[lhs_ids])
        if rhs_ids is None:  # vs all entities
            return l @ _unit_rows(iv).T  # (B, E)
        return torch.sum(l * _unit_rows(iv[rhs_ids]), dim=-1)  # (B,)

    def _gate(self, s_str, s_img, rel_ids, mode):
        """Forget-gate blend (models.py:69-81).

        With the gate ON the reference splits by mode (mode 0 pure
        structure, mode 1 beta*structure, mode 2 adds the pd-gated image
        cosine, models.py:71-78); with the gate OFF it blends
        beta*s_str + (1-beta)*s_img uniformly for ALL modes
        (models.py:80-81 else-branch) — no mode split, no rel_pd.
        """
        b = self.cfg.beta
        if not self.cfg.forget_gate:
            return b * s_str + (1.0 - b) * s_img
        pd = self.rel_pd[rel_ids]
        if s_str.ndim == 2:  # (B, E) candidate matrices
            pd = pd[:, None]
            mode = mode[:, None]
        s_img = s_img * pd
        return torch.where(
            mode == 0,
            s_str,
            torch.where(mode == 1, b * s_str, b * s_str + (1.0 - b) * s_img),
        )

    # ------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor):
        """Pretrain forward: x (B, 4) = [lhs, rel, rhs, mode] ->
        (predictions (B, E) over the fused table, factors for N3)."""
        cfg = self.cfg
        img_emb = self._img_embeddings()
        lhs_ids, rel_ids, rhs_ids, mode = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
        lhs = self._fused(self.ent, img_emb, lhs_ids, mode >= 1)
        rhs = self._fused(self.ent, img_emb, rhs_ids, mode == 2)
        rel = F.embedding(rel_ids, self.rel)
        to_score = self._fused_table(self.ent, img_emb)
        q = complex_queries(lhs, rel, cfg.rank)
        preds = q @ to_score.T
        if cfg.model == "analogy":
            lhs_d = self._fused(self.ent_d, img_emb, lhs_ids, mode >= 1)
            rel_d = F.embedding(rel_ids, self.rel_d)
            to_score_d = self._fused_table(self.ent_d, img_emb)
            preds = preds + (lhs_d * rel_d) @ to_score_d.T
        return preds, self._factors(lhs, rel, rhs)

    def _factors(self, lhs, rel, rhs):
        r = self.cfg.rank

        def mag(x):
            re, im = split_complex(x, r)
            return torch.sqrt(re ** 2 + im ** 2)

        return (mag(lhs), mag(rel), mag(rhs))

    # ------------------------------------------------------------ finetune
    def finetune_forward(self, x: torch.Tensor):
        """x (B, 6) = [e_h, e_t, q, a, r, mode]: relation classification from
        the example pair, then link prediction with the argmax relation
        (models.py:330-386)."""
        cfg = self.cfg
        img_emb = self._img_embeddings()
        mode = x[:, 5]
        lhs = self._fused(self.ent, img_emb, x[:, 0], mode >= 1)
        rhs = self._fused(self.ent, img_emb, x[:, 1], mode == 2)
        q_rel = complex_queries(lhs, rhs, cfg.rank)
        rel_scores = q_rel @ self.rel.T  # (B, n_pred)
        pred_rel_ids = torch.argmax(rel_scores, dim=-1)  # first maximum
        pred_rel = F.embedding(pred_rel_ids, self.rel)

        a_lhs = self._fused(self.ent, img_emb, x[:, 2], mode >= 1)
        to_score = self._fused_table(self.ent, img_emb)
        preds = complex_queries(a_lhs, pred_rel, cfg.rank) @ to_score.T
        if cfg.model == "analogy":
            lhs_d = self._fused(self.ent_d, img_emb, x[:, 2], mode >= 1)
            rel_dd = F.embedding(pred_rel_ids, self.rel_d)
            to_score_d = self._fused_table(self.ent_d, img_emb)
            preds = preds + (lhs_d * rel_dd) @ to_score_d.T
        return preds, self._factors(a_lhs, pred_rel, a_lhs)

    # ------------------------------------------------------------- ranking
    def ranking_scores(self, queries: torch.Tensor):
        """(B, E) gated scores for filtered ranking
        (KBCModel.get_ranking, models.py:24-100). queries (B, 4)."""
        cfg = self.cfg
        img_emb = self._img_embeddings()
        lhs_ids, rel_ids, mode = queries[:, 0], queries[:, 1], queries[:, 3]
        lhs = self._fused(self.ent, img_emb, lhs_ids, mode >= 1)
        rel = F.embedding(rel_ids, self.rel)
        to_score = self._fused_table(self.ent, img_emb)
        s_str = complex_queries(lhs, rel, cfg.rank) @ to_score.T
        if cfg.model == "analogy":
            lhs_d = self._fused(self.ent_d, img_emb, lhs_ids, mode >= 1)
            rel_d = F.embedding(rel_ids, self.rel_d)
            s_str = s_str + (lhs_d * rel_d) @ self._fused_table(self.ent_d, img_emb).T
        s_img = self._img_cosine(lhs_ids)  # (B, E)
        return self._gate(s_str, s_img, rel_ids, mode)

    def gold_scores(self, queries: torch.Tensor):
        """Reference score() semantics for the gold triple
        (models.py:245-266): mode 0/1 -> pure structural score, mode 2 ->
        beta*s_str + (1-beta)*cos(lhs_img, rhs_img)[*pd]. Used only under
        ``compat_ref_mode1_gold`` (the corrected default takes the gold's
        score from the same gated candidate row instead)."""
        cfg = self.cfg
        img_emb = self._img_embeddings()
        lhs_ids, rel_ids, rhs_ids, mode = (
            queries[:, 0], queries[:, 1], queries[:, 2], queries[:, 3]
        )
        lhs = self._fused(self.ent, img_emb, lhs_ids, mode >= 1)
        rhs = self._fused(self.ent, img_emb, rhs_ids, mode == 2)
        rel = F.embedding(rel_ids, self.rel)
        s_str = torch.sum(complex_queries(lhs, rel, cfg.rank) * rhs, dim=-1)
        if cfg.model == "analogy":
            lhs_d = self._fused(self.ent_d, img_emb, lhs_ids, mode >= 1)
            rhs_d = self._fused(self.ent_d, img_emb, rhs_ids, mode == 2)
            rel_d = F.embedding(rel_ids, self.rel_d)
            s_str = s_str + torch.sum(lhs_d * rel_d * rhs_d, dim=-1)
        s_img = self._img_cosine(lhs_ids, rhs_ids)  # (B,)
        if cfg.forget_gate:
            s_img = s_img * self.rel_pd[rel_ids]
        b = cfg.beta
        return torch.where(mode == 2, b * s_str + (1.0 - b) * s_img, s_str)


# ---------------------------------------------------------------- training
@dataclass
class RSMETrainConfig:
    lr: float = 1e-2
    optimizer: str = "adagrad"
    batch_size: int = 1000
    reg_weight: float = 0.0
    regularizer: str = "n3"
    max_epochs: int = 300
    seed: int = 0
    decay1: float = 0.9
    decay2: float = 0.999


def n3_reg(factors, weight: float):
    n = factors[0].shape[0]
    return weight * sum(torch.sum(torch.abs(f) ** 3) for f in factors) / n


def f2_reg(factors, weight: float):
    n = factors[0].shape[0]
    return weight * sum(torch.sum(f ** 2) for f in factors) / n


RSMEState = KGEState  # the model, its optimizer, the step


class RSMETrainer:
    """KBCOptimizer parity (optimizers.py:12-49): full-softmax CE +
    regularizer over shuffled batches."""

    def __init__(self, model: nn.Module, cfg: RSMETrainConfig,
                 finetune: bool = False):
        self.model = model
        self.cfg = cfg
        self.finetune = finetune

    def init_state(self) -> RSMEState:
        params = list(self.model.parameters())
        name = self.cfg.optimizer.lower()
        if name == "adagrad":
            tx = torch_adagrad(params, self.cfg.lr)
        elif name == "adam":
            tx = torch.optim.Adam(params, lr=self.cfg.lr,
                                  betas=(self.cfg.decay1, self.cfg.decay2))
        elif name == "sgd":
            tx = torch.optim.SGD(params, lr=self.cfg.lr)
        else:
            raise KeyError(name)
        return RSMEState(self.model, tx)

    def _loss(self, batch: torch.Tensor) -> torch.Tensor:
        if self.finetune:
            preds, factors = self.model.finetune_forward(batch)
            truth = batch[:, 3]
        else:
            preds, factors = self.model(batch)
            truth = batch[:, 2]
        logp = F.log_softmax(preds.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, 1, truth[:, None]).mean()
        if self.cfg.regularizer == "n3":
            reg = n3_reg(factors, self.cfg.reg_weight)
        else:
            reg = f2_reg(factors, self.cfg.reg_weight)
        return nll + reg

    def step(self, state: RSMEState, batch: torch.Tensor) -> torch.Tensor:
        """One update; returns the loss, detached, on the device."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def epoch(self, state: RSMEState, examples: np.ndarray,
              rng: np.random.Generator) -> Tuple[RSMEState, float]:
        order = rng.permutation(len(examples))
        bs = self.cfg.batch_size
        device = next(self.model.parameters()).device
        self.model.train()
        losses = []  # on the device; one host sync per epoch, not per step
        for b in range(0, len(examples) - bs + 1, bs):
            batch = torch.from_numpy(examples[order[b : b + bs]].astype(np.int64))
            losses.append(self.step(state, batch.to(device)))
        if not losses:
            return state, 0.0
        return state, float(torch.stack(losses).mean())


# ----------------------------------------------------------------- dataset
def reciprocal_augment(triples_mode: np.ndarray, n_rel: int) -> np.ndarray:
    """[lhs, rel, rhs, mode] + swapped copy with rel += n_rel
    (datasets.py:35-41)."""
    swapped = triples_mode.copy()
    swapped[:, [0, 2]] = swapped[:, [2, 0]]
    swapped[:, 1] += n_rel
    return np.vstack([triples_mode, swapped])


def assign_modes(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random 0.4/0.3/0.3 modality split (RSME utils.py:143-157)."""
    u = rng.random(n)
    return np.where(u <= 0.4, 0, np.where(u < 0.7, 1, 2)).astype(np.int64)


def build_to_skip(*triple_arrays: np.ndarray):
    """to_skip dict for filtered eval (process_datasets.py semantics):
    rhs[(lhs, rel)] -> known tails; lhs[(rhs, rel + n_rel)] -> known heads."""
    rhs: Dict[Tuple[int, int], set] = {}
    lhs: Dict[Tuple[int, int], set] = {}
    for arr in triple_arrays:
        for row in arr:
            l, r, o = int(row[0]), int(row[1]), int(row[2])
            rhs.setdefault((l, r), set()).add(o)
            lhs.setdefault((o, r), set()).add(l)
    return {"rhs": rhs, "lhs": lhs}


@torch.no_grad()
def filtered_eval(
    model: nn.Module,
    queries: np.ndarray,
    to_skip: Dict[Tuple[int, int], set],
    batch_size: int = 500,
    return_nonfinite: bool = False,
):
    """Filtered ranks, reference counting convention: rank = 1 + #{scores >=
    target} excluding known positives (models.py:83-97 uses >=, which
    counts ties against the gold). The scores come from the device; the
    ranking is the JAX package's numpy code, but for a target that is not
    finite (a diverged fit), which ranks last, at the candidate count: no
    comparison with NaN is true, so JAX's count gives it rank 0. With
    ``return_nonfinite`` also returns the (Q,) bool mask of such targets.
    ``CPModel`` (no ``compat_ref_mode1_gold``, no ``gold_scores``) takes the
    gold's score from its candidate row."""
    ranks = np.ones(len(queries))
    nonfinite = np.zeros(len(queries), bool)
    device = next(model.parameters()).device
    mode1_gold = getattr(getattr(model, "cfg", None), "compat_ref_mode1_gold", False)
    model.eval()
    for b in range(0, len(queries), batch_size):
        rows = queries[b : b + batch_size]
        q = torch.from_numpy(rows.astype(np.int64)).to(device)
        scores = model.ranking_scores(q).to(torch.float32).cpu().numpy().copy()
        if mode1_gold:
            # reference quirk: gold scored through score(), candidates
            # through the gated blend (models.py:81-82 targets)
            target = model.gold_scores(q).to(torch.float32).cpu().numpy()
        else:
            target = scores[np.arange(len(rows)), rows[:, 2]]
        for i, row in enumerate(rows):
            skip = to_skip.get((int(row[0]), int(row[1])))
            if skip:
                cols = np.fromiter(skip, int)
                scores[i, cols] = -1e6
            scores[i, row[2]] = target[i]
        bad = ~np.isfinite(target)
        nonfinite[b : b + len(rows)] = bad
        ranks[b : b + len(rows)] += np.where(bad, scores.shape[1],
                                             (scores >= target[:, None]).sum(1)) - 1
    return (ranks, nonfinite) if return_nonfinite else ranks


def eval_both_sides(model: nn.Module, test: np.ndarray, to_skip,
                    n_rel: int) -> Dict[str, float]:
    """rhs + lhs (reciprocal) filtered evaluation, averaged
    (datasets.py:43-75 + learn.py avg_both)."""
    out = {}
    ranks_all = []
    n_nonfinite = 0
    for side in ("rhs", "lhs"):
        q = test.copy()
        if side == "lhs":
            q[:, [0, 2]] = q[:, [2, 0]]
            q[:, 1] += n_rel
        ranks, nonfinite = filtered_eval(model, q, to_skip[side], return_nonfinite=True)
        ranks_all.append(ranks)
        n_nonfinite += int(nonfinite.sum())
        for k, v in rank_metrics_of(ranks, (1, 3, 5, 10)).items():
            out[f"{side}/{k}"] = v
    out.update(rank_metrics_of(np.concatenate(ranks_all), (1, 3, 5, 10)))
    out["nonfinite_gold"] = float(n_nonfinite)
    return out


class CPModel(nn.Module):
    """Canonical-Polyadic factorization (RSME models.py:103-150): separate
    lhs/rel/rhs tables, score = <lhs, rel, rhs>."""

    def __init__(self, num_entities: int, num_relations: int, rank: int = 1000,
                 init_size: float = 1e-3, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.num_entities = num_entities
        self.num_relations = num_relations  # base count; reciprocal doubles it
        self.rank = rank
        self.lhs = _normal((num_entities, rank), init_size, g)
        self.rel = _normal((2 * num_relations, rank), init_size, g)
        self.rhs = _normal((num_entities, rank), init_size, g)

    def forward(self, x: torch.Tensor):
        lhs = F.embedding(x[:, 0], self.lhs)
        rel = F.embedding(x[:, 1], self.rel)
        rhs = F.embedding(x[:, 2], self.rhs)
        preds = (lhs * rel) @ self.rhs.T
        return preds, (lhs, rel, rhs)

    def ranking_scores(self, queries: torch.Tensor):
        lhs = F.embedding(queries[:, 0], self.lhs)
        rel = F.embedding(queries[:, 1], self.rel)
        return (lhs * rel) @ self.rhs.T
