"""IKRL: multimodal TransE / ANALOGY with 4-way (text/image) scoring
(``mkg_analogy_tpu/kge/ikrl.py``; M-KGE/IKRL_TransAE/IKRL.py:379-845).

- the reference's per-row boolean index_put mixing (score[tt_idx] += ...,
  IKRL.py:478-486) becomes a vectorized ``torch.where`` over task_mode;
- the fine-tune two-stage pipeline (relation classification over all 192
  relations, then link prediction over all 11,292 entities with the argmax
  relation, IKRL.py:487-545) is two batched broadcast contractions;
- the frozen VGG16 visual features are a buffer (the reference freezes them
  via Embedding.from_pretrained, IKRL.py:413-428; the JAX package keeps them
  in a ``frozen`` collection), so the optimizer never sees them and
  ``state_dict`` carries them.

Parameters are named after the Flax trees (``ent_embeddings.embedding``,
``img_project.weight`` for the Dense ``kernel``, ``visual.visual_features``
for the frozen table), so ``models.convert.params_from_jax`` maps the JAX
variables onto them. Random initial values are drawn from an explicit
``torch.Generator`` with the Flax initializers' distributions; the bits of
``jax.random`` are not reproduced.

Task-mode conventions (reference parity):
- pre-train  (IKRL.py:75-85):  0 -> (T,T): tt | 1 -> (I,T): it+ti | 2 -> (I,I): ii
- fine-tune  (IKRL.py:529-533): 0 -> tt | 1 -> ii | 2 -> it+ti
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import init_flax_defaults
from .scorers import analogy_energy, transe_distance


@dataclass(frozen=True)
class IKRLConfig:
    num_entities: int
    num_relations: int
    dim: int = 400
    p_norm: int = 1
    norm_flag: bool = True
    margin: float = 5.0
    visual_dim: int = 4096
    scorer: str = "transe"  # "transe" | "analogy"


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    """Flax ``xavier_uniform`` of a 2-D leaf: U(-b, b), b = sqrt(6 / (rows +
    cols)), symmetric in the two dims, so a transposed Linear weight draws
    from the same law."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Embed(nn.Module):
    """Flax ``nn.Embed``: one ``embedding`` table (num, features), gathered
    by id."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding)


def dense(in_features: int, out_features: int, generator: torch.Generator,
          xavier: bool = False) -> nn.Linear:
    """Flax ``nn.Dense``: lecun-normal kernel (or xavier-uniform) and a zero
    bias."""
    layer = nn.Linear(in_features, out_features)
    init_flax_defaults(layer, generator)
    if xavier:
        xavier_uniform_(layer.weight, generator)
    return layer


def mix_modal_scores(tt, ii, ti, it, task_mode, finetune: bool):
    """4-way score selection by task_mode (see module docstring)."""
    if finetune:
        blended = torch.where(task_mode == 1, ii, it + ti)
    else:
        blended = torch.where(task_mode == 2, ii, it + ti)
    return torch.where(task_mode == 0, tt, blended)


class _VisualTable(nn.Module):
    """Frozen (E+1, 4096) VGG feature table, a buffer; row E is the padding
    row. Without features it holds U(-6/sqrt(dim), 6/sqrt(dim)) draws, as
    the JAX package's fallback does."""

    def __init__(self, cfg: IKRLConfig, features: Optional[np.ndarray],
                 generator: torch.Generator):
        super().__init__()
        shape = (cfg.num_entities + 1, cfg.visual_dim)
        if features is not None:
            assert features.shape == shape, features.shape
            table = torch.tensor(np.asarray(features, np.float32))
        else:
            bound = 6.0 / np.sqrt(cfg.dim)
            table = torch.empty(shape).uniform_(-bound, bound, generator=generator)
        self.register_buffer("visual_features", table)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.visual_features)


class IKRLTransE(nn.Module):
    """TransE with projected-image parallel scoring (IKRL.py:379-580)."""

    def __init__(self, cfg: IKRLConfig, visual_features: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        self.ent_embeddings = Embed(cfg.num_entities, cfg.dim)
        self.rel_embeddings = Embed(cfg.num_relations, cfg.dim)
        with torch.no_grad():
            self.ent_embeddings.embedding.normal_(0.0, 1.0, generator=g)
        xavier_uniform_(self.rel_embeddings.embedding, g)
        self.ent_project = dense(cfg.dim, cfg.dim, g)
        self.img_project = dense(cfg.visual_dim, cfg.dim, g)
        self.visual = _VisualTable(cfg, visual_features, g)

    def _text_emb(self, idx):
        return self.ent_project(self.ent_embeddings(idx))

    def _img_emb(self, idx):
        return self.img_project(self.visual(idx))

    def _dist(self, h, t, r):
        return transe_distance(h, t, r, self.cfg.p_norm, self.cfg.norm_flag)

    def _all_ids(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.rel_embeddings.embedding.device)

    def forward(self, batch_h, batch_t, batch_r, task_mode):
        """Per-row energies for a flat (pretrain) batch; lower is better."""
        h_t, t_t = self._text_emb(batch_h), self._text_emb(batch_t)
        h_i, t_i = self._img_emb(batch_h), self._img_emb(batch_t)
        r = self.rel_embeddings(batch_r)
        tt = self._dist(h_t, t_t, r)
        ii = self._dist(h_i, t_i, r)
        ti = self._dist(h_t, t_i, r)
        it = self._dist(h_i, t_t, r)
        return mix_modal_scores(tt, ii, ti, it, task_mode, finetune=False)

    def all_entity_embeddings(self):
        idx = self._all_ids(self.cfg.num_entities)
        return self._text_emb(idx), self._img_emb(idx)

    def candidate_energies(self, h_idx, r_idx, task_mode, corrupt: str = "tail"):
        """(B, E) energies with every entity substituted into one slot —
        the vectorized form of the reference's per-triple full-entity
        batches (TestDataLoader + IKRL.py:276-297). Each of the four
        distances materialises a (B, E, dim) difference."""
        cand_t, cand_i = self.all_entity_embeddings()  # (E, d) each
        h_t, h_i = self._text_emb(h_idx), self._img_emb(h_idx)
        r = self.rel_embeddings(r_idx)

        def dist(h, t):
            return self._dist(h[:, None, :], t[None, :, :], r[:, None, :])

        if corrupt == "tail":
            tt = dist(h_t, cand_t)
            ii = dist(h_i, cand_i)
            ti = dist(h_t, cand_i)
            it = dist(h_i, cand_t)
        else:  # corrupt == "head": candidates fill the head slot
            tt = self._dist(cand_t[None, :, :], h_t[:, None, :], r[:, None, :])
            ii = self._dist(cand_i[None, :, :], h_i[:, None, :], r[:, None, :])
            ti = self._dist(cand_t[None, :, :], h_i[:, None, :], r[:, None, :])
            it = self._dist(cand_i[None, :, :], h_t[:, None, :], r[:, None, :])
        tm = task_mode[:, None]
        return mix_modal_scores(tt, ii, ti, it, tm, finetune=False)

    def finetune_scores(self, e_head, e_tail, q_head, task_mode):
        """Two-stage analogical pipeline -> (B, E) entity logits.

        Reference parity note (IKRL.py:543-545): the raw mixed distances are
        fed to CrossEntropy as logits and ranked descending at eval — the
        model therefore learns "larger value = answer"; we keep the same
        convention rather than negating."""
        cfg = self.cfg
        rel_all = self.rel_embeddings(self._all_ids(cfg.num_relations))  # (R, d)
        h_t, h_i = self._text_emb(e_head), self._img_emb(e_head)
        t_t, t_i = self._text_emb(e_tail), self._img_emb(e_tail)

        def dist_r(h, t):
            return self._dist(h[:, None, :], t[:, None, :], rel_all[None, :, :])

        tm = task_mode[:, None]
        rel_energy = mix_modal_scores(
            dist_r(h_t, t_t), dist_r(h_i, t_i), dist_r(h_t, t_i),
            dist_r(h_i, t_t), tm, finetune=True,
        )  # (B, R)
        # Reference argmaxes raw distances (IKRL.py:543): keep parity; the
        # first maximum wins, as in jnp.argmax.
        pred_rel = self.rel_embeddings(torch.argmax(rel_energy, dim=-1))

        cand_t, cand_i = self.all_entity_embeddings()
        q_t, q_i = self._text_emb(q_head), self._img_emb(q_head)

        def dist_e(h, cand):
            return self._dist(h[:, None, :], cand[None, :, :], pred_rel[:, None, :])

        return mix_modal_scores(
            dist_e(q_t, cand_t), dist_e(q_i, cand_i), dist_e(q_t, cand_i),
            dist_e(q_i, cand_t), tm, finetune=True,
        )  # (B, E)


class IKRLAnalogy(nn.Module):
    """ANALOGY scorer variant (IKRL.py:582-845): complex bilinear + real
    DistMult term; image vectors substitute only the real part."""

    def __init__(self, cfg: IKRLConfig, visual_features: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        d, E, R = cfg.dim, cfg.num_entities, cfg.num_relations
        for name, num, width in (("ent_re", E, d), ("ent_im", E, d), ("rel_re", R, d),
                                 ("rel_im", R, d), ("ent", E, 2 * d), ("rel", R, 2 * d)):
            table = Embed(num, width)
            xavier_uniform_(table.embedding, g)
            setattr(self, name, table)
        self.img_project = dense(cfg.visual_dim, 2 * d, g, xavier=True)
        self.visual = _VisualTable(cfg, visual_features, g)

    def _img_emb(self, idx):
        return self.img_project(self.visual(idx))

    def _all_ids(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.rel.embedding.device)

    def _energies(self, h_idx, t_idx, r_idx):
        """Returns (tt, ii, ti, it) energies with shared complex parts."""
        h_re, h_im = self.ent_re(h_idx), self.ent_im(h_idx)
        t_re, t_im = self.ent_re(t_idx), self.ent_im(t_idx)
        r_re, r_im = self.rel_re(r_idx), self.rel_im(r_idx)
        h, t, r = self.ent(h_idx), self.ent(t_idx), self.rel(r_idx)
        h_img, t_img = self._img_emb(h_idx), self._img_emb(t_idx)

        def e(hh, tt):
            return analogy_energy(h_re, h_im, hh, t_re, t_im, tt, r_re, r_im, r)

        return e(h, t), e(h_img, t_img), e(h, t_img), e(h_img, t)

    def forward(self, batch_h, batch_t, batch_r, task_mode):
        tt, ii, ti, it = self._energies(batch_h, batch_t, batch_r)
        return mix_modal_scores(tt, ii, ti, it, task_mode, finetune=False)

    def candidate_energies(self, h_idx, r_idx, task_mode, corrupt: str = "tail"):
        all_idx = self._all_ids(self.cfg.num_entities)
        c_re, c_im = self.ent_re(all_idx), self.ent_im(all_idx)
        c, c_img = self.ent(all_idx), self._img_emb(all_idx)
        h_re, h_im = self.ent_re(h_idx), self.ent_im(h_idx)
        h, h_img = self.ent(h_idx), self._img_emb(h_idx)
        r_re, r_im = self.rel_re(r_idx), self.rel_im(r_idx)
        r = self.rel(r_idx)

        def expand(x):
            return x[:, None, :]

        def cand(x):
            return x[None, :, :]

        if corrupt == "tail":
            def e(hh, tt):
                return analogy_energy(
                    expand(h_re), expand(h_im), hh, cand(c_re), cand(c_im), tt,
                    expand(r_re), expand(r_im), expand(r),
                )

            tt_ = e(expand(h), cand(c))
            ii_ = e(expand(h_img), cand(c_img))
            ti_ = e(expand(h), cand(c_img))
            it_ = e(expand(h_img), cand(c))
        else:
            def e(hh, tt):
                return analogy_energy(
                    cand(c_re), cand(c_im), hh, expand(h_re), expand(h_im), tt,
                    expand(r_re), expand(r_im), expand(r),
                )

            tt_ = e(cand(c), expand(h))
            ii_ = e(cand(c_img), expand(h_img))
            ti_ = e(cand(c), expand(h_img))
            it_ = e(cand(c_img), expand(h))
        tm = task_mode[:, None]
        return mix_modal_scores(tt_, ii_, ti_, it_, tm, finetune=False)

    def finetune_scores(self, e_head, e_tail, q_head, task_mode):
        all_r = self._all_ids(self.cfg.num_relations)
        r_re_all, r_im_all = self.rel_re(all_r), self.rel_im(all_r)
        r_all = self.rel(all_r)

        def rel_energy(h_idx, t_idx):
            h_re, h_im = self.ent_re(h_idx)[:, None], self.ent_im(h_idx)[:, None]
            t_re, t_im = self.ent_re(t_idx)[:, None], self.ent_im(t_idx)[:, None]

            def e(hh, tt):
                return analogy_energy(
                    h_re, h_im, hh, t_re, t_im, tt,
                    r_re_all[None], r_im_all[None], r_all[None],
                )

            h, t = self.ent(h_idx)[:, None], self.ent(t_idx)[:, None]
            h_img = self._img_emb(h_idx)[:, None]
            t_img = self._img_emb(t_idx)[:, None]
            return e(h, t), e(h_img, t_img), e(h, t_img), e(h_img, t)

        tm = task_mode[:, None]
        tt, ii, ti, it = rel_energy(e_head, e_tail)
        r_scores = mix_modal_scores(tt, ii, ti, it, tm, finetune=True)  # (B, R)
        pred = torch.argmax(r_scores, dim=-1)  # first maximum, as jnp.argmax

        all_e = self._all_ids(self.cfg.num_entities)
        c_re, c_im = self.ent_re(all_e)[None], self.ent_im(all_e)[None]
        c, c_img = self.ent(all_e)[None], self._img_emb(all_e)[None]
        q_re, q_im = self.ent_re(q_head)[:, None], self.ent_im(q_head)[:, None]
        q, q_img = self.ent(q_head)[:, None], self._img_emb(q_head)[:, None]
        pr_re, pr_im = self.rel_re(pred)[:, None], self.rel_im(pred)[:, None]
        pr = self.rel(pred)[:, None]

        def e2(hh, tt):
            return analogy_energy(q_re, q_im, hh, c_re, c_im, tt, pr_re, pr_im, pr)

        return mix_modal_scores(
            e2(q, c), e2(q_img, c_img), e2(q, c_img), e2(q_img, c), tm,
            finetune=True,
        )

    def regularization(self, batch_h, batch_t, batch_r):
        """mean-square of involved embeddings (OpenKE regul_rate hook)."""
        terms = [
            self.ent_re(batch_h), self.ent_im(batch_h), self.ent(batch_h),
            self.ent_re(batch_t), self.ent_im(batch_t), self.ent(batch_t),
            self.rel_re(batch_r), self.rel_im(batch_r), self.rel(batch_r),
        ]
        return sum(torch.mean(x ** 2) for x in terms) / len(terms)


def create_ikrl(cfg: IKRLConfig, visual_features: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None):
    if cfg.scorer == "transe":
        return IKRLTransE(cfg, visual_features, generator)
    if cfg.scorer == "analogy":
        return IKRLAnalogy(cfg, visual_features, generator)
    raise ValueError(cfg.scorer)
