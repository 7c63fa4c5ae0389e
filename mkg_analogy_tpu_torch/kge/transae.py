"""TransAE: multimodal autoencoder entity encoder + TransE scoring
(``mkg_analogy_tpu/kge/transae.py``; M-KGE/IKRL_TransAE/TransAE.py:430-923).

- ``IMGEncoder``: Doc2Vec text vector (100-d, kge/pvdm.py) and VGG image
  vector (4096-d) -> ReLU encoders -> combined hidden (dim) -> decoders;
  MSE reconstruction loss (TransAE.py:534-561);
- head entities are encoded multimodally, tails/relations use plain
  embedding tables (TransAE.py:563-633);
- the reference adds the scalar reconstruction loss onto the scores of
  image-mode rows (TransAE.py:634-641); we keep that convention.

The two frozen feature tables are buffers of the encoder
(``encoder.text_features``, ``encoder.visual_features``, the JAX package's
``frozen`` collection), and the layers carry the Flax names, so
``models.convert.params_from_jax`` maps the JAX variables onto them.

Deviation (documented, as in the JAX package): the reference encoder assigns
mode-2 rows a ZERO embedding (the v3 buffer is only written for task_mode
0/1, TransAE.py:546-548). We route every image mode (1 and 2) through the
combined encoder instead — zero rows train nothing and are clearly an
oversight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .ikrl import Embed, default_generator, dense, xavier_uniform_
from .scorers import transe_distance


@dataclass(frozen=True)
class TransAEConfig:
    num_entities: int
    num_relations: int
    dim: int = 200
    text_dim: int = 100
    visual_dim: int = 4096
    visual_hidden: int = 1024
    p_norm: int = 1
    norm_flag: bool = True


class IMGEncoder(nn.Module):
    """Multimodal autoencoder (TransAE.py:430-561)."""

    def __init__(self, cfg: TransAEConfig, text_features: Optional[np.ndarray] = None,
                 visual_features: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        n = cfg.num_entities + 1
        for name, data, width in (("text_features", text_features, cfg.text_dim),
                                  ("visual_features", visual_features, cfg.visual_dim)):
            if data is not None:
                assert data.shape == (n, width), (data.shape, (n, width))
                table = torch.tensor(np.asarray(data, np.float32))
            else:  # the JAX fallback's law: uniform(0.1), U[0, 0.1)
                table = torch.empty(n, width).uniform_(0.0, 0.1, generator=g)
            self.register_buffer(name, table)
        self.enc_text = dense(cfg.text_dim, cfg.dim, g)
        self.enc_visual = dense(cfg.visual_dim, cfg.visual_hidden, g)
        self.enc_combined = dense(cfg.dim + cfg.visual_hidden, cfg.dim, g)
        self.dec_text1 = dense(cfg.dim, cfg.dim, g)
        self.dec_visual1 = dense(cfg.dim, cfg.visual_hidden, g)
        self.dec_text2 = dense(cfg.dim, cfg.text_dim, g)
        self.dec_visual2 = dense(cfg.visual_hidden, cfg.visual_dim, g)

    def forward(self, entity_id, task_mode, finetune: bool = False,
                is_head: bool = True):
        v1_t = self.text_features[entity_id]
        v1_i = self.visual_features[entity_id]
        v2_t = torch.relu(self.enc_text(v1_t))  # (B, dim)
        v2_i = torch.relu(self.enc_visual(v1_i))  # (B, visual_hidden)
        combined = torch.relu(self.enc_combined(torch.cat([v2_t, v2_i], dim=-1)))

        if finetune and not is_head:
            return v2_t, torch.zeros((), device=v2_t.device)

        is_text = task_mode == 0
        v3 = torch.where(is_text[:, None], v2_t, combined)

        v4_t = torch.relu(self.dec_text1(v3))
        v4_i = torch.relu(self.dec_visual1(v3))
        v5_t = torch.relu(self.dec_text2(v4_t))
        v5_i = torch.relu(self.dec_visual2(v4_i))

        def masked_mse(a, b, m):
            se = torch.mean((a - b) ** 2, dim=-1)
            denom = torch.maximum(torch.sum(m.to(torch.float32)),
                                  torch.ones((), device=m.device))
            return torch.sum(torch.where(m, se, torch.zeros_like(se))) / denom

        recon = masked_mse(v1_t, v5_t, is_text) + masked_mse(v1_i, v5_i, ~is_text)
        return v3, recon


class TransAETransE(nn.Module):
    """TransE over autoencoded heads + plain tail/relation tables
    (TransAE.py:563-713)."""

    def __init__(self, cfg: TransAEConfig, text_features: Optional[np.ndarray] = None,
                 visual_features: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        self.tail_embeddings = Embed(cfg.num_entities, cfg.dim)
        self.rel_embeddings = Embed(cfg.num_relations, cfg.dim)
        xavier_uniform_(self.tail_embeddings.embedding, g)
        xavier_uniform_(self.rel_embeddings.embedding, g)
        self.encoder = IMGEncoder(cfg, text_features, visual_features, g)

    def _dist(self, h, t, r):
        return transe_distance(h, t, r, self.cfg.p_norm, self.cfg.norm_flag)

    def _all_ids(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.rel_embeddings.embedding.device)

    def forward(self, batch_h, batch_t, batch_r, task_mode):
        """Flat pretrain batch -> energies with the reconstruction loss
        added onto image-mode rows (TransAE.py:631-641)."""
        h, recon = self.encoder(batch_h, task_mode)
        t = self.tail_embeddings(batch_t)
        r = self.rel_embeddings(batch_r)
        score = self._dist(h, t, r)
        return torch.where(task_mode != 0, score + recon, score)

    def candidate_energies(self, h_idx, r_idx, task_mode, corrupt: str = "tail"):
        cfg = self.cfg
        cand = self.tail_embeddings(self._all_ids(cfg.num_entities))
        r = self.rel_embeddings(r_idx)
        if corrupt == "tail":
            h, _ = self.encoder(h_idx, task_mode)
            return self._dist(h[:, None, :], cand[None, :, :], r[:, None, :])
        # head corruption: every entity encoded as a head through the text
        # branch (task mode 0), as in the JAX package
        all_ids = self._all_ids(cfg.num_entities)
        all_h, _ = self.encoder(all_ids, torch.zeros_like(all_ids))
        t = self.tail_embeddings(h_idx)
        return self._dist(all_h[None, :, :], t[:, None, :], r[:, None, :])

    def finetune_scores(self, e_head, e_tail, q_head, task_mode):
        """Two-stage pipeline (TransAE.py:648-681)."""
        cfg = self.cfg
        h_eh, _ = self.encoder(e_head, task_mode, finetune=True, is_head=True)
        h_et, _ = self.encoder(e_tail, task_mode, finetune=True, is_head=False)
        rel_all = self.rel_embeddings(self._all_ids(cfg.num_relations))
        rel_score = self._dist(h_eh[:, None, :], h_et[:, None, :], rel_all[None, :, :])
        pred_rel = self.rel_embeddings(torch.argmax(rel_score, dim=-1))
        h_q, _ = self.encoder(q_head, task_mode, finetune=True, is_head=True)
        cand = self.tail_embeddings(self._all_ids(cfg.num_entities))
        return self._dist(h_q[:, None, :], cand[None, :, :], pred_rel[:, None, :])


def build_transae_inputs(markg, visual_store=None, pvdm_cfg=None,
                         device="cpu") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Assemble the frozen (E+1, text_dim)/(E+1, visual_dim) feature tables
    from entity glossaries (PV-DM, trained on ``device``) and a VGG feature
    store."""
    from .pvdm import PVDMConfig, train_pvdm

    cfg = pvdm_cfg or PVDMConfig()
    texts = [markg.entity2text[e] for e in markg.entities]
    doc_vecs = train_pvdm(texts, cfg, device=device)
    text = np.zeros((markg.num_entities + 1, cfg.vector_size), np.float32)
    text[: markg.num_entities] = doc_vecs
    if visual_store is not None:
        vis = np.zeros((markg.num_entities + 1, visual_store.shape[1]), np.float32)
        vis[: markg.num_entities] = visual_store
    else:
        vis = None
    return text, vis
