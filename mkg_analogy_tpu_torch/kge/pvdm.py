"""PV-DM document vectors (TransAE's text modality;
``mkg_analogy_tpu/kge/pvdm.py``).

The reference trains gensim Doc2Vec (PV-DM) over entity glossaries
(TransAE.py:21-65) to get 100-d text vectors per entity. gensim is not a
dependency, so the same objective is trained here: predict a center word
from the mean of its context-word vectors and the document vector, with
sampled negatives — one step over a batch of the whole corpus's windows.
The windows, their order and the negatives are drawn with numpy exactly as
the JAX package draws them; the initial tables come from a
``torch.Generator`` (or from ``tables``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..train.optim import global_norm

_TOKEN_RE = re.compile(r"[a-z]{2,15}")


def simple_preprocess(text: str) -> List[str]:
    """gensim.utils.simple_preprocess-like tokenization: lowercase ASCII
    alpha tokens of length 2..15."""
    return _TOKEN_RE.findall(text.lower())


@dataclass
class PVDMConfig:
    vector_size: int = 100
    window: int = 4
    min_count: int = 2
    epochs: int = 40
    negatives: int = 5
    lr: float = 0.01
    batch_size: int = 4096
    seed: int = 1


def _build_vocab(docs: Sequence[List[str]], min_count: int) -> Dict[str, int]:
    freq: Dict[str, int] = {}
    for d in docs:
        for w in d:
            freq[w] = freq.get(w, 0) + 1
    words = [w for w, c in sorted(freq.items()) if c >= min_count]
    return {w: i for i, w in enumerate(words)}


def _training_windows(docs, vocab, window, rng):
    doc_ids, centers, contexts = [], [], []
    for di, doc in enumerate(docs):
        ids = [vocab[w] for w in doc if w in vocab]
        for i, c in enumerate(ids):
            lo, hi = max(0, i - window), min(len(ids), i + window + 1)
            ctx = ids[lo:i] + ids[i + 1 : hi]
            if not ctx:
                continue
            ctx = ctx[: 2 * window]
            ctx = ctx + [ctx[-1]] * (2 * window - len(ctx))  # pad to fixed width
            doc_ids.append(di)
            centers.append(c)
            contexts.append(ctx)
    order = rng.permutation(len(doc_ids))
    return (
        np.asarray(doc_ids, np.int32)[order],
        np.asarray(centers, np.int32)[order],
        np.asarray(contexts, np.int32)[order],
    )


def pvdm_loss(p: Dict[str, torch.Tensor], d_ids, ctr, ctx, neg) -> torch.Tensor:
    """Negative-sampling PV-DM loss of one batch of windows."""
    dvec = F.embedding(d_ids, p["doc"])  # (B, H)
    wvec = torch.mean(F.embedding(ctx, p["word"]), dim=1)  # (B, H)
    h = (dvec + wvec) / 2.0
    pos = F.embedding(ctr, p["out"])  # (B, H)
    negv = F.embedding(neg, p["out"])  # (B, N, H)
    pos_logit = torch.sum(h * pos, dim=-1)
    neg_logit = torch.einsum("bh,bnh->bn", h, negv)
    return -torch.mean(F.logsigmoid(pos_logit)
                       + torch.sum(F.logsigmoid(-neg_logit), dim=-1))


def train_pvdm(texts: Sequence[str], cfg: PVDMConfig = PVDMConfig(), device="cpu",
               tables: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
    """Returns (len(texts), vector_size) float32 document vectors.
    ``tables``: the initial ``doc`` (D, H) and ``word`` (V, H) tables
    (default: U(-0.5/H, 0.5/H) from a generator seeded with ``cfg.seed``);
    ``out`` starts at zero."""
    docs = [simple_preprocess(t) for t in texts]
    vocab = _build_vocab(docs, cfg.min_count)
    if not vocab:
        return np.zeros((len(texts), cfg.vector_size), np.float32)
    V, D, H = len(vocab), len(texts), cfg.vector_size
    rng = np.random.default_rng(cfg.seed)
    doc_ids, centers, contexts = _training_windows(docs, vocab, cfg.window, rng)
    if len(doc_ids) == 0:
        return np.zeros((D, H), np.float32)

    if tables is None:
        g = torch.Generator().manual_seed(cfg.seed)
        init = {name: torch.empty(n, H).uniform_(-0.5 / H, 0.5 / H, generator=g)
                for name, n in (("doc", D), ("word", V))}
    else:
        init = {name: torch.tensor(np.asarray(tables[name], np.float32))
                for name in ("doc", "word")}
    params = {name: t.to(device).requires_grad_() for name, t in init.items()}
    params["out"] = torch.zeros(V, H, device=device, requires_grad=True)
    leaves = list(params.values())
    # clip: the sampled-softmax objective can spike on rare-word batches
    # (optax.clip_by_global_norm(1.0), then Adam)
    adam = torch.optim.Adam(leaves, lr=cfg.lr)

    def to_dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    n = len(doc_ids)
    bs = min(cfg.batch_size, n)
    n_batches = max(1, n // bs)
    for epoch in range(cfg.epochs):
        for b in range(n_batches):
            sl = slice(b * bs, (b + 1) * bs)
            neg = rng.integers(0, V, size=(sl.stop - sl.start, cfg.negatives))
            adam.zero_grad(set_to_none=True)
            loss = pvdm_loss(params, to_dev(doc_ids[sl]), to_dev(centers[sl]),
                             to_dev(contexts[sl]), to_dev(neg))
            loss.backward()
            with torch.no_grad():
                grads = [p.grad for p in leaves]
                norm = global_norm(grads)
                keep = norm < 1.0
                for grad in grads:
                    grad.copy_(torch.where(keep, grad, grad / norm))
            adam.step()
    return params["doc"].detach().cpu().numpy().astype(np.float32)
