"""Plain fp32 fine-tune objective, AdamW and ranking of MarT
(``lit_models/transformer.py``, ``lit_models/utils.py``).

- loss = label-smoothed CE over the analogy entities (the target puts
  ``1 - s`` on the label and ``s / C`` on every other class) + alpha x the
  relaxation loss mean(relu(cos(q_head, a_head)) + 1 - cos(rel_ex, rel_q));
- AdamW (eps 1e-8, betas 0.9 / 0.999) with decoupled weight decay on every
  leaf but biases and LayerNorm scales, the learning rate 0 at step 0,
  rising linearly over the warm-up fraction of the steps, then falling
  linearly to 0;
- the rank of the gold entity under a stable descending sort: 1 + the
  scores above it + the equal scores of lower index; a gold score that is
  not finite ranks last; Hits@k, mean rank and MRR in float32.
"""

from __future__ import annotations

from typing import Dict

import torch


def label_smoothed_ce(logits, labels, smoothing: float):
    logp = torch.log_softmax(logits, dim=-1)
    c = logits.shape[-1]
    label_logp = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    lb_pos, lb_neg = 1.0 - smoothing, smoothing / c
    return -((lb_pos - lb_neg) * label_logp + lb_neg * logp.sum(dim=-1)).mean()


def _cos(a, b, eps=1e-8):
    floor = a.new_tensor(eps)
    na = torch.maximum(torch.linalg.vector_norm(a, dim=-1), floor)
    nb = torch.maximum(torch.linalg.vector_norm(b, dim=-1), floor)
    return (a * b).sum(dim=-1) / (na * nb)


def relaxation(q_head, a_head, rel_ex, rel_q):
    cos = _cos(q_head, a_head)
    return (torch.maximum(cos, torch.zeros_like(cos)) + 1.0 - _cos(rel_ex, rel_q)).mean()


def finetune_loss(trans, logits, labels, alpha: float, smoothing: float):
    """(loss, ce, sim) of a batch: ``trans`` (B, 5, H) the gathered states."""
    ce = label_smoothed_ce(logits, labels, smoothing)
    sim = relaxation(trans[:, 3], trans[:, 4], trans[:, 1], trans[:, 2])
    return ce + alpha * sim, ce, sim


def learning_rate(lr: float, total_steps: int, warmup_ratio: float, step: int) -> float:
    warm = max(1, int(total_steps * warmup_ratio))
    decay = max(1, total_steps - warm)
    if step < warm:
        return lr * min(max(step, 0), warm) / warm
    return lr * (1.0 - min(step - warm, decay) / decay)


def is_layer_norm_scale(name: str) -> bool:
    """A LayerNorm's scale: ``<module>.weight`` of a module named ``ln``,
    ``ln1``, ``ln2`` or ending in ``_ln``."""
    module, _, leaf = name.rpartition(".")
    module = module.rpartition(".")[2]
    return leaf == "weight" and (module in ("ln", "ln1", "ln2") or module.endswith("_ln"))


def decays(name: str) -> bool:
    return not (name.rpartition(".")[2] == "bias" or is_layer_norm_scale(name))


class AdamW:
    """Decoupled-decay Adam over a flat dict of fp32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.wd = {n: weight_decay if decays(n) else 0.0 for n in params}
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1.0 - lr * self.wd[n])
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def ranks(scores, labels):
    """(B,) int64 1-based ranks of ``labels`` in ``scores`` (B, C)."""
    labels = labels.long()
    gold = torch.gather(scores, 1, labels[:, None])
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    r = (scores > gold).sum(1) + ((scores == gold) & (col < labels[:, None])).sum(1) + 1
    return torch.where(torch.isfinite(gold[:, 0]), r, torch.full_like(r, scores.shape[1]))


def rank_metrics(r, ks=(1, 3, 5, 10, 20)) -> Dict[str, float]:
    r = torch.as_tensor(r).to(torch.float32)
    out = {f"hits{k}": float((r <= k).to(torch.float32).mean()) for k in ks}
    out["mean_rank"] = float(r.mean())
    out["mrr"] = float((1.0 / r).mean())
    return out
