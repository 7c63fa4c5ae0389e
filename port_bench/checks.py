"""What decides ``correct``: the program's outputs against the plain reference.

Fine-tune cells. The first ``check_steps`` steps of the program's fit (set-up
runs them through ``MarTTrainer.fit``, the window's own call and feed, on
the same trainer the window then drives) against the reference's steps on
the same weights, batches, pixels and dropout seeds:

- ``loss_gap``: the largest relative gap of a step's loss, and
  ``loss_gap_first`` that of the first step;
- ``state_gap_max``: the first step's forward (before any update), read
  by a forward hook on the program's model: the largest over the batch's
  examples of the relative gap of its five gathered states (mask, the two
  relations, the two heads) from the reference's, so that a fault in a few
  examples shows (``state_gap_p90``, ``state_gap_median``: the 90th
  percentile and the median; ``state_gap_mode_median``: the largest over
  the batch's analogy modes of the median of that mode's examples);
- ``loss_consistency``: the program's first loss against the objective the
  reference computes from the program's own first states and the initial
  weights (CE over the decoder's logits + alpha x relaxation), relative
  (see ``first_objective``);
- ``grad_gap``: the first step's gradient, as AdamW holds it after that step
  (exp_avg / 0.1), leaf by leaf: the largest gap between the program's and
  the reference's norm of a leaf, over the larger of the reference's norm of
  that leaf and of the median leaf; ``grad_gap_median``: the median leaf's
  gap by the same measure, which a fault in a backward kernel moves through
  every leaf below it;
- ``change_gap``: the same of each leaf's change over the steps, leaving out
  the leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone, as a key's bias under softmax).

Evaluation cells. Every pass of the window dumps its ranks; each is judged
against the reference's logits of the same examples. An example's rank gap
is how far the reference's logits must move to give the program's rank (the
smallest t such that the rank lies between 1 + #{logit > gold + t} and 1 +
#{logit >= gold - t}), over the standard deviation of its logits:

- ``rank_gap_median``: the median rank gap of a pass's examples (the
  largest over the passes);
- ``ranks_unexplained``: the examples, over all passes, whose rank gap
  exceeds the cell's ``unexplained_std``;
- ``metric_mismatch``: how many of a pass's Hits@k / mean-rank / MRR values
  differ from the reference's arithmetic on the program's own ranks.

A cell compares the numbers its ``limits`` name; the others are printed.

The reference runs after the window, once the program's state is freed, in
blocks of one batch, with TF32 off (``numerics`` picks the control's lower
precision).
"""

from __future__ import annotations

import statistics
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import traffic as traffic_mod
from .reference.layers import DropoutDraws, Numerics, step_seed
from .reference.objective import AdamW, finetune_loss, learning_rate, rank_metrics, ranks

ACTIVE_GRAD = 1e-3   # a leaf takes part in change_gap from this share of the median gradient
FINETUNE_NUMBERS = ("loss_gap", "loss_gap_first", "state_gap_max", "state_gap_p90",
                    "state_gap_median", "state_gap_mode_median", "loss_consistency", "grad_gap", "grad_gap_median",
                    "change_gap")
METRIC_KEYS = ("hits1", "hits3", "hits5", "hits10", "hits20", "mean_rank", "mrr")


def _fp32_matmuls(tf32: bool = False) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _batch(run, idx):
    dev = run.device
    b = {k: torch.as_tensor(v[idx], device=dev) for k, v in run.features.items()}
    pad = run.pixels.shape[0] - 1
    img = torch.stack([b["img0"], b["img1"]], dim=1).long()
    img = torch.where((img >= 0) & (img < pad), img, pad)
    pixels = run.pixels[img].to(torch.float32)
    positions = torch.stack([b["mask_idx"], b["rel_idx"][:, 0], b["rel_idx"][:, 1],
                             b["q_head_idx"], b["a_head_idx"]], dim=1)
    return b, pixels, positions


def _entity_ids(run):
    start = run.config["vocab"]["entity_token_start"]
    return torch.arange(start, start + run.config["analogy_entities"], device=run.device)


def reference_finetune(run, num: Optional[Numerics] = None, tf32: bool = False,
                       alter: Optional[Callable] = None) -> Dict[str, object]:
    """The reference's first ``check_steps`` steps: each step's loss, the
    first gradient's norm by leaf and each leaf's change. ``alter(batch,
    pixels, positions)`` plants a fault in the batch the reference takes."""
    _fp32_matmuls(tf32)
    num, cell, cfg = num or Numerics(), run.cell, run.config
    opt_cfg = run.train_config
    params0 = run.make_params()
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in params0.items()}
    opt = AdamW(leaves, opt_cfg.weight_decay)
    order = traffic_mod.batch_order(run.traffic, run.seed)
    steps, b = cell["check_steps"], run.batch
    ids = _entity_ids(run)
    losses, grad_norms, first = [], None, {}
    for step in range(steps):
        batch, pixels, positions = _batch(run, order[step * b:(step + 1) * b])
        if alter is not None:
            batch, pixels, positions = alter(batch, pixels, positions)
        draws = DropoutDraws(step_seed(run.seed, step), run.device)
        trans = run.ref.forward(leaves, cfg, batch, pixels, positions, draws, num)
        logits = run.ref.logits(leaves, trans[:, 0], ids, num)
        loss, _, _ = finetune_loss(trans, logits, batch["label"], opt_cfg.alpha,
                                   opt_cfg.label_smoothing)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(leaves, grads)}
        if step == 0:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            first = dict(states=trans.detach().clone(), labels=batch["label"].clone(),
                         modes=batch["mode"].clone())
        opt.step(grads, learning_rate(opt_cfg.lr, steps, opt_cfg.warmup_ratio, step))
        losses.append(float(loss.detach()))
        del trans, logits, loss, grads
    change = {n: float((leaves[n].detach() - params0[n]).norm()) for n in leaves}
    _fp32_matmuls(False)
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change, **first)


@torch.no_grad()
def first_objective(run, states, labels) -> float:
    """The objective of ``states`` (B, 5, H) and ``labels`` under the
    initial weights, in fp32 but for the decoder's product, whose operands
    are rounded to the cell's compute dtype as the configuration states
    (bf16 operands, an fp32 sum)."""
    _fp32_matmuls(False)
    params = run.make_params()
    states = states.to(torch.float32)
    num = Numerics("bf16" if run.dtype == "bfloat16" else "fp32")
    logits = run.ref.logits(params, states[:, 0], _entity_ids(run), num)
    loss, _, _ = finetune_loss(states, logits, labels, run.train_config.alpha,
                               run.train_config.label_smoothing)
    return float(loss)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names=None) -> Dict[str, float]:
    """Each leaf's |got - want| / max(want, median want)."""
    names = list(want) if names is None else list(names)
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names}


def _worst(gaps: Dict[str, float]):
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def finetune_readings(run, got: Dict[str, object], want: Dict[str, object]) -> Dict[str, float]:
    """The numbers of a fine-tune check, of ``got`` against ``want`` (each:
    losses, grad_norms, change_norms, the first step's states; ``want`` the
    reference's, with the first batch's labels)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    states, ref_states = got["states"].to(torch.float32), want["states"]
    if states.shape == ref_states.shape:
        per_example = ((states - ref_states).flatten(1).norm(dim=1)
                       / ref_states.flatten(1).norm(dim=1))
        modes = want["modes"]
        state = dict(state_gap_max=float(per_example.max()),
                     state_gap_p90=float(per_example.quantile(0.9)),
                     state_gap_median=float(per_example.median()),
                     state_gap_mode_median=max(float(per_example[modes == m].median())
                                               for m in modes.unique()))
        own = first_objective(run, states, want["labels"])
        consistency = abs(got["losses"][0] - own) / abs(own)
    else:  # rows missing from the program's forward
        state = dict.fromkeys(("state_gap_max", "state_gap_p90", "state_gap_median",
                               "state_gap_mode_median"), float("inf"))
        consistency = float("inf")
    grads = leaf_gaps(got["grad_norms"], want["grad_norms"])
    grad_gap, grad_leaf = _worst(grads)
    med = statistics.median(want["grad_norms"].values())
    active = [n for n, g in want["grad_norms"].items() if g >= ACTIVE_GRAD * med]
    change_gap, change_leaf = _worst(leaf_gaps(got["change_norms"], want["change_norms"],
                                               active))
    return dict(loss_gap=max(gaps), loss_gap_first=gaps[0], **state,
                loss_consistency=consistency, grad_gap=grad_gap,
                grad_gap_median=statistics.median(grads.values()), change_gap=change_gap,
                grad_leaf=grad_leaf, change_leaf=change_leaf,
                left_out=len(want["grad_norms"]) - len(active))


def finetune(run) -> Dict[str, dict]:
    """The fine-tune check; a reading the program's steps did not give
    (no optimizer step, fewer steps) reads infinite."""
    got = dict(run.readings)
    want = reference_finetune(run)
    if (len(got.get("losses", ())) != len(want["losses"]) or "grad_norms" not in got
            or "change_norms" not in got or "states" not in got):
        r = dict.fromkeys(FINETUNE_NUMBERS, float("inf"))
    else:
        r = finetune_readings(run, got, want)
        print(f"worst leaves: grad {r['grad_leaf']}, change {r['change_leaf']}; "
              f"{r['left_out']} leaves out of change_gap", file=sys.stderr, flush=True)
    return _compared(run, r)


def _compared(run, readings):
    """The numbers the cell's ``limits`` name, each with its limit; the
    others printed to stderr."""
    limits = run.cell["limits"]
    for k, v in readings.items():
        if k not in limits and isinstance(v, float):
            print(f"{k} (not compared): {v!r}", file=sys.stderr)
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


@torch.no_grad()
def reference_logits(run, num: Optional[Numerics] = None, tf32: bool = False):
    """(N, entities) fp32 reference logits of the split, one batch a block."""
    _fp32_matmuls(tf32)
    num = num or Numerics()
    params = run.make_params()
    ids = _entity_ids(run)
    n, b = run.traffic["examples"], run.batch
    out = []
    for s in range(0, n, b):
        batch, pixels, positions = _batch(run, np.arange(s, min(s + b, n)))
        trans = run.ref.forward(params, run.config, batch, pixels, positions, None, num)
        out.append(run.ref.logits(params, trans[:, 0], ids, num))
    _fp32_matmuls(False)
    return torch.cat(out)


def rank_gap(rank, logits, labels) -> torch.Tensor:
    """(N,) the widest move of the reference logits that the ranks need,
    over each row's standard deviation (see the module's docstring)."""
    rank = torch.as_tensor(rank, device=logits.device).long()
    labels = torch.as_tensor(labels, device=logits.device).long()
    gold = torch.gather(logits, 1, labels[:, None])
    d = (logits - gold).scatter(1, labels[:, None], float("-inf"))
    desc = torch.sort(d, dim=1, descending=True).values
    need = rank - 1
    above = (d > 0).sum(1)
    up = -torch.gather(desc, 1, (need - 1).clamp(min=0)[:, None])[:, 0]
    down = torch.gather(desc, 1, need.clamp(max=d.shape[1] - 1)[:, None])[:, 0]
    t = torch.where(need > above, up, torch.where(need < above, down, torch.zeros_like(up)))
    return t.clamp(min=0) / logits.std(dim=1)


def eval_readings(gaps, unexplained_std: float) -> Dict[str, float]:
    """The numbers of one pass from its examples' rank gaps."""
    return dict(rank_gap_median=float(gaps.median()), rank_gap_max=float(gaps.max()),
                ranks_unexplained=int((gaps > unexplained_std).sum()))


def evaluate(run) -> Dict[str, dict]:
    logits = reference_logits(run)
    labels = run.features["label"]
    tau = run.cell["unexplained_std"]
    r = dict(rank_gap_median=0.0, rank_gap_max=0.0, ranks_unexplained=0, metric_mismatch=0)
    for i, metrics in enumerate(run.pass_metrics):
        with np.load(run.tmp / f"ranks_{i}.npz") as z:
            got = z["ranks"]
        if got.shape != labels.shape:  # rows missing from the pass's answers
            r = dict.fromkeys(r, float("inf"))
            break
        one = eval_readings(rank_gap(got, logits, labels), tau)
        r["rank_gap_median"] = max(r["rank_gap_median"], one["rank_gap_median"])
        r["rank_gap_max"] = max(r["rank_gap_max"], one["rank_gap_max"])
        r["ranks_unexplained"] += one["ranks_unexplained"]
        want = rank_metrics(torch.from_numpy(got))
        r["metric_mismatch"] += sum(metrics[f"Eval_entity/{k}"] != want[k] for k in METRIC_KEYS)
    return _compared(run, r)


def control_ranks(logits, labels):
    """The ranks a control's logits give (the reference's arithmetic)."""
    return ranks(logits, torch.as_tensor(labels, device=logits.device)).cpu().numpy()
