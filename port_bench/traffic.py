"""The one traffic generator: a MARS-like split of analogy examples in the
port's feature layout, drawn from a seed and a traffic file's parameters.

A traffic file (``port_bench/traffic/<name>.json``) gives:

- ``examples``: the split's size; ``mode_counts``: how many of them are of
  each MARS mode (0: (T,T) -> (I,?), one image; 1: (I,I) -> (T,?) and 2:
  (I,T) -> (I,?), two images), summing to ``examples``;
- ``batch_size``; ``max_seq_length``, the padded length every batch has;
  ``prompt_length``: [shortest, longest], drawn uniformly per example;
- ``split``: "train" (shuffled batches, the remainder dropped) or "dev"
  (in order, the last batch padded).

Every seed gives the same sizes: the same examples, modes, padded length
and batch count. The seed draws the tokens, the prompt lengths, the entity
images and the labels, and the order of the modes.

The prompt layout is MarT's fine-tune prompt (``data/prompt.py`` of the
program documents the same one)::

  [CLS] e_qh a_text [SEP] [R] [SEP] e_qt c_text [SEP] e_ah d_text [SEP] [R] [SEP] [MASK] [SEP]

with the text that the mode puts in a, c or d; the positions of the six
[SEP]s, the two [R]s, the two heads and [MASK] are features of their own.
The vocabulary's special ids and ranges come from the configuration.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

FIXED_TOKENS = 13  # [CLS], e_qh, 6 x [SEP], 2 x [R], e_qt, e_ah, [MASK]


def load(root: Path, name: str) -> dict:
    traffic = json.loads((Path(root) / "port_bench" / "traffic" / f"{name}.json").read_text())
    if sum(traffic["mode_counts"]) != traffic["examples"]:
        raise ValueError(f"traffic {name}: mode_counts do not sum to examples")
    lo, hi = traffic["prompt_length"]
    if not FIXED_TOKENS + 3 <= lo <= hi <= traffic["max_seq_length"]:
        raise ValueError(f"traffic {name}: prompt_length {lo}-{hi} outside "
                         f"{FIXED_TOKENS + 3}-{traffic['max_seq_length']}")
    return traffic


def make_split(traffic: dict, config: dict, seed: int) -> Dict[str, np.ndarray]:
    """The split's features: (N, L) int32 ``input_ids``, ``attention_mask``,
    ``token_type_ids``; (N,) ``label`` in [0, entities), ``mask_idx``,
    ``q_head_idx``, ``a_head_idx``, ``img0``, ``img1`` (-1: no image),
    ``mode``; (N, 6) ``sep_idx``; (N, 2) ``rel_idx``."""
    rng = np.random.default_rng(seed)
    n, length = traffic["examples"], traffic["max_seq_length"]
    vocab, n_ent = config["vocab"], config["analogy_entities"]
    modes = np.repeat(np.arange(3), traffic["mode_counts"])
    rng.shuffle(modes)
    lo, hi = traffic["prompt_length"]
    lengths = rng.integers(lo, hi + 1, size=n)
    text = lengths - FIXED_TOKENS
    # the mode's text: mode 0 in a and c, mode 1 in d, mode 2 in c
    cut = rng.integers(0, text + 1)
    ta = np.where(modes == 0, cut, 0)
    tc = np.where(modes == 0, text - cut, np.where(modes == 2, text, 0))
    td = np.where(modes == 1, text, 0)

    word_lo, word_hi = vocab["word_tokens"]
    ids = rng.integers(word_lo, word_hi, size=(n, length)).astype(np.int32)
    ent_tokens = vocab["entity_token_start"] + rng.integers(0, n_ent, size=(n, 3))
    rows = np.arange(n)
    sep1 = 2 + ta                      # after e_qh a_text
    sep3 = 6 + ta + tc                 # the example / question boundary
    sep4 = 8 + ta + tc + td
    mask_pos = 11 + ta + tc + td
    seps = np.stack([sep1, sep1 + 2, sep3, sep4, sep4 + 2, lengths - 1], axis=1)
    rels = np.stack([sep1 + 1, sep4 + 1], axis=1)
    ids[:, 0] = vocab["cls_id"]
    ids[rows, 1] = ent_tokens[:, 0]
    ids[rows, sep1 + 3] = ent_tokens[:, 1]
    ids[rows, sep3 + 1] = ent_tokens[:, 2]
    for j in range(6):
        ids[rows, seps[:, j]] = vocab["sep_id"]
    ids[rows[:, None], rels] = vocab["r_id"]
    ids[rows, mask_pos] = vocab["mask_id"]
    col = np.arange(length)[None, :]
    attention_mask = (col < lengths[:, None]).astype(np.int32)
    ids = np.where(attention_mask == 1, ids, vocab["pad_id"]).astype(np.int32)
    token_type = ((col > sep3[:, None]) & (col < lengths[:, None])).astype(np.int32)

    ent = rng.integers(0, n_ent, size=(n, 2)).astype(np.int32)
    img1 = np.where(modes == 0, -1, ent[:, 1]).astype(np.int32)
    return dict(
        input_ids=ids, attention_mask=attention_mask, token_type_ids=token_type,
        label=rng.integers(0, n_ent, size=n).astype(np.int32),
        sep_idx=seps.astype(np.int32), rel_idx=rels.astype(np.int32),
        q_head_idx=np.ones(n, np.int32), a_head_idx=(sep3 + 1).astype(np.int32),
        mask_idx=mask_pos.astype(np.int32), img0=ent[:, 0], img1=img1,
        mode=modes.astype(np.int32))


def batch_order(traffic: dict, seed: int, epochs_drawn: int = 1) -> np.ndarray:
    """The example order of a shuffled training epoch as the program's
    iterator draws it: ``np.random.default_rng(seed)``, one permutation of
    the split a draw, and the epoch is draw number ``epochs_drawn + 1``
    (the trainer draws one before its first epoch)."""
    rng = np.random.default_rng(seed)
    order = np.arange(traffic["examples"])
    for _ in range(epochs_drawn + 1):
        order = np.arange(traffic["examples"])
        rng.shuffle(order)
    return order

