"""OpenKE-format dataset export + constraint/category generators.

Covers the reference's ``data/analogy`` artifacts (K9):
- ``entity2id.txt`` / ``relation2id.txt`` / ``train2id.txt`` (+ test/valid)
  with count headers;
- ``{train,valid,test}2id_ft.txt`` — MARS 6-tuples for finetuning
  (IKRL.py:944-953 format: "eh et q a r mode");
- ``type_constrain.txt`` + 1-1/1-n/n-1/n-n splits
  (M-KGE/IKRL_TransAE/data/analogy/n-n.py semantics: per-relation average
  heads-per-tail / tails-per-head thresholded at 1.5).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

Triple = Tuple[int, int, int]  # (h, t, r) — OpenKE column order


def write_id_files(out_dir: str, markg, mars=None, splits=None) -> None:
    """Export MarKG (+ optional MARS finetune tuples) as an OpenKE dir."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "entity2id.txt"), "w") as f:
        f.write(f"{markg.num_entities}\n")
        for e, i in markg.ent2id.items():
            f.write(f"{e}\t{i}\n")
    with open(os.path.join(out_dir, "relation2id.txt"), "w") as f:
        f.write(f"{markg.num_relations}\n")
        for r, i in markg.rel2id.items():
            f.write(f"{r}\t{i}\n")
    triples = markg.triples_as_ids()  # (h, r, t)
    splits = splits or {"train": triples}
    for name, rows in splits.items():
        with open(os.path.join(out_dir, f"{name}2id.txt"), "w") as f:
            f.write(f"{len(rows)}\n")
            for h, r, t in rows:
                f.write(f"{h} {t} {r}\n")
    if mars is not None:
        for split, fname in (("train", "train2id_ft.txt"),
                             ("dev", "valid2id_ft.txt"),
                             ("test", "test2id_ft.txt")):
            with open(os.path.join(out_dir, fname), "w") as f:
                for ex in mars.split(split):
                    f.write(
                        f"{markg.ent2id[ex.head]} {markg.ent2id[ex.tail]} "
                        f"{markg.ent2id[ex.question]} {markg.ent2id[ex.answer]} "
                        f"{markg.rel2id[ex.relation]} {ex.mode}\n"
                    )


def write_type_constraints(out_dir: str, *triple_lists: Sequence[Triple]) -> str:
    """type_constrain.txt: per relation, the entity sets observed as head
    and as tail across all splits (OpenKE n-n.py format)."""
    heads: Dict[int, set] = defaultdict(set)
    tails: Dict[int, set] = defaultdict(set)
    for rows in triple_lists:
        for h, t, r in rows:
            heads[r].add(h)
            tails[r].add(t)
    rels = sorted(set(heads) | set(tails))
    path = os.path.join(out_dir, "type_constrain.txt")
    with open(path, "w") as f:
        f.write(f"{len(rels)}\n")
        for r in rels:
            hs = sorted(heads[r])
            ts = sorted(tails[r])
            f.write(f"{r}\t{len(hs)}\t" + "\t".join(map(str, hs)) + "\n")
            f.write(f"{r}\t{len(ts)}\t" + "\t".join(map(str, ts)) + "\n")
    return path


def relation_categories(
    train: Sequence[Triple], threshold: float = 1.5
) -> Dict[int, str]:
    """Per-relation category by avg heads-per-tail (hpt) and tails-per-head
    (tph): 1-1, 1-n, n-1, n-n (n-n.py semantics)."""
    t_of_hr: Dict[Tuple[int, int], set] = defaultdict(set)
    h_of_tr: Dict[Tuple[int, int], set] = defaultdict(set)
    rels = set()
    for h, t, r in train:
        rels.add(r)
        t_of_hr[(h, r)].add(t)
        h_of_tr[(t, r)].add(h)
    out = {}
    for r in rels:
        tph = np.mean([len(v) for (h, rr), v in t_of_hr.items() if rr == r])
        hpt = np.mean([len(v) for (t, rr), v in h_of_tr.items() if rr == r])
        if hpt < threshold and tph < threshold:
            out[r] = "1-1"
        elif hpt < threshold <= tph:
            out[r] = "1-n"
        elif hpt >= threshold > tph:
            out[r] = "n-1"
        else:
            out[r] = "n-n"
    return out


def write_category_splits(
    out_dir: str, train: Sequence[Triple], test: Sequence[Triple],
    threshold: float = 1.5,
) -> List[str]:
    """Split test triples by relation category into 1-1.txt .. n-n.txt."""
    cats = relation_categories(train, threshold)
    buckets: Dict[str, List[Triple]] = {k: [] for k in ("1-1", "1-n", "n-1", "n-n")}
    for h, t, r in test:
        buckets[cats.get(r, "n-n")].append((h, t, r))
    paths = []
    for name, rows in buckets.items():
        p = os.path.join(out_dir, f"{name}.txt")
        with open(p, "w") as f:
            f.write(f"{len(rows)}\n")
            for h, t, r in rows:
                f.write(f"{h} {t} {r}\n")
        paths.append(p)
    return paths
