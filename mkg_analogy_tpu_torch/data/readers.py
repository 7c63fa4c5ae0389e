"""Readers for the MarKG background KG and the MARS analogy benchmark.

File formats (reference: MarT/dataset/):
- ``entity2text.txt`` / ``entity2textlong.txt`` — ``<qid>\t<text>`` per line
  (11,292 entities).
- ``relation2text.txt`` / ``relation2textlong.txt`` — ``<pid>\t<text>``
  (192 relations).
- ``wiki_tuple_ids.txt`` — ``<head>\t<rel>\t<tail>`` triples (33,307).
- ``MARS/{train,dev,test}.json`` — JSON lines with keys
  ``example`` ([head, tail]), ``question``, ``answer``, ``relation``,
  ``mode`` (0: (T,T)->(I,?), 1: (I,I)->(T,?), 2: (I,T)->(I,?)).
- ``MARS/analogy_entities.txt`` / ``analogy_relations.txt`` — the candidate
  answer subsets (2,063 entities / 27 relations).

Parity anchors: MarT/data/processor.py:472-500 (_read_txt/_read_dict_txt/
_read_json) and processor.py:607-643 (id-map construction order).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple


def read_kv_txt(path: str) -> Dict[str, str]:
    """Read a tab-separated ``key\tvalue`` file, preserving line order."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            key, value = line.split("\t", 1)
            out[key] = value.rstrip("\n")
    return out


def read_triples(path: str) -> List[Tuple[str, str, str]]:
    triples: List[Tuple[str, str, str]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            h, r, t = line.rstrip("\n").split("\t")
            triples.append((h, r, t))
    return triples


def read_lines(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


@dataclass(frozen=True)
class AnalogyExample:
    """One MARS analogy: (head : tail) :: (question : answer), via relation.

    ``mode`` selects the modality split (0/1/2 per dataset README).
    """

    head: str
    tail: str
    question: str
    answer: str
    relation: str
    mode: int


class MarKG:
    """The background multimodal KG used for pre-training."""

    def __init__(self, root: str, prefer_long_text: bool = True):
        self.root = root
        long_path = os.path.join(root, "entity2textlong.txt")
        # Reference prefers entity2textlong.txt when present (processor.py:509).
        if prefer_long_text and os.path.exists(long_path):
            self.entity2text = read_kv_txt(long_path)
        else:
            self.entity2text = read_kv_txt(os.path.join(root, "entity2text.txt"))
        self.relation2text = read_kv_txt(os.path.join(root, "relation2text.txt"))
        self.entities: List[str] = list(self.entity2text.keys())
        self.relations: List[str] = list(self.relation2text.keys())
        self.ent2id = {e: i for i, e in enumerate(self.entities)}
        self.rel2id = {r: i for i, r in enumerate(self.relations)}
        self.triples = read_triples(os.path.join(root, "wiki_tuple_ids.txt"))

    @property
    def num_entities(self) -> int:
        return len(self.entities)

    @property
    def num_relations(self) -> int:
        return len(self.relations)

    def triples_as_ids(self, drop_unknown: bool = True) -> List[Tuple[int, int, int]]:
        """(head_id, rel_id, tail_id) triples; entities/relations without a
        text entry are dropped (processor.py:650-658 parity)."""
        out = []
        for h, r, t in self.triples:
            if h in self.ent2id and t in self.ent2id and r in self.rel2id:
                out.append((self.ent2id[h], self.rel2id[r], self.ent2id[t]))
            elif not drop_unknown:
                raise KeyError(f"unknown id in triple ({h},{r},{t})")
        return out


class MARS:
    """The MARS analogical-reasoning dataset (fine-tune / eval)."""

    def __init__(self, root: str, markg: MarKG):
        self.root = root
        self.markg = markg
        self.analogy_entities = read_lines(os.path.join(root, "analogy_entities.txt"))
        self.analogy_relations = read_lines(os.path.join(root, "analogy_relations.txt"))
        # analogy answer-id space, enumerated in *entity-file order* filtered
        # by analogy membership (processor.py:629-633 parity).
        ent_set = set(self.analogy_entities)
        self.analogy_ent2id: Dict[str, int] = {}
        for e in markg.entities:
            if e in ent_set:
                self.analogy_ent2id[e] = len(self.analogy_ent2id)
        rel_set = set(self.analogy_relations)
        self.analogy_rel2id: Dict[str, int] = {}
        for r in markg.relations:
            if r in rel_set:
                self.analogy_rel2id[r] = len(self.analogy_rel2id)

    @property
    def num_analogy_entities(self) -> int:
        return len(self.analogy_ent2id)

    @property
    def num_analogy_relations(self) -> int:
        return len(self.analogy_rel2id)

    def split(self, name: str) -> List[AnalogyExample]:
        assert name in ("train", "dev", "test"), name
        out: List[AnalogyExample] = []
        with open(os.path.join(self.root, f"{name}.json"), encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                out.append(
                    AnalogyExample(
                        head=d["example"][0],
                        tail=d["example"][1],
                        question=d["question"],
                        answer=d["answer"],
                        relation=d["relation"],
                        mode=int(d["mode"]),
                    )
                )
        return out
