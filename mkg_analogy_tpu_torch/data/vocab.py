"""Joint text + KG vocabulary.

The reference injects 11,292 ``[ENTITY_i]`` and 192 ``[RELATION_j]`` special
tokens into a BERT tokenizer, plus a ``[R]`` analogy-relation token
(MarT/data/data_module.py:193,222; lit_models/transformer.py:41-54). We lay
the vocabulary out contiguously so id ranges are compile-time constants:

    [ 0 .. base)                    WordPiece text vocab (incl. [PAD],[MASK],…)
    [ base .. base+E)               entity tokens, in entity-file order
    [ base+E .. base+E+R)           relation tokens, in relation-file order
    base+E+R                        [R] — the shared analogy-relation slot
    [ base+E+R+1 .. padded_size)    padding rows (MXU-aligned embedding table)

``analogy_entity_ids`` / ``analogy_relation_ids`` are the global-vocab ids of
the MARS candidate subsets, used to slice MLM logits during fine-tuning
(transformer.py:95 parity).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..text.wordpiece import WordPieceTokenizer, train_wordpiece_vocab
from .readers import MARS, MarKG


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class KGVocab:
    tokenizer: WordPieceTokenizer
    markg: MarKG
    mars: Optional[MARS] = None
    pad_multiple: int = 128

    base_size: int = field(init=False)
    entity_id_st: int = field(init=False)
    entity_id_ed: int = field(init=False)
    relation_id_st: int = field(init=False)
    relation_id_ed: int = field(init=False)
    r_token_id: int = field(init=False)
    vocab_size: int = field(init=False)
    padded_vocab_size: int = field(init=False)
    analogy_entity_ids: np.ndarray = field(init=False)
    analogy_relation_ids: np.ndarray = field(init=False)

    def __post_init__(self):
        self.base_size = len(self.tokenizer)
        E, R = self.markg.num_entities, self.markg.num_relations
        self.entity_id_st = self.base_size
        self.entity_id_ed = self.base_size + E
        self.relation_id_st = self.entity_id_ed
        self.relation_id_ed = self.relation_id_st + R
        self.r_token_id = self.relation_id_ed
        self.vocab_size = self.r_token_id + 1
        self.padded_vocab_size = _round_up(self.vocab_size, self.pad_multiple)
        if self.mars is not None:
            self.analogy_entity_ids = np.array(
                [self.entity_id(self.markg.ent2id[e]) for e in self.mars.analogy_ent2id],
                dtype=np.int32,
            )
            self.analogy_relation_ids = np.array(
                [self.relation_id(self.markg.rel2id[r]) for r in self.mars.analogy_rel2id],
                dtype=np.int32,
            )
        else:
            self.analogy_entity_ids = np.zeros((0,), dtype=np.int32)
            self.analogy_relation_ids = np.zeros((0,), dtype=np.int32)

    # global-vocab ids ------------------------------------------------------
    def entity_id(self, ent_index: int) -> int:
        return self.entity_id_st + ent_index

    def relation_id(self, rel_index: int) -> int:
        return self.relation_id_st + rel_index

    @property
    def pad_id(self) -> int:
        return self.tokenizer.pad_id

    @property
    def mask_id(self) -> int:
        return self.tokenizer.mask_id

    @property
    def cls_id(self) -> int:
        return self.tokenizer.cls_id

    @property
    def sep_id(self) -> int:
        return self.tokenizer.sep_id

    def decode(self, ids) -> str:
        out = []
        for i in map(int, ids):
            if self.entity_id_st <= i < self.entity_id_ed:
                out.append(f"[ENTITY_{i - self.entity_id_st}]")
            elif self.relation_id_st <= i < self.relation_id_ed:
                out.append(f"[RELATION_{i - self.relation_id_st}]")
            elif i == self.r_token_id:
                out.append("[R]")
            elif i >= self.vocab_size:
                out.append("[VOCAB_PAD]")
            else:
                out.append(self.tokenizer.decode([i]))
        return " ".join(out)


def _corpus_fingerprint(markg: MarKG) -> str:
    h = hashlib.sha256()
    for text in list(markg.entity2text.values()) + list(markg.relation2text.values()):
        h.update(text.encode("utf-8"))
    return h.hexdigest()[:16]


def build_tokenizer(
    markg: MarKG,
    cache_dir: Optional[str] = None,
    vocab_file: Optional[str] = None,
    vocab_size: int = 8192,
) -> WordPieceTokenizer:
    """Get a text tokenizer: load ``vocab_file`` if given (stock BERT vocab
    works), else train a WordPiece vocab on the KG corpus (cached by corpus
    fingerprint + size)."""
    if vocab_file:
        return WordPieceTokenizer.from_vocab_file(vocab_file)
    if cache_dir:
        tag = f"wordpiece_{vocab_size}_{_corpus_fingerprint(markg)}"
        cached = os.path.join(cache_dir, tag)
        if os.path.exists(os.path.join(cached, "vocab.txt")):
            return WordPieceTokenizer.load(cached)
    corpus: List[str] = list(markg.entity2text.values())
    corpus += list(markg.relation2text.values())
    vocab = train_wordpiece_vocab(corpus, vocab_size=vocab_size)
    tok = WordPieceTokenizer(vocab)
    if cache_dir:
        tok.save(cached)
    return tok
