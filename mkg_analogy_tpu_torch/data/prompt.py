"""Prompt construction for analogy fine-tuning.

The port's own copy of the fine-tune half of ``mkg_analogy_tpu/data/
prompt.py``; the pre-train prompts (triple and pseudo-analogy formats) come
with the training slice. Token-id sequences are assembled directly and
always padded to ``max_seq_length``, so every batch has the same shape.

Fine-tune layout (6 [SEP]s, two segments, processor.py:760-761 parity):

  [CLS] [E_qh] a_text [SEP] [R] [SEP] [E_qt] c_text [SEP]
        [E_ah] d_text [SEP] [R] [SEP] [MASK] [SEP]

- ``sep_idx``   (6,)  positions of all [SEP] tokens; sep_idx[2] is the
                      example/question boundary used by the adaptive analogy
                      attention mask (modeling_unimo.py:342-349).
- ``rel_idx``   (2,)  positions of the two [R] tokens (relaxation loss).
- ``q_head_idx``/``a_head_idx``  positions of the question-pair head entity
                      and the answer-pair head entity.
- ``mask_idx``        position of [MASK].
- ``label``           analogy-entity answer index in [0, 2063).
- ``img0/img1``       global entity indices whose image features fill the two
                      visual slots (-1 → zero features), per-mode assignment
                      matching processor.py:155-217 + data_module.py:121-160.

Truncation reproduces HF ``truncation="longest_first"``: tokens are removed
one at a time from the end of the currently-longer segment (ties remove from
the first segment) until the pair + 3 special tokens fit ``max_seq_length``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .readers import MARS, AnalogyExample
from .vocab import KGVocab


def truncate_longest_first(a: List[int], b: Optional[List[int]], budget: int) -> None:
    """In-place longest-first truncation of token lists ``a`` (and ``b``)."""
    if b is None:
        del a[budget:]
        return
    overflow = len(a) + len(b) - budget
    for _ in range(max(0, overflow)):
        if len(a) > len(b):
            a.pop()
        else:
            b.pop()


@dataclass
class EncodedExample:
    input_ids: np.ndarray
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    label: int
    extras: Dict[str, object]


class PromptBuilder:
    def __init__(self, vocab: KGVocab, max_seq_length: int = 128):
        self.vocab = vocab
        self.markg = vocab.markg
        self.max_seq_length = max_seq_length
        self._text_cache: Dict[str, List[int]] = {}

    def _tok(self, text: str) -> List[int]:
        hit = self._text_cache.get(text)
        if hit is None:
            hit = self.vocab.tokenizer.encode(text)
            self._text_cache[text] = hit
        return list(hit)

    def _pad(self, ids: List[int]) -> Tuple[np.ndarray, np.ndarray]:
        L = self.max_seq_length
        assert len(ids) <= L, (len(ids), L)
        arr = np.full((L,), self.vocab.pad_id, dtype=np.int32)
        arr[: len(ids)] = ids
        mask = np.zeros((L,), dtype=np.int32)
        mask[: len(ids)] = 1
        return arr, mask

    def encode_analogy(self, ex: AnalogyExample, mars: MARS) -> EncodedExample:
        """MARS fine-tune example: label indexes the 2,063 analogy entities
        (processor.py:760-761)."""
        v = self.vocab
        ent2id = self.markg.ent2id
        ent2text = self.markg.entity2text

        # Mode-dependent text content (processor.py:155-217).
        if ex.mode == 0:  # (T,T) -> (I,?)
            a_text, c_text, d_text = ent2text[ex.head], ent2text[ex.tail], ""
            img0, img1 = ex.question, None
        elif ex.mode == 1:  # (I,I) -> (T,?)
            a_text, c_text, d_text = "", "", ent2text[ex.question]
            img0, img1 = ex.head, ex.tail
        elif ex.mode == 2:  # (I,T) -> (I,?)
            a_text, c_text, d_text = "", ent2text[ex.tail], ""
            img0, img1 = ex.head, ex.question
        else:
            raise ValueError(f"bad mode {ex.mode}")

        e_qh = v.entity_id(ent2id[ex.head])
        e_qt = v.entity_id(ent2id[ex.tail])
        e_ah = v.entity_id(ent2id[ex.question])
        R = v.r_token_id
        SEPt = v.sep_id

        seg_a = [e_qh] + self._tok(a_text) + [SEPt, R, SEPt, e_qt] + self._tok(c_text)
        seg_b = [e_ah] + self._tok(d_text) + [SEPt, R, SEPt, v.mask_id]
        truncate_longest_first(seg_a, seg_b, self.max_seq_length - 3)

        ids = [v.cls_id] + seg_a + [SEPt] + seg_b + [SEPt]
        tt = [0] * (len(seg_a) + 2) + [1] * (len(seg_b) + 1)
        if v.mask_id not in ids:
            raise AssertionError("mask token must survive truncation")

        sep_idx = [i for i, t in enumerate(ids) if t == SEPt]
        if len(sep_idx) != 6:
            raise AssertionError(
                f"expected 6 [SEP]s, got {len(sep_idx)} (seq too short for texts?)"
            )
        rel_positions = [i for i, t in enumerate(ids) if t == R]
        assert len(rel_positions) == 2, rel_positions
        mask_pos = ids.index(v.mask_id)

        input_ids, attn = self._pad(ids)
        tt_arr = np.zeros((self.max_seq_length,), dtype=np.int32)
        tt_arr[: len(tt)] = tt

        extras = dict(
            rel_label=mars.analogy_rel2id[ex.relation],
            sep_idx=np.array(sep_idx, dtype=np.int32),
            rel_idx=np.array(rel_positions, dtype=np.int32),
            q_head_idx=1,
            a_head_idx=len(seg_a) + 2,
            mask_idx=mask_pos,
            img0=ent2id[img0] if img0 is not None else -1,
            img1=ent2id[img1] if img1 is not None else -1,
            mode=ex.mode,
        )
        return EncodedExample(
            input_ids=input_ids,
            attention_mask=attn,
            token_type_ids=tt_arr,
            label=mars.analogy_ent2id[ex.answer],
            extras=extras,
        )


def stack_features(examples: Sequence[EncodedExample]) -> Dict[str, np.ndarray]:
    """Stack per-example features into a dict of arrays (the on-disk /
    in-memory dataset representation)."""
    out: Dict[str, np.ndarray] = {
        "input_ids": np.stack([e.input_ids for e in examples]),
        "attention_mask": np.stack([e.attention_mask for e in examples]),
        "token_type_ids": np.stack([e.token_type_ids for e in examples]),
        "label": np.array([e.label for e in examples], dtype=np.int32),
    }
    keys = examples[0].extras.keys()
    for k in keys:
        vals = [e.extras[k] for e in examples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.array(
            vals, dtype=np.int32
        )
    return out


def build_finetune_features(
    mars: MARS, vocab: KGVocab, split: str, max_seq_length: int = 128
) -> Dict[str, np.ndarray]:
    pb = PromptBuilder(vocab, max_seq_length)
    return stack_features([pb.encode_analogy(ex, mars) for ex in mars.split(split)])
