"""Prompt construction for analogy fine-tuning and KG pre-training.

The port's own copy of ``mkg_analogy_tpu/data/prompt.py``. Token-id
sequences are assembled directly and always padded to ``max_seq_length``,
so every batch has the same shape.

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

Pre-train emits two single-segment examples per triple
(processor.py:98-149): ``pre_type=1`` link prediction
``[CLS] [E_h] h_text [SEP] [REL_r] r_text [SEP] [MASK] [SEP]`` with the tail
entity as label, and ``pre_type=2`` relation prediction
``[CLS] [E_h] h_text [SEP] [MASK] [SEP] [E_t] t_text [SEP]`` with the
relation as label. Modality of h/t is drawn 0.4 (T,T) / 0.3 (I,T) / 0.3 (I,I).
The pseudo-analogy format puts MarKG triples of one relation into the
fine-tune layout, labels over the whole MarKG entity range.

Truncation reproduces HF ``truncation="longest_first"``: tokens are removed
one at a time from the end of the currently-longer segment (ties remove from
the first segment) until the pair + 3 special tokens fit ``max_seq_length``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .readers import MARS, AnalogyExample, MarKG
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

    # ------------------------------------------------------------ finetune
    def encode_analogy(self, ex: AnalogyExample, mars: MARS) -> EncodedExample:
        """MARS fine-tune example: label indexes the 2,063 analogy entities
        (processor.py:760-761)."""
        return self._encode_analogy_core(
            ex,
            label=mars.analogy_ent2id[ex.answer],
            rel_label=mars.analogy_rel2id[ex.relation],
        )

    def encode_pseudo_analogy(self, ex: AnalogyExample) -> EncodedExample:
        """MarKG pseudo-analogy pre-train example: the fine-tune prompt
        layout, with the GLOBAL MarKG entity index of the answer as label and
        the global relation index as rel_label (the JAX package's addition
        beyond the reference's single-triple pretrain prompts)."""
        return self._encode_analogy_core(
            ex,
            label=self.markg.ent2id[ex.answer],
            rel_label=self.markg.rel2id[ex.relation],
        )

    def _encode_analogy_core(
        self, ex: AnalogyExample, label: int, rel_label: int
    ) -> EncodedExample:
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
            rel_label=rel_label,
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
            label=label,
            extras=extras,
        )

    # ------------------------------------------------------------ pretrain
    def encode_pretrain_triple(
        self, h: str, r: str, t: str, rng: np.random.Generator
    ) -> List[EncodedExample]:
        """Two examples per triple (link pred + relation pred) with a shared
        modality draw: <=0.4 (T,T), <0.7 (I,T), else (I,I)."""
        v = self.vocab
        ent2id, rel2id = self.markg.ent2id, self.markg.rel2id
        rnd = float(rng.random())
        if rnd <= 0.4:
            h_text, t_text = self.markg.entity2text[h], self.markg.entity2text[t]
            h_img, t_img = None, None
        elif rnd < 0.7:
            h_text, t_text = "", self.markg.entity2text[t]
            h_img, t_img = h, None
        else:
            h_text, t_text = "", ""
            h_img, t_img = h, t

        e_h = v.entity_id(ent2id[h])
        e_t = v.entity_id(ent2id[t])
        rel_tok = v.relation_id(rel2id[r])
        rel_text = self.markg.relation2text[r]
        SEPt = v.sep_id
        img0 = ent2id[h_img] if h_img is not None else -1

        def example(seg, label, pre_type, img1):
            truncate_longest_first(seg, None, self.max_seq_length - 2)
            ids = [v.cls_id] + seg + [SEPt]
            if v.mask_id not in ids:
                raise AssertionError("mask token must survive truncation")
            input_ids, attn = self._pad(ids)
            return EncodedExample(
                input_ids=input_ids,
                attention_mask=attn,
                token_type_ids=np.zeros((self.max_seq_length,), dtype=np.int32),
                label=label,
                extras=dict(pre_type=pre_type, mask_idx=ids.index(v.mask_id),
                            img0=img0, img1=img1),
            )

        return [
            # pre_type=1: (h, r, [MASK]) -> tail entity
            example([e_h] + self._tok(h_text) + [SEPt, rel_tok] + self._tok(rel_text)
                    + [SEPt, v.mask_id], ent2id[t], 1, -1),
            # pre_type=2: (h, [MASK], t) -> relation
            example([e_h] + self._tok(h_text) + [SEPt, v.mask_id, SEPt, e_t]
                    + self._tok(t_text), rel2id[r], 2,
                    ent2id[t_img] if t_img is not None else -1),
        ]


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


def build_pseudo_analogy_features(
    markg: MarKG,
    vocab: KGVocab,
    max_seq_length: int = 128,
    seed: int = 1,
    partners_per_triple: int = 2,
) -> Dict[str, np.ndarray]:
    """MarKG pseudo-analogies in the fine-tune prompt layout.

    For every training triple (h, r, t), sample ``partners_per_triple``
    other triples (h', r, t') of the SAME relation (h' != h) and emit the
    analogy (h, t) :: (h', [MASK] -> t') with the mode draw 0.4 / 0.3 / 0.3
    (processor.py:102). Labels are global entity indices; the masked-entity
    objective + relaxation loss run with the fine-tune geometry."""
    pb = PromptBuilder(vocab, max_seq_length)
    rng = np.random.default_rng(seed)
    by_rel: Dict[str, List[Tuple[str, str]]] = {}
    for h, r, t in markg.triples:
        if h in markg.ent2id and t in markg.ent2id and r in markg.rel2id:
            by_rel.setdefault(r, []).append((h, t))
    examples: List[EncodedExample] = []
    for r, pairs in by_rel.items():
        if len(pairs) < 2:
            continue
        n = len(pairs)
        for i, (h, t) in enumerate(pairs):
            for _ in range(partners_per_triple):
                # partner with a DIFFERENT head: (h,t)::(h,t') is the same
                # question twice
                h2 = h
                for _try in range(8):
                    j = int(rng.integers(n - 1))
                    j = j + (j >= i)  # uniform over pairs excluding self
                    h2, t2 = pairs[j]
                    if h2 != h:
                        break
                if h2 == h:
                    continue
                mode = int(rng.choice([0, 1, 2], p=[0.4, 0.3, 0.3]))
                ex = AnalogyExample(head=h, tail=t, question=h2, answer=t2,
                                    relation=r, mode=mode)
                examples.append(pb.encode_pseudo_analogy(ex))
    feats = stack_features(examples)
    n_ent = vocab.entity_id_ed - vocab.entity_id_st
    bad = (feats["label"] < 0) | (feats["label"] >= n_ent)
    if bad.any():
        raise ValueError(f"{int(bad.sum())} labels outside [0, {n_ent})")
    return feats


def build_pretrain_features(
    markg: MarKG, vocab: KGVocab, max_seq_length: int = 96, seed: int = 1
) -> Dict[str, np.ndarray]:
    pb = PromptBuilder(vocab, max_seq_length)
    rng = np.random.default_rng(seed)
    examples: List[EncodedExample] = []
    for h, r, t in markg.triples:
        if h not in markg.ent2id or t not in markg.ent2id or r not in markg.rel2id:
            continue  # drop triples without text (processor.py:650-658)
        examples.extend(pb.encode_pretrain_triple(h, r, t, rng))
    feats = stack_features(examples)
    # Host-side label-range checks: the eval step scores relation rows
    # against the relation logit slice, so a relation-type label outside
    # [0, num_relations) would give a wrong rank without an error.
    is_rel = feats["pre_type"] == 2
    n_rel = vocab.relation_id_ed - vocab.relation_id_st
    n_ent = vocab.entity_id_ed - vocab.entity_id_st
    if is_rel.any():
        bad = (feats["label"][is_rel] < 0) | (feats["label"][is_rel] >= n_rel)
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} pre_type=2 rows have relation labels "
                f"outside [0, {n_rel})"
            )
    ent_labels = feats["label"][~is_rel]
    if ent_labels.size and ((ent_labels < 0) | (ent_labels >= n_ent)).any():
        raise ValueError(f"entity labels outside [0, {n_ent})")
    return feats
