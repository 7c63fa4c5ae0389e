"""Self-contained BERT-style WordPiece tokenizer.

The reference pipeline loads ``bert-base-uncased`` from the HuggingFace hub
(MarT/data/data_module.py:188). This framework must run fully offline, so
we ship:

- a BERT-compatible *basic* tokenizer (lowercasing, accent stripping,
  punctuation splitting, CJK isolation),
- a greedy longest-match WordPiece encoder with ``##`` continuations,
- a WordPiece *trainer* (pair-likelihood merges, as in the canonical
  WordPiece algorithm) so a vocabulary can be built from the KG corpus itself,
- loading of a standard ``vocab.txt`` (one token per line) so a stock BERT
  vocabulary can be dropped in for checkpoint parity when available.

Special tokens occupy fixed low ids: [PAD]=0 [UNK]=1 [CLS]=2 [SEP]=3 [MASK]=4.
"""

from __future__ import annotations

import collections
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = [PAD, UNK, CLS, SEP, MASK]


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """BERT-uncased basic tokenization: clean, lowercase, strip accents,
    split punctuation, isolate CJK characters."""

    def __init__(self, lowercase: bool = True):
        self.lowercase = lowercase

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        out: List[str] = []
        for tok in text.split():
            if self.lowercase:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return out

    @staticmethod
    def _clean(text: str) -> str:
        buf = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            buf.append(" " if _is_whitespace(ch) else ch)
        return "".join(buf)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        buf = []
        for ch in text:
            if _is_cjk(ord(ch)):
                buf.append(" ")
                buf.append(ch)
                buf.append(" ")
            else:
                buf.append(ch)
        return "".join(buf)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(p) for p in out if p]


class WordPieceTokenizer:
    """Greedy longest-match WordPiece encoder over a fixed vocabulary."""

    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(lowercase)
        self.max_chars_per_word = max_chars_per_word
        for tok in SPECIAL_TOKENS:
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.mask_id = self.vocab[MASK]

    def __len__(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------------------ IO
    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        """Load a standard BERT ``vocab.txt`` (one token per line).

        If the file does not place the special tokens at 0..4 (stock BERT
        puts [PAD] at 0 but [UNK]/[CLS]/[SEP]/[MASK] at 100..103), the ids in
        the file win — only presence is required.
        """
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, lowercase=lowercase)

    def save_vocab(self, path: str) -> None:
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in items:
                f.write(tok + "\n")

    @classmethod
    def load(cls, directory: str) -> "WordPieceTokenizer":
        cfg_path = os.path.join(directory, "tokenizer_config.json")
        lowercase = True
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                lowercase = json.load(f).get("lowercase", True)
        return cls.from_vocab_file(os.path.join(directory, "vocab.txt"), lowercase)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.save_vocab(os.path.join(directory, "vocab.txt"))
        with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
            json.dump({"lowercase": self.basic.lowercase, "type": "wordpiece"}, f)

    # -------------------------------------------------------------- encode
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids for raw text — no special tokens added."""
        return [self.vocab[t] for t in self.tokenize(text)]

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.inv_vocab.get(int(i), UNK) for i in ids]
        out: List[str] = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] = out[-1] + t[2:]
            else:
                out.append(t)
        return " ".join(out)


def train_wordpiece_vocab(
    corpus: Iterable[str],
    vocab_size: int = 8192,
    lowercase: bool = True,
    min_pair_freq: int = 2,
    whole_word_min_freq: int = 3,
    whole_word_budget_frac: float = 0.5,
    extra_tokens: Optional[List[str]] = None,
) -> Dict[str, int]:
    """Train a WordPiece vocabulary.

    Two phases, like production BERT vocabularies: (1) the most frequent
    whole words enter the vocab directly (up to ``whole_word_budget_frac`` of
    the budget); (2) the remainder is filled by likelihood-scored WordPiece
    merges — repeatedly merge the adjacent-piece pair maximizing
    ``freq(ab) / (freq(a) * freq(b))`` until ``vocab_size`` is reached or no
    pair clears ``min_pair_freq``.
    """
    basic = BasicTokenizer(lowercase)
    word_freq: collections.Counter = collections.Counter()
    for line in corpus:
        for w in basic.tokenize(line):
            word_freq[w] += 1

    # Split each word into characters; first char bare, rest ##-prefixed.
    splits: Dict[str, List[str]] = {
        w: [w[0]] + ["##" + c for c in w[1:]] for w in word_freq
    }

    vocab: Dict[str, int] = {t: i for i, t in enumerate(SPECIAL_TOKENS)}

    def add(tok: str) -> None:
        if tok not in vocab:
            vocab[tok] = len(vocab)

    # ASCII alphabet floor so the encoder rarely hits [UNK] on clean text.
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        add(c)
        add("##" + c)
    for w, pieces in splits.items():
        for p in pieces:
            add(p)

    # Phase 1: frequent whole words (greedy longest-match will prefer them).
    whole_budget = int(vocab_size * whole_word_budget_frac)
    for w, f in word_freq.most_common():
        if whole_budget <= 0 or len(vocab) >= vocab_size:
            break
        if f < whole_word_min_freq or len(w) < 2 or w in vocab:
            continue
        add(w)
        whole_budget -= 1
    # Whole words also count as merged splits so pair statistics don't
    # re-derive them during phase 2.
    for w in list(splits.keys()):
        if w in vocab and len(splits[w]) > 1:
            splits[w] = [w]

    # Incremental pair/piece frequency bookkeeping: each merge touches only
    # the words that actually contain the merged pair (indexed below), so
    # training the full vocabulary is ~O(corpus + merges·avg_word_hits).
    pair_freq: collections.Counter = collections.Counter()
    piece_freq: collections.Counter = collections.Counter()
    pair_words: Dict[tuple, set] = collections.defaultdict(set)
    for w, pieces in splits.items():
        f = word_freq[w]
        for p in pieces:
            piece_freq[p] += f
        for pr in zip(pieces, pieces[1:]):
            pair_freq[pr] += f
            pair_words[pr].add(w)

    def _account(w: str, pieces: List[str], sign: int) -> None:
        f = word_freq[w] * sign
        for p in pieces:
            piece_freq[p] += f
        for pr in zip(pieces, pieces[1:]):
            pair_freq[pr] += f
            if sign > 0:
                pair_words[pr].add(w)

    while len(vocab) < vocab_size:
        best, best_score = None, 0.0
        for pr, f in pair_freq.items():
            if f < min_pair_freq:
                continue
            denom = piece_freq[pr[0]] * piece_freq[pr[1]]
            if denom <= 0:
                continue
            score = f / denom
            if score > best_score:
                best, best_score = pr, score
        if best is None:
            break
        a, b = best
        merged = a + b[2:] if b.startswith("##") else a + b
        add(merged)
        for w in list(pair_words[(a, b)]):
            pieces = splits[w]
            _account(w, pieces, -1)
            out: List[str] = []
            i = 0
            while i < len(pieces):
                if i + 1 < len(pieces) and pieces[i] == a and pieces[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(pieces[i])
                    i += 1
            splits[w] = out
            _account(w, out, +1)
        pair_freq.pop((a, b), None)
        pair_words.pop((a, b), None)

    if extra_tokens:
        for t in extra_tokens:
            add(t)
    return vocab
