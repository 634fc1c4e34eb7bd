"""Byte-pair-encoding tokenizer (train, encode, decode, persist): the
port of ``deeplearning4j_tpu/nlp/bpe.py``.

Classic BPE (Sennrich-style) over whitespace-split words with an
end-of-word marker. ``train`` counts symbol-pair frequencies over the
word histogram and merges the most frequent pair until ``vocab_size`` is
reached (ties broken as the reference breaks them); ``encode`` applies
the merges in rank order a word (cached), characters never seen in
training map to ``<unk>``; ``decode`` inverts it; the JSON file is the
reference's, so a tokenizer saved by either package loads in the other
with the same merges, vocabulary and ids. Its ids feed the TransformerLM.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["BpeTokenizer"]

_EOW = "</w>"
_UNK = "<unk>"


class BpeTokenizer:
    def __init__(self, merges: Optional[List[Tuple[str, str]]] = None,
                 vocab: Optional[Dict[str, int]] = None):
        self.merges: List[Tuple[str, str]] = list(merges or [])
        self.vocab: Dict[str, int] = dict(vocab or {})
        self._ranks = {pair: i for i, pair in enumerate(self.merges)}
        self._cache: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 1000,
              min_frequency: int = 2) -> "BpeTokenizer":
        """Learn merges from an iterable of text lines."""
        histogram: Counter = Counter()
        for line in corpus:
            for word in line.split():
                histogram[word] += 1
        # word -> current symbol sequence
        words = {w: tuple(w) + (_EOW,) for w in histogram}
        symbols = {s for seq in words.values() for s in seq}
        merges: List[Tuple[str, str]] = []
        while len(symbols) + len(merges) < vocab_size:
            pairs: Counter = Counter()
            for w, seq in words.items():
                f = histogram[w]
                for a, b in zip(seq, seq[1:]):
                    pairs[(a, b)] += f
            if not pairs:
                break
            (a, b), freq = pairs.most_common(1)[0]
            if freq < min_frequency:
                break
            merged = a + b
            merges.append((a, b))
            new_words = {}
            for w, seq in words.items():
                out = []
                i = 0
                while i < len(seq):
                    if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                new_words[w] = tuple(out)
            words = new_words
        # vocab: <unk> + all final symbols + all merge products, stable order
        tokens = [_UNK] + sorted(symbols) + [a + b for a, b in merges]
        seen = set()
        vocab = {}
        for t in tokens:
            if t not in seen:
                vocab[t] = len(vocab)
                seen.add(t)
        return cls(merges, vocab)

    # ------------------------------------------------------------------
    # encode / decode
    # ------------------------------------------------------------------
    def _bpe_word(self, word: str) -> List[str]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        seq = list(word) + [_EOW]
        while len(seq) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(seq, seq[1:])):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            seq[best:best + 2] = [seq[best] + seq[best + 1]]
        self._cache[word] = seq
        return seq

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in text.split():
            out.extend(self._bpe_word(word))
        return out

    def encode(self, text: str) -> List[int]:
        unk = self.vocab[_UNK]
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]

    def decode(self, ids: Iterable[int]) -> str:
        if not self.vocab:
            return ""
        rev = getattr(self, "_rev", None)
        if rev is None or len(rev) != len(self.vocab):
            rev = self._rev = {i: t for t, i in self.vocab.items()}
        toks = [rev.get(int(i), _UNK) for i in ids]
        text = "".join(toks)
        return text.replace(_EOW, " ").strip()

    def vocab_size(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"merges": [list(m) for m in self.merges],
                           "vocab": self.vocab})

    @classmethod
    def from_json(cls, s: str) -> "BpeTokenizer":
        d = json.loads(s)
        return cls([tuple(m) for m in d["merges"]], d["vocab"])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path) as f:
            return cls.from_json(f.read())
