"""Vocabulary construction + Huffman coding for hierarchical softmax.

Parity surface: ``deeplearning4j-nlp`` —
``models/word2vec/wordstore/VocabConstructor.java:30`` (parallel scan →
``buildJointVocabulary:161``), vocab caches
(``models/word2vec/wordstore/inmemory/{AbstractCache,InMemoryLookupCache}.java``),
``models/word2vec/VocabWord.java`` / ``models/sequencevectors/sequence/
SequenceElement.java``, and the Huffman tree construction
(``models/word2vec/Huffman.java:34`` — frequency-sorted two-queue O(n) build,
codes limited to ``MAX_CODE_LENGTH=40``).

Host side, numpy only: vocab building is a one-pass corpus scan; the
integer code and path tables are packed into dense padded arrays
(:meth:`AbstractCache.huffman_arrays`), which the batched training step
(``lookup.py``) gathers from.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAX_CODE_LENGTH = 40


class SequenceElement:
    """An element in a trainable sequence (``SequenceElement.java``):
    holds frequency, index, and its Huffman code/path after tree build."""

    def __init__(self, label: str, frequency: float = 1.0):
        self.label = label
        self.element_frequency = float(frequency)
        self.index = -1
        self.codes: List[int] = []
        self.points: List[int] = []
        self.special = False  # labels (ParagraphVectors) are special: never subsampled

    def increment_frequency(self, by: float = 1.0) -> None:
        self.element_frequency += by

    def __repr__(self):
        return f"SequenceElement({self.label!r}, f={self.element_frequency})"


class VocabWord(SequenceElement):
    """``models/word2vec/VocabWord.java`` — a word element."""


class Sequence:
    """Ordered elements + optional sequence labels
    (``models/sequencevectors/sequence/Sequence.java``)."""

    def __init__(self, elements: Optional[List[SequenceElement]] = None):
        self.elements: List[SequenceElement] = list(elements) if elements else []
        self.labels: List[SequenceElement] = []

    def add_element(self, el: SequenceElement) -> None:
        self.elements.append(el)

    def set_sequence_label(self, label: SequenceElement) -> None:
        self.labels = [label]

    def add_sequence_label(self, label: SequenceElement) -> None:
        self.labels.append(label)

    def __len__(self):
        return len(self.elements)


class AbstractCache:
    """In-memory vocab store (``AbstractCache.java`` / ``InMemoryLookupCache.java``):
    label → element, index ↔ label maps, total word count."""

    def __init__(self):
        self._by_label: Dict[str, SequenceElement] = {}
        self._by_index: List[SequenceElement] = []
        self.total_word_count = 0.0

    # --- store API ---
    def contains_word(self, label: str) -> bool:
        return label in self._by_label

    def word_for(self, label: str) -> Optional[SequenceElement]:
        return self._by_label.get(label)

    def add_token(self, el: SequenceElement) -> None:
        have = self._by_label.get(el.label)
        if have is not None:
            have.increment_frequency(el.element_frequency)
        else:
            self._by_label[el.label] = el

    def word_frequency(self, label: str) -> float:
        el = self._by_label.get(label)
        return el.element_frequency if el else 0.0

    def index_of(self, label: str) -> int:
        el = self._by_label.get(label)
        return el.index if el else -1

    def word_at_index(self, index: int) -> Optional[str]:
        if 0 <= index < len(self._by_index):
            return self._by_index[index].label
        return None

    def element_at_index(self, index: int) -> SequenceElement:
        return self._by_index[index]

    def num_words(self) -> int:
        return len(self._by_index)

    def vocab_words(self) -> List[SequenceElement]:
        return list(self._by_index)

    def words(self) -> List[str]:
        return [el.label for el in self._by_index]

    # --- finalization ---
    def truncate(self, min_word_frequency: float) -> None:
        """Drop non-special elements below min frequency
        (``VocabConstructor.buildJointVocabulary`` filterVocab step)."""
        self._by_label = {
            k: v for k, v in self._by_label.items()
            if v.special or v.element_frequency >= min_word_frequency}

    def update_words_occurrences(self) -> None:
        """Assign indices by descending frequency (stable) and recompute totals
        — word2vec convention: index 0 = most frequent."""
        els = sorted(self._by_label.values(),
                     key=lambda e: (-e.element_frequency, e.label))
        self._by_index = els
        for i, el in enumerate(els):
            el.index = i
        self.total_word_count = float(
            sum(e.element_frequency for e in els if not e.special))

    # --- packed arrays for the batched step ---
    def huffman_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(codes, points, lengths) padded to the max code length in vocab:
        codes[i, l] ∈ {0,1}, points[i, l] = inner-node row in syn1,
        lengths[i] = true code length. Pad value for points = 0 (masked out)."""
        n = len(self._by_index)
        max_len = max((len(e.codes) for e in self._by_index), default=1) or 1
        codes = np.zeros((n, max_len), dtype=np.int32)
        points = np.zeros((n, max_len), dtype=np.int32)
        lengths = np.zeros((n,), dtype=np.int32)
        for i, el in enumerate(self._by_index):
            L = len(el.codes)
            codes[i, :L] = el.codes
            points[i, :L] = el.points
            lengths[i] = L
        return codes, points, lengths


class Huffman:
    """Huffman tree over vocab frequencies (``Huffman.java:34``).

    Assigns each element its binary code (root→leaf turns) and point path
    (inner-node indices, used as rows of syn1 in hierarchical softmax).
    """

    def __init__(self, elements: Sequence[SequenceElement]):
        self.elements = list(elements)

    def apply_indexes(self, cache: Optional[AbstractCache] = None) -> None:
        els = self.elements
        n = len(els)
        if n == 0:
            return
        if n == 1:
            els[0].codes, els[0].points = [0], [0]
            return
        # heap of (freq, tiebreak, node); leaves 0..n-1, inner nodes n..2n-2
        heap: List[Tuple[float, int, int]] = [
            (el.element_frequency, i, i) for i, el in enumerate(els)]
        heapq.heapify(heap)
        parent = np.zeros(2 * n - 1, dtype=np.int64)
        binary = np.zeros(2 * n - 1, dtype=np.int8)
        next_inner = n
        tiebreak = n
        while len(heap) > 1:
            f1, _, n1 = heapq.heappop(heap)
            f2, _, n2 = heapq.heappop(heap)
            parent[n1] = next_inner
            parent[n2] = next_inner
            binary[n2] = 1
            heapq.heappush(heap, (f1 + f2, tiebreak, next_inner))
            next_inner += 1
            tiebreak += 1
        root = 2 * n - 2
        for i, el in enumerate(els):
            codes: List[int] = []
            points: List[int] = []
            node = i
            while node != root:
                codes.append(int(binary[node]))
                points.append(int(parent[node]) - n)
                node = int(parent[node])
            codes.reverse()
            points.reverse()
            el.codes = codes[:MAX_CODE_LENGTH]
            el.points = points[:MAX_CODE_LENGTH]


class VocabConstructor:
    """Scan token sequences into an AbstractCache
    (``VocabConstructor.java:30``, ``buildJointVocabulary:161``)."""

    def __init__(self, min_word_frequency: float = 1,
                 element_cls=VocabWord):
        self.min_word_frequency = min_word_frequency
        self._element_cls = element_cls

    def build_joint_vocabulary(
            self,
            token_sequences: Iterable[Sequence],
            cache: Optional[AbstractCache] = None,
            build_huffman: bool = True) -> AbstractCache:
        from collections import Counter
        cache = cache or AbstractCache()
        token_counts: Counter = Counter()
        for seq in token_sequences:
            if not isinstance(seq, Sequence):
                # fast path: raw token list — C-speed counting, no per-token
                # element objects (final indices are frequency-sorted either
                # way, so merge order is irrelevant)
                token_counts.update(seq)
                continue
            for el in seq.elements:
                cache.add_token(self._element_cls(el.label, el.element_frequency))
            for lab in seq.labels:
                # labels are special: frequency counted once per doc, never truncated
                have = cache.word_for(lab.label)
                if have is None:
                    nl = self._element_cls(lab.label, 1.0)
                    nl.special = True
                    cache.add_token(nl)
                    cache.word_for(lab.label).special = True
                else:
                    have.increment_frequency(1.0)
        for t, c in token_counts.items():
            cache.add_token(self._element_cls(t, float(c)))
        cache.truncate(self.min_word_frequency)
        cache.update_words_occurrences()
        if build_huffman:
            Huffman(cache.vocab_words()).apply_indexes(cache)
        return cache
