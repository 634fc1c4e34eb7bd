"""Bag-of-words and TF-IDF vectorizers: the port of
``deeplearning4j_tpu/nlp/vectorizer.py``
(``bagofwords/vectorizer/{BagOfWordsVectorizer,TfidfVectorizer}.java``).

Fit a vocabulary over a corpus (the port's ``nlp/text.py`` tokenizers and
``nlp/vocab.py`` cache), then turn documents into count or tf-idf vectors:
dense float32 host arrays that a DataSet feeds to a classifier. The same
corpus gives the reference's vectors exactly.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence as Seq

import numpy as np

from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabWord


class BagOfWordsVectorizer:
    """Counts per vocab word (``BagOfWordsVectorizer.java``)."""

    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1,
                 stop_words: Optional[Seq[str]] = None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words or ())
        self.vocab = AbstractCache()
        self.doc_count = 0
        self._doc_freq = {}

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer_factory.create(text).get_tokens()
                if t and t not in self.stop_words]

    def fit(self, documents: Iterable[str]) -> "BagOfWordsVectorizer":
        for doc in documents:
            self.doc_count += 1
            toks = self._tokens(doc)
            for t in toks:
                self.vocab.add_token(VocabWord(t))
            for t in set(toks):
                self._doc_freq[t] = self._doc_freq.get(t, 0) + 1
        self.vocab.truncate(self.min_word_frequency)
        self.vocab.update_words_occurrences()
        return self

    def transform(self, text: str) -> np.ndarray:
        vec = np.zeros(self.vocab.num_words(), np.float32)
        for t in self._tokens(text):
            i = self.vocab.index_of(t)
            if i >= 0:
                vec[i] += 1.0
        return vec

    def transform_documents(self, documents: Iterable[str]) -> np.ndarray:
        return np.stack([self.transform(d) for d in documents])


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf·idf with idf = log(N / df) (``TfidfVectorizer.java``)."""

    def idf(self, word: str) -> float:
        df = self._doc_freq.get(word, 0)
        if df == 0:
            return 0.0
        return math.log(self.doc_count / df)

    def transform(self, text: str) -> np.ndarray:
        counts = super().transform(text)
        total = counts.sum()
        if total == 0:
            return counts
        out = np.zeros_like(counts)
        for i in range(len(counts)):
            if counts[i] > 0:
                w = self.vocab.word_at_index(i)
                out[i] = (counts[i] / total) * self.idf(w)
        return out
