"""Word2Vec and ParagraphVectors: concrete models over SequenceVectors.

Carried over from the reference's ``nlp/word2vec.py`` (DL4J's
``Word2Vec``: sentence iterator and tokenizer factory over
SequenceVectors; ``ParagraphVectors``: label-aware iterators, DM/DBOW,
``inferVector``, ``predict``). Training runs on ``device`` (None means the
card); queries read the tables back to the host.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    CBOW, DBOW, DM, SequenceVectors, SkipGram)
from deeplearning4j_tpu_torch.nlp.text import (
    DefaultTokenizerFactory, LabelAwareIterator, SentenceIterator)
from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabWord


def _tokenize_to_sequences(sentences: Iterable[str], tokenizer_factory):
    """Yield raw token lists — SequenceVectors' fast path; building a
    ``Sequence`` of ``VocabWord`` objects per sentence would dominate runtime
    at text8 scale."""
    for s in sentences:
        toks = tokenizer_factory.create(s).get_tokens()
        if toks:
            yield toks


class Word2Vec(SequenceVectors):
    """``Word2Vec.java`` — SkipGram/CBOW word embeddings from a sentence
    iterator + tokenizer factory.

    >>> w2v = Word2Vec(layer_size=50, window=5, min_word_frequency=2)
    >>> w2v.fit_corpus(CollectionSentenceIterator(sentences))
    >>> w2v.words_nearest("day", 5)
    """

    def __init__(self, tokenizer_factory=None, **kwargs):
        kwargs.setdefault("elements_learning_algorithm", SkipGram())
        super().__init__(train_elements=True, train_sequences=False, **kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def fit_corpus(self, sentences: "SentenceIterator | Iterable[str]") -> None:
        def provider():
            return _tokenize_to_sequences(sentences, self.tokenizer_factory)
        self.fit(provider)

    # alias matching the reference's fit() naming when iterator pre-set
    fit_sentences = fit_corpus


class ParagraphVectors(SequenceVectors):
    """``ParagraphVectors.java`` — doc2vec. Labels live in the same vocab/syn0
    as words (marked ``special`` so they bypass min-frequency and subsampling).
    """

    def __init__(self, tokenizer_factory=None, dm: bool = False, **kwargs):
        kwargs.setdefault("sequence_learning_algorithm", DM() if dm else DBOW())
        kwargs.setdefault("train_elements", True)
        super().__init__(train_sequences=True, **kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _docs_to_sequences(self, it: LabelAwareIterator):
        for doc in it:
            toks = self.tokenizer_factory.create(doc.content).get_tokens()
            if not toks:
                continue
            seq = Sequence([VocabWord(t) for t in toks])
            for lab in doc.labels:
                el = VocabWord(lab)
                el.special = True
                seq.add_sequence_label(el)
            yield seq

    def fit_documents(self, it: LabelAwareIterator) -> None:
        self.fit(lambda: self._docs_to_sequences(it))

    # ------------------------------------------------------------------
    def infer_vector(self, text: str, steps: int = 10,
                     lr: float = 0.05) -> np.ndarray:
        """``ParagraphVectors.inferVector`` — gradient-fit a fresh doc vector
        against frozen word vectors. Simplified: average of known word vectors
        refined by `steps` of DBOW-style HS/NS updates applied to the doc
        vector only (host-side; inference is small)."""
        toks = self.tokenizer_factory.create(text).get_tokens()
        idxs = [self.vocab.index_of(t) for t in toks]
        idxs = [i for i in idxs if i >= 0]
        syn0 = self.lookup_table.all_vectors()
        if not idxs:
            return np.zeros(self.layer_size, np.float32)
        v = syn0[idxs].mean(axis=0).astype(np.float32)
        if self.use_hs and self._codes is not None:
            syn1 = self.lookup_table.syn1.float().cpu().numpy()
            for _ in range(steps):
                g_total = np.zeros_like(v)
                for w in idxs:
                    L = self._lengths[w]
                    pts = self._points[w, :L]
                    cds = self._codes[w, :L]
                    f = 1.0 / (1.0 + np.exp(-syn1[pts] @ v))
                    g = (1.0 - cds - f) * lr
                    g_total += g @ syn1[pts]
                v = v + g_total / max(len(idxs), 1)
        return v

    def predict(self, text: str) -> Optional[str]:
        """Nearest label for a document (``ParagraphVectors.predict``)."""
        labels = [w for w in self.vocab.words()
                  if self.vocab.word_for(w).special]
        if not labels:
            return None
        v = self.infer_vector(text)
        best, best_sim = None, -np.inf
        syn0 = self.lookup_table.all_vectors()
        nv = np.linalg.norm(v) + 1e-12
        for lab in labels:
            lv = syn0[self.vocab.index_of(lab)]
            sim = float(v @ lv / (nv * (np.linalg.norm(lv) + 1e-12)))
            if sim > best_sim:
                best, best_sim = lab, sim
        return best

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_word_vector(label)
        if lv is None:
            return float("nan")
        return float(v @ lv / ((np.linalg.norm(v) + 1e-12) *
                               (np.linalg.norm(lv) + 1e-12)))
