"""Text pipeline: tokenizers, token preprocessors, sentence/document iterators.

Parity surface: ``deeplearning4j-nlp/.../text/**`` —
``text/tokenization/tokenizer/Tokenizer.java`` / ``DefaultTokenizer`` /
``NGramTokenizer``, ``tokenizerfactory/TokenizerFactory.java`` /
``DefaultTokenizerFactory``, token preprocessors
(``CommonPreprocessor``, ``LowCasePreProcessor``, ``EndingPreProcessor``
stemming-lite), sentence iterators
(``text/sentenceiterator/{BasicLineIterator,CollectionSentenceIterator,
FileSentenceIterator,LineSentenceIterator}.java``), label-aware variants
(``LabelAwareSentenceIterator``, ``documentiterator/LabelAwareIterator.java``,
``LabelsSource.java``).

Pure Python on the host: tokenization is input pre-processing that feeds
the batched training step (see ``sequence_vectors.py``); it never runs on
the device.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterable, Iterator, List, Optional, Sequence


# ---------------------------------------------------------------------------
# Token preprocessors (text/tokenization/tokenizer/preprocessor/*)
# ---------------------------------------------------------------------------

_PUNCT_RE = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")


class CommonPreprocessor:
    """Lowercase + strip digits/punctuation (``CommonPreprocessor.java``)."""

    def pre_process(self, token: str) -> str:
        return _PUNCT_RE.sub("", token.lower())


class LowCasePreProcessor:
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor:
    """Crude suffix stemmer (``EndingPreProcessor.java``: strips s/ed/ing/ly...)."""

    _ENDINGS = ("ing", "ed", "ly", "s", ".")

    def pre_process(self, token: str) -> str:
        for suf in self._ENDINGS:
            if len(token) > len(suf) + 2 and token.endswith(suf):
                return token[: -len(suf)]
        return token


# ---------------------------------------------------------------------------
# Tokenizers (text/tokenization/tokenizer/*)
# ---------------------------------------------------------------------------

class ListTokenizer:
    """Tokenizer over a pre-computed token list — the adapter the CJK
    factories return; full Tokenizer interface (has_more/next/count/get)."""

    def __init__(self, tokens, pre_processor=None):
        self._tokens = list(tokens)
        self._pre = pre_processor
        self._idx = 0

    def set_token_pre_processor(self, pre_processor) -> None:
        self._pre = pre_processor

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._idx]
        self._idx += 1
        return self._pre.pre_process(tok) if self._pre else tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            out.append(self.next_token())
        self._idx = 0
        return out


class DefaultTokenizer:
    """Whitespace tokenizer with optional per-token preprocessor
    (``DefaultTokenizer.java`` wraps java.util.StringTokenizer)."""

    def __init__(self, text: str, pre_processor=None):
        self._tokens = text.split()
        self._pre = pre_processor
        self._idx = 0

    def set_token_pre_processor(self, pre_processor) -> None:
        self._pre = pre_processor

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._idx]
        self._idx += 1
        return self._pre.pre_process(tok) if self._pre else tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            tok = self.next_token()
            if tok:
                out.append(tok)
        return out


class NGramTokenizer:
    """Emit n-grams (joined by '_') over an underlying tokenizer
    (``NGramTokenizer.java``)."""

    def __init__(self, tokenizer, min_n: int, max_n: int):
        base = tokenizer.get_tokens()
        toks: List[str] = []
        if min_n == 1:
            toks.extend(base)
        for n in range(max(min_n, 2), max_n + 1):
            for i in range(len(base) - n + 1):
                toks.append("_".join(base[i:i + n]))
        self._tokens = toks
        self._idx = 0

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._idx]
        self._idx += 1
        return tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        rest = self._tokens[self._idx:]
        self._idx = len(self._tokens)
        return rest


class DefaultTokenizerFactory:
    """``DefaultTokenizerFactory.java`` — creates DefaultTokenizer per text."""

    def __init__(self, pre_processor=None):
        self._pre = pre_processor

    def set_token_pre_processor(self, pre_processor) -> None:
        self._pre = pre_processor

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self._pre)


class NGramTokenizerFactory:
    def __init__(self, base_factory, min_n: int, max_n: int):
        self._base = base_factory
        self._min_n = min_n
        self._max_n = max_n

    def set_token_pre_processor(self, pre_processor) -> None:
        self._base.set_token_pre_processor(pre_processor)

    def create(self, text: str) -> NGramTokenizer:
        return NGramTokenizer(self._base.create(text), self._min_n, self._max_n)


# ---------------------------------------------------------------------------
# Sentence iterators (text/sentenceiterator/*)
# ---------------------------------------------------------------------------

class SentenceIterator:
    """Iterates sentences (strings); resettable. Base contract of
    ``SentenceIterator.java`` (nextSentence/hasNext/reset + preprocessor)."""

    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def _apply(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    # subclass API
    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSentenceIterator(SentenceIterator):
    """Over an in-memory collection (``CollectionSentenceIterator.java``)."""

    def __init__(self, sentences: Sequence[str], pre_processor=None):
        super().__init__(pre_processor)
        self._sentences = list(sentences)
        self._idx = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._idx]
        self._idx += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._idx < len(self._sentences)

    def reset(self) -> None:
        self._idx = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line of a text file (``BasicLineIterator.java``)."""

    def __init__(self, path: str, pre_processor=None):
        super().__init__(pre_processor)
        self._path = path
        self._fh = None
        self._next: Optional[str] = None
        self.reset()

    def _advance(self) -> None:
        line = self._fh.readline()
        while line and not line.strip():
            line = self._fh.readline()
        self._next = line.strip() if line else None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._apply(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self) -> None:
        if self._fh:
            self._fh.close()
        self._fh = open(self._path, "r", encoding="utf-8", errors="ignore")
        self._advance()

    def close(self) -> None:
        """Release the underlying file handle (the reference's
        SentenceIterator#finish); ``reset()`` reopens."""
        if self._fh:
            self._fh.close()
            self._fh = None
        self._next = None


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, one sentence per line
    (``FileSentenceIterator.java``)."""

    def __init__(self, path: str, pre_processor=None):
        super().__init__(pre_processor)
        if os.path.isdir(path):
            self._files = sorted(
                os.path.join(root, f)
                for root, _, files in os.walk(path) for f in files)
        else:
            self._files = [path]
        self.reset()

    def _advance(self) -> None:
        while True:
            line = self._fh.readline() if self._fh else ""
            if line:
                if line.strip():
                    self._next = line.strip()
                    return
                continue
            if self._file_idx >= len(self._files):
                self._next = None
                return
            if self._fh:
                self._fh.close()
            self._fh = open(self._files[self._file_idx], "r",
                            encoding="utf-8", errors="ignore")
            self._file_idx += 1

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._apply(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self) -> None:
        self.close()
        self._file_idx = 0
        self._advance()

    def close(self) -> None:
        """Release the current file handle — a mid-directory ``reset()``
        used to drop it still open."""
        fh = getattr(self, "_fh", None)
        if fh:
            fh.close()
        self._fh = None
        self._next = None


class LabelsSource:
    """Generates/holds document labels (``documentiterator/LabelsSource.java``)."""

    def __init__(self, template: str = "DOC_", labels: Optional[List[str]] = None):
        self._template = template
        self._labels = list(labels) if labels else []
        self._counter = 0
        self._generated = labels is None

    def next_label(self) -> str:
        if self._generated:
            label = f"{self._template}{self._counter}"
            self._labels.append(label)
        else:
            label = self._labels[self._counter]
        self._counter += 1
        return label

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def reset(self) -> None:
        self._counter = 0


class LabelledDocument:
    """(content, labels) pair (``documentiterator/LabelledDocument.java``)."""

    def __init__(self, content: str, labels: Sequence[str]):
        self.content = content
        self.labels = list(labels)


class LabelAwareIterator:
    """Iterates LabelledDocuments (``documentiterator/LabelAwareIterator.java``)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)
        self._idx = 0

    @classmethod
    def from_sentences(cls, sentences: Sequence[str],
                       labels_source: Optional[LabelsSource] = None):
        src = labels_source or LabelsSource()
        return cls([LabelledDocument(s, [src.next_label()]) for s in sentences])

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_document()

    def next_document(self) -> LabelledDocument:
        d = self._docs[self._idx]
        self._idx += 1
        return d

    def has_next(self) -> bool:
        return self._idx < len(self._docs)

    def reset(self) -> None:
        self._idx = 0
