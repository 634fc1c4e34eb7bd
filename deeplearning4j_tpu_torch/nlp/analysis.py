"""Linguistic analysis: the port of ``deeplearning4j_tpu/nlp/analysis.py``
(the ``deeplearning4j-nlp-uima`` role: ``SentenceAnnotator``,
``TokenizerAnnotator``, ``PoStagger``, SentiWordNet's ``SWN3``).

- :class:`SentenceSegmenter`: abbreviation-aware rule segmentation.
- :class:`PosTagger`: lexicon and suffix-rule English POS tagging with a
  compact embedded lexicon (coarse Penn-style tags).
- :class:`SentimentAnalyzer`: lexicon polarity scoring with negation
  handling (extensible with ``load_lexicon``).

Pure Python; segments, tags and scores equal the reference's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = ["SentenceSegmenter", "PosTagger", "SentimentAnalyzer",
           "AnnotatedToken"]

_ABBREVIATIONS = {
    "dr", "mr", "mrs", "ms", "prof", "sr", "jr", "st", "vs", "etc", "e.g",
    "i.e", "fig", "al", "inc", "ltd", "co", "corp", "dept", "est", "approx",
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept", "oct",
    "nov", "dec", "no", "vol", "pp", "cf",
}


class SentenceSegmenter:
    """Rule-based sentence boundary detection (SentenceAnnotator role):
    terminators end a sentence unless they close a known abbreviation, a
    single initial, or a number; the next sentence must start with an
    uppercase letter, digit, or quote."""

    _BOUNDARY = re.compile(r'([.!?]+)(["\')\]]*)\s+')

    def segment(self, text: str) -> List[str]:
        text = text.strip()
        if not text:
            return []
        sentences = []
        start = 0
        for m in self._BOUNDARY.finditer(text):
            end = m.end()
            word = text[max(start, m.start() - 12):m.start()].rsplit(None, 1)
            last = word[-1].lower().rstrip(".") if word else ""
            nxt = text[end:end + 1]
            if last in _ABBREVIATIONS or (len(last) == 1 and last.isalpha()):
                continue   # "Dr." / "J." — not a boundary
            if text[m.start() - 1].isdigit() and nxt.isdigit():
                continue   # 3.14
            if nxt and not (nxt.isupper() or nxt.isdigit() or nxt in "\"'("):
                continue
            sentences.append(text[start:end].strip())
            start = end
        if start < len(text):
            sentences.append(text[start:].strip())
        return [s for s in sentences if s]


class AnnotatedToken:
    __slots__ = ("token", "tag")

    def __init__(self, token: str, tag: str):
        self.token = token
        self.tag = tag

    def __repr__(self):
        return f"{self.token}/{self.tag}"


# compact closed-class lexicon + high-frequency words (PoStagger role)
_POS_LEXICON = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT",
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "them": "PRP", "us": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD", "be": "VB",
    "been": "VBN", "being": "VBG", "am": "VBP",
    "have": "VBP", "has": "VBZ", "had": "VBD", "do": "VBP", "does": "VBZ",
    "did": "VBD", "will": "MD", "would": "MD", "can": "MD", "could": "MD",
    "shall": "MD", "should": "MD", "may": "MD", "might": "MD", "must": "MD",
    "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
    "with": "IN", "from": "IN", "of": "IN", "to": "TO", "as": "IN",
    "into": "IN", "over": "IN", "under": "IN", "about": "IN",
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "so": "CC",
    "not": "RB", "n't": "RB", "very": "RB", "too": "RB", "also": "RB",
    "never": "RB", "always": "RB", "often": "RB", "quite": "RB",
    "good": "JJ", "bad": "JJ", "new": "JJ", "old": "JJ", "great": "JJ",
    "small": "JJ", "large": "JJ", "big": "JJ",
}

_SUFFIX_RULES: List[Tuple[str, str]] = [
    ("ing", "VBG"), ("ed", "VBD"), ("ly", "RB"), ("tion", "NN"),
    ("ment", "NN"), ("ness", "NN"), ("ity", "NN"), ("ous", "JJ"),
    ("ful", "JJ"), ("able", "JJ"), ("ible", "JJ"), ("ive", "JJ"),
    ("est", "JJS"), ("er", "NN"), ("s", "NNS"),
]

_TOKEN_RE = re.compile(r"[A-Za-z]+(?:'[a-z]+)?|\d+(?:\.\d+)?|[^\sA-Za-z\d]")


class PosTagger:
    """Lexicon + suffix-rule POS tagging with coarse Penn tags
    (PoStagger role). Capitalized non-initial words tag NNP."""

    def tokenize(self, sentence: str) -> List[str]:
        out = []
        for tok in _TOKEN_RE.findall(sentence):
            # split contracted negation so "isn't" -> ["is", "n't"]
            # (the reference taggers treat n't as its own RB token)
            if tok.lower().endswith("n't") and len(tok) > 3:
                out.append(tok[:-3])
                out.append(tok[-3:])
            else:
                out.append(tok)
        return out

    def tag(self, sentence: str) -> List[AnnotatedToken]:
        tokens = self.tokenize(sentence)
        out = []
        for i, tok in enumerate(tokens):
            low = tok.lower()
            if low in _POS_LEXICON:
                tag = _POS_LEXICON[low]
            elif tok[0].isdigit():
                tag = "CD"
            elif not tok[0].isalnum():
                tag = "."
            elif tok[0].isupper() and i > 0:
                tag = "NNP"
            else:
                tag = next((t for suf, t in _SUFFIX_RULES
                            if low.endswith(suf) and len(low) > len(suf) + 1),
                           "NN")
            out.append(AnnotatedToken(tok, tag))
        return out


# polarity mini-lexicon (SWN3 role); positive score ∈ (0, 1], negative < 0
_SENTIMENT = {
    "good": 0.6, "great": 0.8, "excellent": 0.9, "amazing": 0.85,
    "wonderful": 0.85, "best": 0.8, "love": 0.8, "loved": 0.8,
    "like": 0.4, "happy": 0.7, "nice": 0.5, "fantastic": 0.85,
    "perfect": 0.9, "brilliant": 0.85, "enjoy": 0.6, "enjoyed": 0.6,
    "awesome": 0.85, "beautiful": 0.7, "helpful": 0.5, "fast": 0.3,
    "bad": -0.6, "terrible": -0.85, "awful": -0.85, "worst": -0.9,
    "hate": -0.8, "hated": -0.8, "horrible": -0.85, "poor": -0.5,
    "sad": -0.6, "boring": -0.6, "slow": -0.3, "broken": -0.6,
    "wrong": -0.5, "fail": -0.6, "failed": -0.6, "useless": -0.7,
    "disappointing": -0.7, "disappointed": -0.7, "ugly": -0.6,
}

_NEGATORS = {"not", "no", "never", "n't", "neither", "nor", "hardly",
             "barely", "without"}


class SentimentAnalyzer:
    """Lexicon polarity with a 3-token negation window (SWN3.java's
    ``extract``/``extractWeighted`` role: word score lookup + aggregation)."""

    def __init__(self, lexicon: Optional[Dict[str, float]] = None):
        self._lex = dict(_SENTIMENT if lexicon is None else lexicon)
        self._tagger = PosTagger()

    def load_lexicon(self, entries: Dict[str, float]) -> None:
        self._lex.update(entries)

    def score(self, text: str) -> float:
        """Mean signed polarity of matched words, negation-flipped."""
        tokens = [t.lower() for t in self._tagger.tokenize(text)]
        total, hits = 0.0, 0
        for i, tok in enumerate(tokens):
            s = self._lex.get(tok)
            if s is None:
                continue
            window = tokens[max(0, i - 3):i]
            if any(w in _NEGATORS for w in window):
                s = -s
            total += s
            hits += 1
        return total / hits if hits else 0.0

    def classify(self, text: str) -> str:
        """'positive' | 'negative' | 'neutral' (SWN3 bucket labels)."""
        s = self.score(text)
        if s > 0.1:
            return "positive"
        if s < -0.1:
            return "negative"
        return "neutral"
