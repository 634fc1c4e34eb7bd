"""Korean tokenization: the port of ``deeplearning4j_tpu/nlp/korean.py``
(the ``deeplearning4j-nlp-korean`` role, ``KoreanTokenizerFactory.scala``).

Hangul-aware segmentation: whitespace and script splitting plus josa
(particle) stripping against the standard particle set, with Unicode
jamo arithmetic for the final-consonant (batchim) rules (은/는, 이/가,
을/를). Tokens equal the reference's."""

from __future__ import annotations

from typing import List

__all__ = ["KoreanTokenizer", "KoreanTokenizerFactory"]

# particles whose preceding syllable must END in a final consonant (batchim)
_JOSA_WITH_BATCHIM = ("은", "이", "을", "과")
# particles whose preceding syllable must NOT have batchim
_JOSA_NO_BATCHIM = ("는", "가", "를", "와")
# batchim-agnostic particles (longest first so 에서/에게 beat 에)
_JOSA_ANY = ("에서", "에게", "부터", "까지", "처럼", "보다", "한테",
             "으로", "로", "의", "에", "도", "만")


def _is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7A3


def _has_batchim(ch: str) -> bool:
    """True when the Hangul syllable carries a final consonant (jamo math:
    syllables are laid out base + initial·588 + vowel·28 + final)."""
    if not _is_hangul(ch):
        return False
    return (ord(ch) - 0xAC00) % 28 != 0


class KoreanTokenizer:
    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in self._script_chunks(text):
            out.extend(self._split_josa(chunk))
        return out

    @staticmethod
    def _script_chunks(text: str) -> List[str]:
        """Split on whitespace and script boundaries (hangul / latin /
        digits / other)."""
        chunks: List[str] = []
        cur = ""
        cur_kind = None
        for ch in text:
            if ch.isspace():
                if cur:
                    chunks.append(cur)
                cur, cur_kind = "", None
                continue
            kind = ("hangul" if _is_hangul(ch) else
                    "digit" if ch.isdigit() else
                    "latin" if ch.isalpha() else "symbol")
            if kind != cur_kind and cur:
                chunks.append(cur)
                cur = ""
            cur += ch
            cur_kind = kind
        if cur:
            chunks.append(cur)
        return chunks

    @staticmethod
    def _split_josa(chunk: str) -> List[str]:
        """Strip one trailing particle from a Hangul chunk when the batchim
        rule licenses it and a non-empty stem remains."""
        if len(chunk) < 2 or not _is_hangul(chunk[-1]):
            return [chunk]
        for josa in _JOSA_ANY:
            if chunk.endswith(josa) and len(chunk) > len(josa):
                return [chunk[:-len(josa)], josa]
        last, prev = chunk[-1], chunk[-2]
        if last in _JOSA_WITH_BATCHIM and _has_batchim(prev):
            return [chunk[:-1], last]
        if last in _JOSA_NO_BATCHIM and not _has_batchim(prev):
            return [chunk[:-1], last]
        return [chunk]


class KoreanTokenizerFactory:
    """TokenizerFactory adapter (KoreanTokenizerFactory.scala role)."""

    def __init__(self):
        self._tok = KoreanTokenizer()

    def create(self, text: str):
        from deeplearning4j_tpu_torch.nlp.text import ListTokenizer
        return ListTokenizer(self._tok.tokenize(text))
