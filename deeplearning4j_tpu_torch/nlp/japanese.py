"""Japanese tokenization core: the port of
``deeplearning4j_tpu/nlp/japanese.py`` (the ``deeplearning4j-nlp-japanese``
role, Kuromoji's ``trie/PatriciaTrie.java`` and
``viterbi/{ViterbiBuilder,ViterbiSearcher}.java``).

- :class:`PatriciaTrie`: the radix trie for common-prefix dictionary
  lookup.
- :class:`ViterbiTokenizer`: a lattice of dictionary and unknown-word
  candidates and its min-cost Viterbi path (word cost plus connection
  cost).

A compact built-in seed lexicon covers function words and particles, and
unknown words group by script class (kanji, hiragana, katakana, latin,
digits); :meth:`ViterbiTokenizer.load_lexicon` adds a real lexicon.
Tokens equal the reference's.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["PatriciaTrie", "ViterbiTokenizer", "JapaneseTokenizerFactory"]


class _TrieNode:
    __slots__ = ("edge", "children", "value", "terminal")

    def __init__(self, edge: str = ""):
        self.edge = edge                 # compressed label on the edge INTO this node
        self.children: Dict[str, "_TrieNode"] = {}   # first char -> child
        self.value = None
        self.terminal = False


class PatriciaTrie:
    """Radix (Patricia) trie with the operations Kuromoji's dictionary
    lookup needs: insert, exact get, and common-prefix search
    (``PatriciaTrie.java`` role — path-compressed, child dispatch on first
    character)."""

    def __init__(self):
        self._root = _TrieNode()
        self._size = 0

    def __len__(self):
        return self._size

    def insert(self, key: str, value=None) -> None:
        if not key:
            raise ValueError("empty key")
        node = self._root
        rest = key
        while True:
            child = node.children.get(rest[0])
            if child is None:
                leaf = _TrieNode(rest)
                leaf.terminal = True
                leaf.value = value
                node.children[rest[0]] = leaf
                self._size += 1
                return
            edge = child.edge
            common = _common_prefix_len(rest, edge)
            if common == len(edge):
                if common == len(rest):
                    if not child.terminal:
                        self._size += 1
                    child.terminal = True
                    child.value = value
                    return
                node, rest = child, rest[common:]
                continue
            # split the edge: child keeps its tail under a new middle node
            middle = _TrieNode(edge[:common])
            middle.children[edge[common]] = child
            child.edge = edge[common:]
            node.children[rest[0]] = middle
            if common == len(rest):
                middle.terminal = True
                middle.value = value
            else:
                leaf = _TrieNode(rest[common:])
                leaf.terminal = True
                leaf.value = value
                middle.children[rest[common]] = leaf
            self._size += 1
            return

    def get(self, key: str):
        node = self._find(key)
        if node is None or not node.terminal:
            raise KeyError(key)
        return node.value

    def __contains__(self, key: str) -> bool:
        node = self._find(key)
        return node is not None and node.terminal

    def _find(self, key: str) -> Optional[_TrieNode]:
        node = self._root
        rest = key
        while rest:
            child = node.children.get(rest[0])
            if child is None or not rest.startswith(child.edge):
                return None
            rest = rest[len(child.edge):]
            node = child
        return node if node is not self._root else None

    def common_prefixes(self, text: str) -> Iterator[Tuple[str, object]]:
        """All dictionary entries that are prefixes of ``text`` — the lattice
        builder's per-position lookup (ViterbiBuilder role)."""
        node = self._root
        consumed = 0
        rest = text
        while rest:
            child = node.children.get(rest[0])
            if child is None or not rest.startswith(child.edge):
                return
            consumed += len(child.edge)
            rest = rest[len(child.edge):]
            node = child
            if node.terminal:
                yield text[:consumed], node.value


def _common_prefix_len(a: str, b: str) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


# ---------------------------------------------------------------------------
# script classification (Kuromoji's CharacterDefinition role)
# ---------------------------------------------------------------------------

def _script_class(ch: str) -> str:
    cp = ord(ch)
    if 0x3040 <= cp <= 0x309F:
        return "hiragana"
    if 0x30A0 <= cp <= 0x30FF or cp == 0x30FC:
        return "katakana"
    if 0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF:
        return "kanji"
    if ch.isdigit() or 0xFF10 <= cp <= 0xFF19:
        return "digit"
    if ch.isalpha() and cp < 0x3000:
        return "latin"
    if ch.isspace():
        return "space"
    return "symbol"


# small seed lexicon: particles / copulas / common function words with low
# costs, so the lattice prefers splitting them off (IPADIC's role, microscale)
_SEED_LEXICON = {
    "の": 100, "に": 120, "は": 110, "を": 110, "が": 110, "と": 130,
    "で": 130, "も": 140, "から": 160, "まで": 160, "より": 180,
    "へ": 150, "や": 170, "か": 180, "ね": 200, "よ": 200,
    "です": 150, "ます": 150, "でした": 170, "ました": 170, "ません": 180,
    "する": 200, "した": 200, "して": 200, "いる": 210, "ある": 210,
    "これ": 220, "それ": 220, "あれ": 230, "この": 220, "その": 220,
    "私": 250, "僕": 260, "日本": 240, "東京": 240, "今日": 240,
    "、": 50, "。": 50, "！": 60, "？": 60,
}


class ViterbiTokenizer:
    """Lattice tokenizer: dictionary candidates from the Patricia trie +
    script-run unknown candidates, min-cost path via Viterbi
    (``viterbi/ViterbiBuilder.java`` + ``ViterbiSearcher.java`` roles).

    Costs: known words carry their lexicon cost; unknown candidates cost
    ``unk_base + unk_per_char·len`` (longer runs of one script class are
    cheaper per character, so contiguous kanji/katakana group together);
    a connection cost discourages switching between single-char tokens."""

    def __init__(self, lexicon: Optional[Dict[str, int]] = None, *,
                 unk_base: int = 700, unk_per_char: int = 150,
                 connection_cost: int = 80):
        self._trie = PatriciaTrie()
        self.unk_base = unk_base
        self.unk_per_char = unk_per_char
        self.connection_cost = connection_cost
        for w, cost in (lexicon if lexicon is not None
                        else _SEED_LEXICON).items():
            self._trie.insert(w, cost)

    def load_lexicon(self, entries: Dict[str, int]) -> None:
        for w, cost in entries.items():
            self._trie.insert(w, cost)

    def _candidates(self, text: str, pos: int):
        """(end, cost, known) candidates starting at pos (lattice column)."""
        out = []
        for word, cost in self._trie.common_prefixes(text[pos:]):
            out.append((pos + len(word), int(cost), True))
        # unknown: maximal same-script run, plus each prefix length up to 3
        # (ViterbiBuilder emits several unknown lengths; capped for O(n))
        cls = _script_class(text[pos])
        run = pos + 1
        while run < len(text) and _script_class(text[run]) == cls:
            run += 1
        lengths = {run - pos, 1, min(2, run - pos), min(3, run - pos)}
        for ln in sorted(lengths):
            if ln <= 0:
                continue
            end = pos + ln
            cost = self.unk_base + self.unk_per_char * ln
            if cls in ("kanji", "katakana", "latin", "digit") and ln > 1:
                cost -= 60 * ln   # favor grouping content-script runs
            out.append((end, cost, False))
        return out

    def tokenize(self, text: str) -> List[str]:
        if not text:
            return []
        n = len(text)
        INF = float("inf")
        best = [INF] * (n + 1)
        back: List[Optional[int]] = [None] * (n + 1)
        best[0] = 0.0
        for pos in range(n):
            if best[pos] is INF:
                continue
            if text[pos].isspace():      # whitespace breaks the lattice
                if best[pos] < best[pos + 1]:
                    best[pos + 1] = best[pos]
                    back[pos + 1] = pos
                continue
            for end, cost, known in self._candidates(text, pos):
                total = best[pos] + cost + self.connection_cost
                if total < best[end]:
                    best[end] = total
                    back[end] = pos
        # walk back
        tokens = []
        pos = n
        while pos > 0:
            start = back[pos]
            if start is None:     # unreachable (shouldn't happen): emit char
                start = pos - 1
            tok = text[start:pos]
            if not tok.isspace():
                tokens.append(tok)
            pos = start
        tokens.reverse()
        return tokens


class JapaneseTokenizerFactory:
    """TokenizerFactory adapter so Word2Vec/SequenceVectors pipelines consume
    Japanese text directly (the reference's JapaneseTokenizerFactory role)."""

    def __init__(self, lexicon: Optional[Dict[str, int]] = None):
        self._tok = ViterbiTokenizer(lexicon)

    def create(self, text: str):
        from deeplearning4j_tpu_torch.nlp.text import ListTokenizer
        return ListTokenizer(self._tok.tokenize(text))
