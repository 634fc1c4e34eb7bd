"""Constituency trees: structure, parsing, transforms, vectorization: the
port of ``deeplearning4j_tpu/nlp/trees.py``.

- ``Tree`` (``nn/layers/feedforward/autoencoder/recursive/Tree.java:32``):
  label, value, children, tokens, tags, spans, yield, predicates, error
  hooks; Penn-bracket serialisation round trip.
- ``TreeParser`` (``text/corpora/treeparser/TreeParser.java:60``): the
  reference's deterministic chunker over the lexicon POS tagger
  (``nlp/analysis.py``): NP/VP/PP chunks under an S root.
- ``BinarizeTreeTransformer`` and ``CollapseUnaries``: left-factored
  binarisation with @-interior labels; unary chain collapsing.
- ``HeadWordFinder``: per-category head rules.
- ``ContextLabelRetriever``: ``<LABEL> ... </LABEL>`` span extraction.
- ``TreeVectorizer`` (``TreeVectorizer.java:33``): parse, binarise,
  collapse unaries, and attach each leaf's word vector from a lookup:
  an object with ``vector(word)`` that raises ``KeyError`` for an unknown
  word, as in the reference, or a port ``Word2Vec`` (any object with
  ``get_word_vector(word)``, None for an unknown word).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = ["Tree", "TreeParser", "TreeVectorizer", "BinarizeTreeTransformer",
           "CollapseUnaries", "HeadWordFinder", "ContextLabelRetriever"]


class Tree:
    """Constituency tree node (Tree.java:32)."""

    def __init__(self, value: Optional[str] = None,
                 label: Optional[str] = None,
                 children: Optional[List["Tree"]] = None,
                 tokens: Optional[List[str]] = None):
        self.value = value          # token text (leaves) or category
        self.label = label          # category label (interior) / context label
        self.children: List[Tree] = list(children or [])
        self.tokens = list(tokens or [])
        self.tags: List[str] = []
        self.gold_label: Optional[str] = None
        self.head_word: Optional[str] = None
        self.begin = 0
        self.end = 0
        self.error = 0.0
        self.vector = None          # attached by vectorizers
        self.prediction = None

    # ---- predicates ----------------------------------------------------
    def is_leaf(self):
        return not self.children

    def is_preterminal(self):
        return len(self.children) == 1 and self.children[0].is_leaf()

    # ---- traversal -----------------------------------------------------
    def yield_(self) -> List[str]:
        """Leaf token sequence (Tree.yield)."""
        if self.is_leaf():
            return [self.value] if self.value is not None else []
        out = []
        for c in self.children:
            out.extend(c.yield_())
        return out

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def error_sum(self) -> float:
        return self.error + sum(c.error_sum() for c in self.children)

    def first_child(self):
        return self.children[0] if self.children else None

    def last_child(self):
        return self.children[-1] if self.children else None

    def clone(self) -> "Tree":
        t = self.copy_node()
        t.children = [c.clone() for c in self.children]
        return t

    def copy_node(self) -> "Tree":
        """Copy this node's own fields only (no children) — what the tree
        transformers need; clone() would deep-copy subtrees that are about
        to be replaced (quadratic over tree depth)."""
        t = Tree(self.value, self.label, None, list(self.tokens))
        t.tags = list(self.tags)
        t.gold_label = self.gold_label
        t.head_word = self.head_word
        t.begin, t.end, t.error = self.begin, self.end, self.error
        return t

    # ---- Penn bracketing ----------------------------------------------
    def to_bracket(self) -> str:
        if self.is_leaf():
            return self.value or ""
        inner = " ".join(c.to_bracket() for c in self.children)
        return f"({self.label or self.value} {inner})"

    _TOKENS_RE = re.compile(r"\(|\)|[^\s()]+")

    @staticmethod
    def from_bracket(s: str) -> "Tree":
        """Parse ``(S (NP (DT the) (NN cat)) ...)`` (TreeFactory role)."""
        toks = Tree._TOKENS_RE.findall(s)
        pos = 0

        def parse() -> Tree:
            nonlocal pos
            if toks[pos] != "(":
                leaf = Tree(value=toks[pos])
                pos += 1
                return leaf
            pos += 1                      # consume '('
            node = Tree(label=toks[pos])
            node.value = toks[pos]
            pos += 1
            while pos < len(toks) and toks[pos] != ")":
                node.children.append(parse())
            if pos >= len(toks):
                raise ValueError(f"unbalanced brackets in {s!r}")
            pos += 1                      # consume ')'
            return node

        root = parse()
        if pos != len(toks):
            raise ValueError(f"trailing content after tree in {s!r}")
        root.tokens = root.yield_()
        return root

    def __repr__(self):
        return f"Tree({self.to_bracket()})"


class ContextLabelRetriever:
    """``<LABEL> tokens </LABEL>`` span extraction
    (text/movingwindow/ContextLabelRetriever.java:52): returns the stripped
    sentence and {(begin, end): label} over token indices; unmarked spans
    carry the NONE label."""

    _BEGIN = re.compile(r"^<([A-Za-z]+|\d+)>$")
    _END = re.compile(r"^</([A-Za-z]+|\d+)>$")
    # label markers split out whole; the text between them is tokenized by
    # the SAME tokenizer the parser uses, so span indices align with leaves
    _MARKER = re.compile(r"(</?(?:[A-Za-z]+|\d+)>)")

    @staticmethod
    def _pieces(sentence: str, tokenize) -> List[str]:
        out = []
        for part in ContextLabelRetriever._MARKER.split(sentence):
            if ContextLabelRetriever._MARKER.fullmatch(part):
                out.append(part)
            elif part.strip():
                out.extend(tokenize(part))
        return out

    @staticmethod
    def string_with_labels(sentence: str, tokenize=None
                           ) -> Tuple[str, Dict[Tuple[int, int], str]]:
        if tokenize is None:
            from deeplearning4j_tpu_torch.nlp.analysis import PosTagger
            tokenize = PosTagger().tokenize
        spans: Dict[Tuple[int, int], str] = {}
        tokens_out: List[str] = []
        curr_label = None
        curr_start = 0
        for raw in ContextLabelRetriever._pieces(sentence, tokenize):
            m = ContextLabelRetriever._BEGIN.match(raw)
            if m:
                if curr_label is not None:
                    raise ValueError(
                        f"nested begin label {raw!r} inside {curr_label!r}")
                if len(tokens_out) > curr_start:
                    spans[(curr_start, len(tokens_out))] = "NONE"
                curr_label = m.group(1)
                curr_start = len(tokens_out)
                continue
            m = ContextLabelRetriever._END.match(raw)
            if m:
                if curr_label is None:
                    raise ValueError(f"end label {raw!r} without a begin")
                if m.group(1) != curr_label:
                    raise ValueError(
                        f"label mismatch: <{curr_label}> ... </{m.group(1)}>")
                spans[(curr_start, len(tokens_out))] = curr_label
                curr_label = None
                curr_start = len(tokens_out)
                continue
            tokens_out.append(raw)
        if curr_label is not None:
            raise ValueError(f"unclosed label <{curr_label}>")
        if len(tokens_out) > curr_start:
            spans[(curr_start, len(tokens_out))] = "NONE"
        return " ".join(tokens_out), spans


# chunk category per POS tag (the grammar of the shallow parser)
_CHUNK_OF = {
    "DT": "NP", "JJ": "NP", "JJS": "NP", "NN": "NP", "NNS": "NP",
    "NNP": "NP", "PRP": "NP", "PRP$": "NP", "CD": "NP",
    "VB": "VP", "VBD": "VP", "VBG": "VP", "VBN": "VP", "VBP": "VP",
    "VBZ": "VP", "MD": "VP", "RB": "VP", "TO": "VP",
    "IN": "PP",
}


class TreeParser:
    """text → constituency trees (TreeParser.java:60 role).

    Segments into sentences, POS-tags, chunks runs of same-category tags
    into NP/VP/PP constituents under an S root. A PP absorbs the NP that
    follows it (``(PP (IN of) (NP ...))``)."""

    def __init__(self):
        from deeplearning4j_tpu_torch.nlp.analysis import PosTagger, SentenceSegmenter
        self.segmenter = SentenceSegmenter()
        self.tagger = PosTagger()

    def _sentence_tree(self, sentence: str) -> Tree:
        tagged = self.tagger.tag(sentence)
        root = Tree(value="S", label="S")
        root.tokens = [t.token for t in tagged]
        root.tags = [t.tag for t in tagged]
        chunks: List[Tree] = []
        curr_cat, curr_kids = None, []

        def flush():
            nonlocal curr_cat, curr_kids
            if curr_kids:
                node = Tree(value=curr_cat, label=curr_cat,
                            children=curr_kids)
                chunks.append(node)
            curr_cat, curr_kids = None, []

        for i, at in enumerate(tagged):
            cat = _CHUNK_OF.get(at.tag, "X" if at.tag != "." else ".")
            pre = Tree(value=at.tag, label=at.tag,
                       children=[Tree(value=at.token)])
            pre.begin = pre.end = i
            if cat != curr_cat or cat == ".":
                flush()
                curr_cat = cat
            curr_kids.append(pre)
        flush()
        # PP + following NP → (PP (IN ...) (NP ...))
        merged: List[Tree] = []
        i = 0
        while i < len(chunks):
            c = chunks[i]
            if (c.label == "PP" and i + 1 < len(chunks)
                    and chunks[i + 1].label == "NP"):
                c.children.append(chunks[i + 1])
                i += 2
            else:
                i += 1
            merged.append(c)
        root.children = merged
        for n, leaf in enumerate(root.leaves()):
            leaf.begin = leaf.end = n
        root.begin, root.end = 0, max(0, len(root.tokens) - 1)
        return root

    def get_trees(self, text: str) -> List[Tree]:
        if not text.strip():
            return []
        return [self._sentence_tree(s) for s in self.segmenter.segment(text)]

    def get_trees_with_labels(self, text: str, label: Optional[str] = None,
                              labels: Optional[List[str]] = None) -> List[Tree]:
        """Trees whose preterminals carry gold context labels — either one
        ``label`` for everything (TreeParser.getTreesWithLabels(text,label,..))
        or inline ``<LABEL>...</LABEL>`` spans in ``text``."""
        stripped, spans = ContextLabelRetriever.string_with_labels(
            text, tokenize=self.tagger.tokenize)
        allowed = set(labels or [])
        allowed.add("NONE")
        if label is not None:
            allowed.add(label)
        for sp_label in spans.values():
            if labels is not None and sp_label not in allowed:
                raise ValueError(
                    f"label {sp_label!r} not in allowed set {sorted(allowed)}")
        trees = self.get_trees(stripped)
        offset = 0
        for tree in trees:
            n = len(tree.tokens)
            for leaf_idx, leaf in enumerate(tree.leaves()):
                g = leaf_idx + offset
                got = next((l for (b, e), l in spans.items() if b <= g < e),
                           "NONE")
                leaf.gold_label = label if label is not None else got
            tree.gold_label = (label if label is not None else
                               next((l for l in (leaf.gold_label
                                                 for leaf in tree.leaves())
                                     if l != "NONE"), "NONE"))
            offset += n
        return trees


class BinarizeTreeTransformer:
    """Left-factored binarization (BinarizeTreeTransformer.java): a node
    with >2 children folds its leading pair under ``@Label`` interior
    nodes — (a b c d) becomes (((a b) c) d) — so downstream recursive
    models see at most binary branching."""

    def __init__(self, factor: str = "left"):
        if factor != "left":
            raise ValueError("only left factoring is implemented")

    def transform(self, t: Optional[Tree]) -> Optional[Tree]:
        if t is None:
            return None
        if t.is_leaf() or t.is_preterminal():
            return t
        kids = [self.transform(c) for c in t.children]
        # Left factoring: fold the leading pair under an @-node so the tree
        # nests on the left — (a b c d) -> (((a b) c) d) — matching the
        # reference's default 'left' direction.
        while len(kids) > 2:
            inter = Tree(value=f"@{t.label}", label=f"@{t.label}",
                         children=kids[:2])
            kids = [inter] + kids[2:]
        out = t.copy_node()
        out.children = kids
        return out


class CollapseUnaries:
    """Collapse unary interior chains (CollapseUnaries.java): X→Y→Z...
    becomes X over Z's children; preterminals stay."""

    def transform(self, tree: Tree) -> Tree:
        if tree.is_preterminal() or tree.is_leaf():
            return tree
        children = tree.children
        while len(children) == 1 and not children[0].is_leaf() \
                and not children[0].is_preterminal():
            children = children[0].children
        out = tree.copy_node()
        out.children = [self.transform(c) for c in children]
        return out


class HeadWordFinder:
    """Per-category head rules (HeadWordFinder.java, simplified): NP → last
    noun-ish token, VP → first verb, PP → the preposition, else last leaf."""

    _RULES = {
        "NP": (("NN", "NNS", "NNP", "PRP", "CD"), "last"),
        "VP": (("VB", "VBD", "VBG", "VBN", "VBP", "VBZ", "MD"), "first"),
        "PP": (("IN", "TO"), "first"),
    }

    def find_head(self, tree: Tree) -> Optional[str]:
        if tree.is_leaf():
            return tree.value
        cat = tree.label or tree.value
        pres = [c for c in tree.children if c.is_preterminal()]
        tags, which = self._RULES.get(cat, ((), "last"))
        matches = [p for p in pres if p.label in tags]
        if matches:
            pick = matches[0] if which == "first" else matches[-1]
            head = pick.children[0].value
        else:
            leaves = tree.leaves()
            head = leaves[0 if which == "first" else -1].value
        tree.head_word = head
        return head

    def assign_heads(self, tree: Tree) -> Tree:
        for c in tree.children:
            if not c.is_leaf():
                self.assign_heads(c)
        self.find_head(tree)
        return tree


class TreeVectorizer:
    """parse → binarize → collapse unaries (TreeVectorizer.java:33); with a
    word-vector lookup, leaves get their embeddings attached (the RNTN
    input contract)."""

    def __init__(self, parser: Optional[TreeParser] = None, lookup=None):
        self.parser = parser or TreeParser()
        self.binarizer = BinarizeTreeTransformer()
        self.collapser = CollapseUnaries()
        self.lookup = lookup

    def _vector(self, word):
        """The word's vector from the lookup, None when it has none."""
        get = getattr(self.lookup, "get_word_vector", None)
        if get is not None:      # a Word2Vec: None for an unknown word
            return get(word)
        try:
            return self.lookup.vector(word)
        except (KeyError, AttributeError):
            return None

    def _finish(self, trees: List[Tree]) -> List[Tree]:
        out = []
        for t in trees:
            t = self.collapser.transform(self.binarizer.transform(t))
            if self.lookup is not None:
                for leaf in t.leaves():
                    leaf.vector = self._vector(leaf.value)
            out.append(t)
        return out

    def get_trees(self, text: str) -> List[Tree]:
        return self._finish(self.parser.get_trees(text))

    def get_trees_with_labels(self, text: str, label: Optional[str] = None,
                              labels: Optional[List[str]] = None) -> List[Tree]:
        if labels is not None and "NONE" not in labels:
            labels = list(labels) + ["NONE"]
        return self._finish(
            self.parser.get_trees_with_labels(text, label, labels))
