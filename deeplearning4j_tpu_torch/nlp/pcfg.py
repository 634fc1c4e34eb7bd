"""Statistical constituency parsing, PCFG estimation and CKY decoding: the
port of ``deeplearning4j_tpu/nlp/pcfg.py``.

A maximum-likelihood PCFG estimated from a bracketed treebank
(``Pcfg.from_trees``, ``Pcfg.from_treebank_file``), decoded with CKY and
unary closure (``PcfgParser``), producing the same ``Tree`` objects as
``nlp/trees.py`` so that TreeVectorizer takes either parser. Rule
probabilities and parses equal the reference's.

Treebank fixture: tests/fixtures/mini_treebank.txt.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.trees import (BinarizeTreeTransformer,
                                          CollapseUnaries, Tree)


class Pcfg:
    """Maximum-likelihood PCFG over binarized trees.

    Productions are split by arity — binary ``A -> B C``, unary interior
    ``A -> B`` and lexical ``POS -> word`` — and normalized per LHS over
    ALL its expansions, so each LHS's rule probabilities sum to 1.
    Unknown words receive per-POS open-class mass estimated from the
    POS's singleton count (words seen once), a small Good-Turing-style
    reserve.
    """

    def __init__(self, binary, unary, lexical, unk_logp, start="S"):
        self.binary: Dict[Tuple[str, str, str], float] = binary
        self.unary: Dict[Tuple[str, str], float] = unary
        self.lexical: Dict[Tuple[str, str], float] = lexical
        self.unk_logp: Dict[str, float] = unk_logp   # POS -> log P(<unk>|POS)
        self.start = start
        self.vocab = {w for (_, w) in lexical}

    # ---- estimation ----------------------------------------------------

    @classmethod
    def from_trees(cls, trees: List[Tree], start: str = "S") -> "Pcfg":
        collapse, binarize = CollapseUnaries(), BinarizeTreeTransformer()
        b_counts = defaultdict(int)     # (A, B, C)
        u_counts = defaultdict(int)     # (A, B)
        l_counts = defaultdict(int)     # (POS, word)
        lhs_tot = defaultdict(int)

        def walk(t: Tree):
            if t.is_leaf():
                return
            if t.is_preterminal():
                l_counts[(t.label, t.children[0].value)] += 1
                lhs_tot[t.label] += 1
                return
            kids = t.children
            if len(kids) == 1:
                u_counts[(t.label, kids[0].label)] += 1
            elif len(kids) == 2:
                b_counts[(t.label, kids[0].label, kids[1].label)] += 1
            else:   # cannot happen after binarization
                raise ValueError(f"non-binary node {t.label} survived "
                                 "binarization")
            lhs_tot[t.label] += 1
            for c in kids:
                walk(c)

        for t in trees:
            walk(binarize.transform(collapse.transform(t)))

        # open-class unknown mass: a POS with k singleton words reserves
        # k/(total+k) for <unk> by inflating its denominator (Witten-Bell
        # style), so every LHS's rule probabilities still sum to 1
        singletons = defaultdict(int)
        for (pos, _w), n in l_counts.items():
            if n == 1:
                singletons[pos] += 1
        denom = {a: t + singletons.get(a, 0) for a, t in lhs_tot.items()}
        unk_logp = {pos: math.log(k / denom[pos])
                    for pos, k in singletons.items()}

        def norm(counts):
            return {key: math.log(n / denom[key[0]])
                    for key, n in counts.items()}

        return cls(norm(b_counts), norm(u_counts), norm(l_counts),
                   unk_logp, start)

    @classmethod
    def from_treebank_file(cls, path, start: str = "S") -> "Pcfg":
        trees = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    trees.append(Tree.from_bracket(line))
        return cls.from_trees(trees, start)

    def tag_logps(self, word: str) -> Dict[str, float]:
        """POS -> log P(word|POS); unknown words get the open-class
        reserve."""
        out = {pos: lp for (pos, w), lp in self.lexical.items() if w == word}
        if not out:
            out = dict(self.unk_logp)
        return out


class PcfgParser:
    """CKY + unary closure max-probability decoder producing trees.py
    `Tree`s (debinarized, spans set). Drop-in for TreeVectorizer via
    ``get_trees(text)``."""

    _SENT_RE = re.compile(r"[^.?!]+")
    _TOK_RE = re.compile(r"[A-Za-z']+|[0-9]+|\S")

    def __init__(self, grammar: Pcfg):
        self.grammar = grammar
        # index binary rules by (B, C) for the O(n^3 * |rules|) inner loop
        self._by_rhs = defaultdict(list)
        for (a, b, c), lp in grammar.binary.items():
            self._by_rhs[(b, c)].append((a, lp))

    # ---- chart ---------------------------------------------------------

    def _closure(self, cell):
        """Apply unary rules to a filled cell until no score improves.
        Terminates even on rule cycles: log-probs are < 0, so a strict
        improvement requirement cannot loop forever."""
        changed = True
        while changed:
            changed = False
            for (a, b), lp in self.grammar.unary.items():
                got = cell.get(b)
                if got is None:
                    continue
                cand = lp + got[0]
                if a not in cell or cand > cell[a][0]:
                    cell[a] = (cand, ("u", b))
                    changed = True

    def parse(self, tokens: List[str]) -> Optional[Tree]:
        """Max-probability tree for ``tokens``, or None when the grammar
        cannot derive the sentence."""
        n = len(tokens)
        if n == 0:
            return None
        g = self.grammar
        # chart[(i, j)]: category -> (logp, backpointer) for span [i, j)
        chart = {}
        for i, w in enumerate(tokens):
            cell = {pos: (lp, ("lex", w))
                    for pos, lp in g.tag_logps(w).items()}
            if not cell:
                return None
            self._closure(cell)
            chart[(i, i + 1)] = cell
        for width in range(2, n + 1):
            for i in range(0, n - width + 1):
                j = i + width
                cell = {}
                for k in range(i + 1, j):
                    left, right = chart[(i, k)], chart[(k, j)]
                    for b, (lpb, _) in left.items():
                        for c, (lpc, _) in right.items():
                            for a, lp in self._by_rhs.get((b, c), ()):
                                cand = lp + lpb + lpc
                                if a not in cell or cand > cell[a][0]:
                                    cell[a] = (cand, ("b", k, b, c))
                self._closure(cell)
                chart[(i, j)] = cell
        root_cell = chart[(0, n)]
        root = (g.start if g.start in root_cell
                else max(root_cell, key=lambda a: root_cell[a][0],
                         default=None))
        if root is None:
            return None
        tree = self._debinarize(self._build(chart, 0, n, root))
        tree.tokens = tokens
        self._spans(tree, 0)
        return tree

    def _build(self, chart, i, j, a) -> Tree:
        _, bp = chart[(i, j)][a]
        node = Tree(value=a, label=a)
        if bp[0] == "lex":
            node.children = [Tree(value=bp[1])]
        elif bp[0] == "u":
            node.children = [self._build(chart, i, j, bp[1])]
        else:
            _, k, b, c = bp
            node.children = [self._build(chart, i, k, b),
                             self._build(chart, k, j, c)]
        return node

    @staticmethod
    def _debinarize(t: Tree) -> Tree:
        if t.is_leaf():
            return t
        kids = []
        for c in t.children:
            c = PcfgParser._debinarize(c)
            if c.label and c.label.startswith("@"):
                kids.extend(c.children)   # splice binarization artifacts
            else:
                kids.append(c)
        out = t.copy_node()
        out.children = kids
        return out

    def _spans(self, t: Tree, pos: int) -> int:
        if t.is_leaf():
            t.begin, t.end = pos, pos + 1
            return pos + 1
        t.begin = pos
        for c in t.children:
            pos = self._spans(c, pos)
        t.end = pos
        return pos

    # ---- TreeParser-compatible surface ---------------------------------

    def tokenize(self, sentence: str) -> List[str]:
        return self._TOK_RE.findall(sentence.lower())

    def get_trees(self, text: str) -> List[Tree]:
        """Sentence-split, tokenize, parse — same contract as
        trees.TreeParser.get_trees, so TreeVectorizer accepts this parser
        unchanged."""
        out = []
        for m in self._SENT_RE.finditer(text):
            toks = self.tokenize(m.group())
            if not toks:
                continue
            t = self.parse(toks)
            if t is not None:
                out.append(t)
        return out


def _brackets(t: Tree):
    """(label, begin, end) for every interior non-preterminal node."""
    out = []

    def walk(node, pos):
        if node.is_leaf():
            return pos + 1
        start = pos
        for c in node.children:
            pos = walk(c, pos)
        if not node.is_preterminal():
            out.append((node.label or node.value, start, pos))
        return pos

    walk(t, 0)
    return out


def parseval(gold: List[Tree], predicted: List[Tree]) -> Dict[str, float]:
    """Labeled-bracket PARSEVAL precision/recall/F1 over tree pairs (the
    standard constituency-parser score; the reference never ships one —
    its TreeParser is unscored plumbing — but a trained grammar warrants
    an honest metric)."""
    if len(gold) != len(predicted):
        raise ValueError(f"{len(gold)} gold vs {len(predicted)} predicted")
    match = g_tot = p_tot = 0
    for gt, pt in zip(gold, predicted):
        gb, pb = _brackets(gt), _brackets(pt)
        g_tot += len(gb)
        p_tot += len(pb)
        pool = list(gb)
        for b in pb:           # multiset intersection
            if b in pool:
                pool.remove(b)
                match += 1
    p = match / p_tot if p_tot else 0.0
    r = match / g_tot if g_tot else 0.0
    f1 = 2 * p * r / (p + r) if (p + r) else 0.0
    return {"precision": p, "recall": r, "f1": f1,
            "matched": match, "gold": g_tot, "predicted": p_tot}
