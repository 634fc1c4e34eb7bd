"""The port's constituency trees and PCFG parser
(``deeplearning4j_tpu_torch/nlp/trees.py``, ``pcfg.py``) against the JAX
package's, on the reference tests' sentences, sentences drawn with numpy
from a seed over the treebank's words, and the committed treebank
(``tests/fixtures/mini_treebank.txt``).

Trees compare as bracket strings, binarised and collapsed, with their
spans, gold labels and head words: exactly. PCFG rule log-probabilities
agree to 1e-12 (the same sums of logs of the same counts) and CKY parses
exactly. TreeVectorizer with a port Word2Vec as its lookup attaches each
leaf the table's row bit for bit.
"""

import math
import os

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import pcfg as jpcfg
from deeplearning4j_tpu.nlp import trees as jtrees
from deeplearning4j_tpu_torch.nlp import pcfg, trees
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "mini_treebank.txt")
LOGP_TOL = 1e-12

TEXTS = ["The old cat jumped on the mat",
         "The cat sat. The dog ran.", "   ",
         "I saw the big red dog quickly running to London.",
         "Dr. Smith arrived at 3.15 p.m. sharp. He sat down. Then what?",
         "A very good book is on the table and it is not bad"]
LABELLED = [("I saw <PER> John Smith </PER> in <LOC> Paris </LOC>",
             None, ["PER", "LOC"]),
            ("I saw <PER> John </PER> yesterday", None, ["PER"]),
            ("The cat sat", "POS", None),
            ("<NEG> terrible awful </NEG> stuff", None, ["NEG"])]
BRACKETS = [
    "(S (NP (DT the) (NN cat)) (VP (VBD sat)) (PP (IN on) (NP (DT the) "
    "(NN mat))))",
    "(S (A a) (B b) (C c) (D d))", "(S (A a) (B b))",
    "(S (X (Y (NP (DT the) (NN cat)))))",
    "(S (NP (DT the) (JJ old) (NN cat)) (VP (VBD sat)) (PP (IN on) (NP "
    "(NN mat))))"]


def _treebank():
    with open(FIXTURE) as f:
        return [line.strip() for line in f
                if line.strip() and not line.startswith("#")]


def _nodes(t):
    """Every node's fields the packages share, in preorder."""
    out = [(t.value, t.label, t.gold_label, t.head_word, t.begin, t.end,
            tuple(t.tokens), tuple(t.tags))]
    for c in t.children:
        out.extend(_nodes(c))
    return out


def _same_trees(got, want):
    assert [t.to_bracket() for t in got] == [t.to_bracket() for t in want]
    assert [_nodes(t) for t in got] == [_nodes(t) for t in want]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", BRACKETS + _treebank()[:6])
def test_bracket_transforms_equal_reference(s):
    got, want = trees.Tree.from_bracket(s), jtrees.Tree.from_bracket(s)
    assert got.to_bracket() == want.to_bracket() == s
    assert got.yield_() == want.yield_() and got.depth() == want.depth()
    b = trees.BinarizeTreeTransformer().transform(got)
    jb = jtrees.BinarizeTreeTransformer().transform(want)
    assert b.to_bracket() == jb.to_bracket()
    c = trees.CollapseUnaries().transform(b)
    jc = jtrees.CollapseUnaries().transform(jb)
    assert c.to_bracket() == jc.to_bracket()
    trees.HeadWordFinder().assign_heads(got)
    jtrees.HeadWordFinder().assign_heads(want)
    _same_trees([got], [want])


@pytest.mark.parametrize("s", ["(S (NP the", "(S (NN a)) trailing",
                               "S (NN a)"])
def test_malformed_brackets_raise_as_reference(s):
    for mod in (trees, jtrees):
        with pytest.raises(ValueError):
            mod.Tree.from_bracket(s)


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_tree_parser_equals_reference(i):
    _same_trees(trees.TreeParser().get_trees(TEXTS[i]),
                jtrees.TreeParser().get_trees(TEXTS[i]))
    _same_trees(trees.TreeVectorizer().get_trees(TEXTS[i]),
                jtrees.TreeVectorizer().get_trees(TEXTS[i]))


@pytest.mark.parametrize("i", range(len(LABELLED)))
def test_context_labels_equal_reference(i):
    text, label, labels = LABELLED[i]
    assert trees.ContextLabelRetriever.string_with_labels(text) == \
        jtrees.ContextLabelRetriever.string_with_labels(text)
    _same_trees(trees.TreeParser().get_trees_with_labels(text, label, labels),
                jtrees.TreeParser().get_trees_with_labels(text, label,
                                                          labels))
    _same_trees(
        trees.TreeVectorizer().get_trees_with_labels(text, label, labels),
        jtrees.TreeVectorizer().get_trees_with_labels(text, label, labels))


@pytest.mark.parametrize("text,match", [
    ("<A> x </B>", "mismatch"), ("<A> x", "unclosed"),
    ("x </A>", "without a begin")])
def test_label_errors_as_reference(text, match):
    for mod in (trees, jtrees):
        with pytest.raises(ValueError, match=match):
            mod.ContextLabelRetriever.string_with_labels(text)
    for mod in (trees, jtrees):
        with pytest.raises(ValueError, match="not in allowed"):
            mod.TreeParser().get_trees_with_labels("<BAD> x </BAD>",
                                                   labels=["GOOD"])


class _FakeLookup:
    def vector(self, word):
        if word == "unknown":
            raise KeyError(word)
        return np.ones(4, np.float32) * len(word)


def test_vectorizer_lookup_contract_as_reference():
    text = "The quick brown fox jumped over the unknown dog"
    got = trees.TreeVectorizer(lookup=_FakeLookup()).get_trees(text)
    want = jtrees.TreeVectorizer(lookup=_FakeLookup()).get_trees(text)
    _same_trees(got, want)
    for a, b in zip(got[0].leaves(), want[0].leaves()):
        if b.vector is None:
            assert a.vector is None and a.value == "unknown"
        else:
            np.testing.assert_array_equal(a.vector, b.vector)


def test_vectorizer_attaches_word2vec_rows():
    """A port Word2Vec as the lookup: each known leaf carries the table's
    row bit for bit, an unknown one None."""
    corpus = ["the cat sat on the mat", "the dog ran to the cat",
              "a big dog sat on a mat"] * 5
    w2v = Word2Vec(layer_size=8, window=2, min_word_frequency=1, epochs=1,
                   batch_size=64, device="cpu")
    w2v.fit_corpus(corpus)
    [t] = trees.TreeVectorizer(lookup=w2v).get_trees("the cat sat on a zebra")
    table = w2v.lookup_table.all_vectors()
    for leaf in t.leaves():
        i = w2v.vocab.index_of(leaf.value)
        if i < 0:
            assert leaf.value == "zebra" and leaf.vector is None
        else:
            assert leaf.vector.dtype == np.float32
            np.testing.assert_array_equal(leaf.vector, table[i])


# ---------------------------------------------------------------------------
# PCFG
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grammars():
    got = pcfg.Pcfg.from_treebank_file(FIXTURE)
    want = jpcfg.Pcfg.from_treebank_file(FIXTURE)
    return got, want, pcfg.PcfgParser(got), jpcfg.PcfgParser(want)


@pytest.mark.parametrize("table", ["binary", "unary", "lexical", "unk_logp"])
def test_pcfg_rule_logps_equal_reference(grammars, table):
    got, want = getattr(grammars[0], table), getattr(grammars[1], table)
    assert set(got) == set(want) and got
    for k in want:
        assert abs(got[k] - want[k]) <= LOGP_TOL, k
    assert grammars[0].start == grammars[1].start


def test_pcfg_probabilities_normalize(grammars):
    g = grammars[0]
    mass = {}
    for (a, *_), lp in {**g.binary, **g.unary, **g.lexical}.items():
        mass[a] = mass.get(a, 0.0) + math.exp(lp)
    for pos, lp in g.unk_logp.items():
        mass[pos] = mass.get(pos, 0.0) + math.exp(lp)
    assert all(abs(m - 1.0) <= 1e-9 for m in mass.values())


@pytest.mark.parametrize("word", ["cat", "the", "zyxxyz", "chases"])
def test_pcfg_tag_logps_equal_reference(grammars, word):
    got, want = grammars[0].tag_logps(word), grammars[1].tag_logps(word)
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= LOGP_TOL for k in want)


def _drawn_sentences(n, seed):
    words = sorted({w for s in _treebank()
                    for w in trees.Tree.from_bracket(s).yield_()})
    r = np.random.RandomState(seed)
    return [list(r.choice(words, r.randint(2, 7))) for _ in range(n)] + [
        ["zzz", "qqq"], [], ["the", "zyxxyz", "sleeps"]]


@pytest.mark.parametrize("source", ["treebank", "drawn"])
def test_cky_parses_equal_reference(grammars, source):
    _, _, parser, jparser = grammars
    sents = ([trees.Tree.from_bracket(s).yield_() for s in _treebank()]
             if source == "treebank" else _drawn_sentences(12, seed=7))
    for toks in sents:
        got, want = parser.parse(list(toks)), jparser.parse(list(toks))
        assert (got is None) == (want is None), toks
        if want is not None:
            _same_trees([got], [want])


def test_pcfg_parseval_and_text_surface_equal_reference(grammars):
    _, _, parser, jparser = grammars
    gold = [trees.Tree.from_bracket(s) for s in _treebank()]
    jgold = [jtrees.Tree.from_bracket(s) for s in _treebank()]
    got = pcfg.parseval(gold, [parser.parse(t.yield_()) for t in gold])
    want = jpcfg.parseval(jgold, [jparser.parse(t.yield_()) for t in jgold])
    assert got == want and got["f1"] >= 0.9
    text = "The cat sleeps. The dog chases a bird. the teacher reads a book"
    _same_trees(parser.get_trees(text), jparser.get_trees(text))
    _same_trees(trees.TreeVectorizer(parser=parser).get_trees(text),
                jtrees.TreeVectorizer(parser=jparser).get_trees(text))
    with pytest.raises(ValueError):
        pcfg.parseval(gold[:1], [])
