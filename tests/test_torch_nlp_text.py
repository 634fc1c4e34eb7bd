"""The port's text modules (``deeplearning4j_tpu_torch/nlp``: the
bag-of-words and tf-idf vectorizers, the BPE tokenizer, the analysis
pipeline and the Japanese and Korean tokenizers) against the JAX
package's, on the reference tests' own texts and on corpora drawn with
numpy from a seed.

Every comparison is exact: these modules are host code over strings and
numpy, and the port runs the reference's algorithms (vectors bit for bit,
merges, vocabularies, ids, JSON, segments, tags, scores and tokens
equal). Word2Vec over the Japanese and Korean tokenizers runs on the
CPU here: its vocabulary must be the tokenizer's own tokens.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import analysis as janalysis
from deeplearning4j_tpu.nlp import bpe as jbpe
from deeplearning4j_tpu.nlp import japanese as jjapanese
from deeplearning4j_tpu.nlp import korean as jkorean
from deeplearning4j_tpu.nlp import vectorizer as jvectorizer
from deeplearning4j_tpu_torch import nlp
from deeplearning4j_tpu_torch.nlp import analysis, bpe, japanese, korean
from deeplearning4j_tpu_torch.nlp import vectorizer
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

BPE_CORPUS = ["low lower lowest", "new newer newest", "wide wider widest",
              "low low low new new wide"] * 10
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big", "red",
         "tpu", "is", "fast", "and", "slow", "not", "good", "bad", "Dr.",
         "3.15", "p.m.", "sharp", "London", "running", "quickly", "great",
         "terrible", "love", "hate", "never", "very"]


def _docs(n, seed, length=(3, 12)):
    r = np.random.RandomState(seed)
    return [" ".join(r.choice(WORDS, r.randint(*length)))
            + r.choice(["", ".", "!", "?"]) for _ in range(n)]


def test_exports_match_reference():
    import deeplearning4j_tpu.nlp as jnlp
    for name in ("BagOfWordsVectorizer", "TfidfVectorizer", "Pcfg",
                 "PcfgParser", "BinarizeTreeTransformer", "CollapseUnaries",
                 "ContextLabelRetriever", "HeadWordFinder", "Tree",
                 "TreeParser", "TreeVectorizer", "BpeTokenizer"):
        assert hasattr(jnlp, name) and hasattr(nlp, name), name


# ---------------------------------------------------------------------------
# vectorizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("opts", [{}, {"min_word_frequency": 2,
                                       "stop_words": ["the", "a"]}],
                         ids=["default", "min2_stop"])
def test_vectorizer_equals_reference(kind, opts):
    docs = _docs(40, seed=1)
    got = getattr(vectorizer, kind)(**opts).fit(docs)
    want = getattr(jvectorizer, kind)(**opts).fit(docs)
    assert got.vocab.words() == want.vocab.words()
    assert got.doc_count == want.doc_count
    probe = _docs(10, seed=2) + ["", "zzz unknown"]
    a, b = got.transform_documents(probe), want.transform_documents(probe)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_reference_vectorizer_cases():
    bow = vectorizer.BagOfWordsVectorizer().fit(["a a b", "b c"])
    v = bow.transform("a b b z")
    assert v[bow.vocab.index_of("a")] == 1 and v.sum() == 3
    tv = vectorizer.TfidfVectorizer().fit(["a a b", "b c", "b d"])
    v = tv.transform("a b")
    assert v[tv.vocab.index_of("b")] == 0.0
    assert v[tv.vocab.index_of("a")] == pytest.approx(0.5 * np.log(3.0),
                                                      rel=1e-6)


# ---------------------------------------------------------------------------
# BPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("corpus,vocab_size", [
    ("reference", 60), ("reference", 80), ("reference", 120),
    ("drawn", 200)])
def test_bpe_train_equals_reference(corpus, vocab_size):
    texts = BPE_CORPUS if corpus == "reference" else _docs(80, seed=3)
    got = bpe.BpeTokenizer.train(texts, vocab_size=vocab_size)
    want = jbpe.BpeTokenizer.train(texts, vocab_size=vocab_size)
    assert got.merges == want.merges
    assert got.vocab == want.vocab
    assert got.vocab_size() == want.vocab_size()
    assert got.to_json() == want.to_json()
    for text in ["lower and wider", "low newest wide", "zzzq", "éé",
                 " ".join(texts[:3])]:
        assert got.tokenize(text) == want.tokenize(text)
        ids = got.encode(text)
        assert ids == want.encode(text)
        assert got.decode(ids) == want.decode(ids)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bpe_json_loads_across_packages(tmp_path, writer):
    mods = {"port": bpe, "reference": jbpe}
    src = mods[writer].BpeTokenizer.train(BPE_CORPUS, vocab_size=70)
    path = str(tmp_path / "bpe.json")
    src.save(path)
    reader = mods["reference" if writer == "port" else "port"]
    back = reader.BpeTokenizer.load(path)
    assert back.vocab == src.vocab and back.merges == src.merges
    assert back.to_json() == src.to_json()
    assert json.loads(back.to_json()) == json.loads(open(path).read())
    for s in ("lowest newest", "wider lows"):
        assert back.encode(s) == src.encode(s)


def test_bpe_reference_cases():
    t = bpe.BpeTokenizer.train(BPE_CORPUS, vocab_size=120)
    assert len(t.tokenize("low")) <= 2
    assert all(i == t.vocab["<unk>"] for i in t.encode("éé")[:-1])
    assert t.decode(t.encode("low newest wide")) == "low newest wide"


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------
SEGMENT_TEXTS = [
    "Dr. Smith arrived at 3.15 p.m. sharp. He sat down. Then what?",
    "   ", "One sentence only", "Mr. and Mrs. Jones left! Did they? Yes.",
    "e.g. this is fine. U.S. policy changed... Okay!"]


@pytest.mark.parametrize("i", range(len(SEGMENT_TEXTS)))
def test_segmenter_equals_reference(i):
    text = SEGMENT_TEXTS[i]
    assert analysis.SentenceSegmenter().segment(text) == \
        janalysis.SentenceSegmenter().segment(text)


@pytest.mark.parametrize("seed", range(3))
def test_pos_tags_equal_reference(seed):
    for text in _docs(20, seed=10 + seed) + [
            "The quick dog is running to London quickly"]:
        got = [(t.token, t.tag) for t in analysis.PosTagger().tag(text)]
        want = [(t.token, t.tag) for t in janalysis.PosTagger().tag(text)]
        assert got == want
        assert analysis.PosTagger().tokenize(text) == \
            janalysis.PosTagger().tokenize(text)


@pytest.mark.parametrize("lexicon", [None, {"tpu": 0.9, "slow": -0.4}],
                         ids=["builtin", "custom"])
def test_sentiment_equals_reference(lexicon):
    got, want = analysis.SentimentAnalyzer(), janalysis.SentimentAnalyzer()
    if lexicon:
        got.load_lexicon(lexicon)
        want.load_lexicon(lexicon)
    for text in _docs(40, seed=20) + [
            "This framework is great and I love it", "not good at all",
            "terrible, awful experience", "the sky has clouds"]:
        assert got.score(text) == want.score(text)
        assert got.classify(text) == want.classify(text)


# ---------------------------------------------------------------------------
# Japanese and Korean
# ---------------------------------------------------------------------------
JA_TEXTS = ["私は日本語です", "カタカナとABC123", "東京 大阪", "機械学習",
            "今日は日本です", "私は東京で機械学習を勉強しています。",
            "ひらがなカタカナ漢字ABCdef123、テスト"]
KO_TEXTS = ["사람은", "나는", "나은", "학교에서 공부", "TPU는 빠르다123",
            "저는 학교에 갑니다", "책을 읽었다 그리고 친구가 왔다"]


def test_patricia_trie_equals_reference():
    words = ["te", "test", "tea", "team", "toast", "日本", "日本語", "日",
             "の", "rom", "romane", "romanus", "romulus", "abc", "abc"]
    got, want = japanese.PatriciaTrie(), jjapanese.PatriciaTrie()
    for i, w in enumerate(words):
        got.insert(w, i)
        want.insert(w, i)
    assert len(got) == len(want)
    for w in set(words):
        assert got.get(w) == want.get(w)
    for probe in ("toas", "nope", "日本語を話す", "romanesque", "teams"):
        assert (probe in got) == (probe in want)
        assert list(got.common_prefixes(probe)) == \
            list(want.common_prefixes(probe))


@pytest.mark.parametrize("lexicon", [None, {"機械学習": 80}],
                         ids=["builtin", "custom"])
def test_japanese_tokens_equal_reference(lexicon):
    got, want = japanese.ViterbiTokenizer(), jjapanese.ViterbiTokenizer()
    if lexicon:
        got.load_lexicon(lexicon)
        want.load_lexicon(lexicon)
    for text in JA_TEXTS:
        toks = got.tokenize(text)
        assert toks == want.tokenize(text)
        assert "".join(toks) == "".join(text.split())
    f, jf = japanese.JapaneseTokenizerFactory(), \
        jjapanese.JapaneseTokenizerFactory()
    for text in JA_TEXTS:
        assert f.create(text).get_tokens() == jf.create(text).get_tokens()


def test_korean_tokens_equal_reference():
    for text in KO_TEXTS:
        assert korean.KoreanTokenizer().tokenize(text) == \
            jkorean.KoreanTokenizer().tokenize(text)
        assert korean.KoreanTokenizerFactory().create(text).get_tokens() == \
            jkorean.KoreanTokenizerFactory().create(text).get_tokens()


@pytest.mark.parametrize("lang", ["japanese", "korean"])
def test_word2vec_vocabulary_is_the_tokenizers(lang):
    """Word2Vec on the CPU over each factory: its vocabulary is exactly
    the set of tokens the host tokenizer makes of the corpus."""
    if lang == "japanese":
        factory, corpus = japanese.JapaneseTokenizerFactory(), JA_TEXTS * 4
    else:
        factory, corpus = korean.KoreanTokenizerFactory(), KO_TEXTS * 4
    w2v = Word2Vec(tokenizer_factory=factory, layer_size=8, window=2,
                   min_word_frequency=1, epochs=1, batch_size=64,
                   device="cpu")
    w2v.fit_corpus(corpus)
    tokens = {t for text in corpus for t in factory.create(text).get_tokens()}
    assert set(w2v.vocab.words()) == tokens
    assert np.isfinite(w2v.lookup_table.all_vectors()).all()
