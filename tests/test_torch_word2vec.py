"""The port's Word2Vec path against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the reference's ``nlp`` modules
and through the port's: the vocabulary and its Huffman codes, the
tokenizers and sentence iterators, each update step (hierarchical softmax
and negative sampling, skip-gram and CBOW) under each scatter strategy,
whole fits, and the queries. The card's own checks (the ``sorted`` route
bitwise across two fits, a fit on the card against the CPU) are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: an f32 update or scatter within 1e-6 of the table's max abs
(both sides sum the same terms in another order); a bf16 table within
the reference's own bf16 bar, 2e-2 abs (``tests/test_nlp.py``); a whole
hierarchical-softmax fit within 1e-5 of each table's max abs (each step's
rounding feeds the next); vocabularies, codes, tokens and query answers
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nlp import lookup as jax_lookup
from deeplearning4j_tpu.nlp import sequence_vectors as jax_sv
from deeplearning4j_tpu.nlp import text as jax_text
from deeplearning4j_tpu.nlp import vocab as jax_vocab
from deeplearning4j_tpu.nlp import word2vec as jax_w2v
from deeplearning4j_tpu_torch.nlp import lookup as port_lookup
from deeplearning4j_tpu_torch.nlp import sequence_vectors as port_sv
from deeplearning4j_tpu_torch.nlp import text as port_text
from deeplearning4j_tpu_torch.nlp import vocab as port_vocab
from deeplearning4j_tpu_torch.nlp import word2vec as port_w2v

UPDATE_RTOL = 1e-6
BF16_TOL = 2e-2
FIT_RTOL = 1e-5
IMPLS = ("fused", "sorted", "two")


@pytest.fixture
def scatter():
    """Sets one scatter strategy on both sides, restored after. The
    reference's update functions run here unjitted, reading the strategy
    at each call, so its override is set directly, without
    ``set_scatter_impl``'s clearing of every compiled program."""
    jax_orig, port_orig = jax_lookup.SCATTER_IMPL, port_lookup.SCATTER_IMPL

    def use(impl):
        jax_lookup.SCATTER_IMPL = impl
        port_lookup.set_scatter_impl(impl)
    yield use
    jax_lookup.SCATTER_IMPL = jax_orig
    port_lookup.set_scatter_impl(port_orig)


def _zipf_sentences(n_words=6000, vocab=60, length=50, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, n_words, p=p / p.sum())
    words = np.array([f"w{i}" for i in range(vocab)])
    return [" ".join(words[ids[i:i + length]])
            for i in range(0, n_words, length)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# vocabulary, Huffman codes, tokenizers
# ---------------------------------------------------------------------------
def test_vocab_and_huffman_codes_equal_the_reference():
    seqs = [s.split() for s in _zipf_sentences()]
    labelled = [(["a", "b", "a"], "DOC_0"), (["b", "c"], "DOC_1")]
    out = []
    for mod in (jax_vocab, port_vocab):
        cache = mod.VocabConstructor(min_word_frequency=3) \
            .build_joint_vocabulary(seqs)
        docs = []
        for toks, lab in labelled:
            seq = mod.Sequence([mod.VocabWord(t) for t in toks])
            el = mod.VocabWord(lab)
            el.special = True
            seq.add_sequence_label(el)
            docs.append(seq)
        docs_cache = mod.VocabConstructor(min_word_frequency=2) \
            .build_joint_vocabulary(docs)
        out.append((cache, docs_cache))
    (jc, jd), (pc, pd) = out
    for j, p in ((jc, pc), (jd, pd)):
        assert p.words() == j.words()
        assert p.total_word_count == j.total_word_count
        assert [e.element_frequency for e in p.vocab_words()] == \
            [e.element_frequency for e in j.vocab_words()]
        assert [e.special for e in p.vocab_words()] == \
            [e.special for e in j.vocab_words()]
        for a, b in zip(p.huffman_arrays(), j.huffman_arrays()):
            np.testing.assert_array_equal(a, b)


def test_tokenizers_and_iterators_give_the_reference_tokens(tmp_path):
    texts = ["The CAT, sat!! 123 on the mat.", "  Dogs were running quickly ",
             "a b c d e", "", "king's (crown) [gold] | silver/bronze?"]
    for pre in ("CommonPreprocessor", "LowCasePreProcessor",
                "EndingPreProcessor", None):
        toks = []
        for mod in (jax_text, port_text):
            tf = mod.DefaultTokenizerFactory(
                getattr(mod, pre)() if pre else None)
            ng = mod.NGramTokenizerFactory(mod.DefaultTokenizerFactory(), 1, 3)
            toks.append([(tf.create(t).get_tokens(), tf.create(t).count_tokens(),
                          ng.create(t).get_tokens()) for t in texts])
        assert toks[0] == toks[1], pre
    path = tmp_path / "corpus.txt"
    path.write_text("first line\n\n  second line  \nthird\n")
    (tmp_path / "more").mkdir()
    (tmp_path / "more" / "b.txt").write_text("b one\nb two\n")
    got = []
    for mod in (jax_text, port_text):
        line = mod.BasicLineIterator(str(path), pre_processor=str.upper)
        files = mod.FileSentenceIterator(str(tmp_path))
        coll = mod.CollectionSentenceIterator(["x y", "z"])
        src = mod.LabelsSource()
        docs = mod.LabelAwareIterator.from_sentences(["p q", "r"], src)
        got.append((list(line), list(line), list(files), list(coll),
                    [(d.content, d.labels) for d in docs], src.get_labels()))
        line.close()
        files.close()
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the update steps and scatters, on the same numpy inputs
# ---------------------------------------------------------------------------
def _tables(V, D, seed):
    r = np.random.RandomState(seed)
    return (0.1 * r.randn(V, D)).astype(np.float32), \
        (0.1 * r.randn(V, D)).astype(np.float32)


def _step_inputs(kind, V, B, seed):
    """Index arrays of one batch for ``kind``: heavy collisions (B >> V)
    and padded entries."""
    r = np.random.RandomState(seed)
    out = {}
    if kind.startswith("cbow"):
        C = 5
        out["context"] = r.randint(0, V, (B, C))
        out["context_mask"] = (r.rand(B, C) < 0.7).astype(np.float32)
    else:
        out["centers"] = r.randint(0, V - 1, B)
    if kind.endswith("hs"):
        L = 6
        out["points"] = r.randint(0, V - 1, (B, L))
        out["codes"] = r.randint(0, 2, (B, L))
        lengths = r.randint(0, L + 1, B)
        out["mask"] = np.arange(L)[None, :] < lengths[:, None]
    else:
        K = 5
        out["targets"] = r.randint(0, V, (B, K + 1))
        labels = np.zeros((B, K + 1), np.int32)
        labels[:, 0] = 1
        out["labels"] = labels
        out["mask"] = (r.rand(B, K + 1) < 0.9).astype(np.float32)
    return out


_ORDER = {"hs": ("centers", "points", "codes", "mask"),
          "ns": ("centers", "targets", "labels", "mask"),
          "cbow_hs": ("context", "context_mask", "points", "codes", "mask"),
          "cbow_ns": ("context", "context_mask", "targets", "labels", "mask")}


def _jax_args(x, names):
    return [jnp.asarray(x[n].astype(np.float32) if x[n].dtype == bool
                        else x[n].astype(np.int32) if x[n].dtype.kind == "i"
                        else x[n]) for n in names]


def _port_args(x, names):
    return [torch.from_numpy(x[n].astype(np.int64)) if x[n].dtype.kind == "i"
            else torch.from_numpy(x[n]) for n in names]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["hs", "ns", "cbow_hs", "cbow_ns"])
def test_update_step_matches_the_reference(scatter, kind, impl):
    scatter(impl)
    V, D, B = 40, 8, 256
    syn0, syn1 = _tables(V, D, seed=1)
    x = _step_inputs(kind, V, B, seed=2)
    names = _ORDER[kind]
    fn = getattr(jax_lookup, f"_{kind}_update")
    w0, w1 = fn(jnp.asarray(syn0), jnp.asarray(syn1),
                *_jax_args(x, names), 0.025)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    got = getattr(port_lookup, f"{kind}_step")(t0, t1, *_port_args(x, names),
                                               0.025)
    assert got[0] is t0 and got[1] is t1      # in place
    assert _rel(t0, w0) <= UPDATE_RTOL
    assert _rel(t1, w1) <= UPDATE_RTOL
    # something moved: the comparison is not of untouched tables
    assert np.abs(t0.numpy() - syn0).max() > 1e-4
    assert np.abs(t1.numpy() - syn1).max() > 1e-4


@pytest.mark.parametrize("kind", ["hs", "ns", "cbow_hs", "cbow_ns"])
def test_scan_over_stacked_batches_matches_the_reference(kind):
    """The S-batch scans (the reference's ``lax.scan`` programs) on S = 2
    stacked batches with a learning rate each, default scatter."""
    V, D, B, S = 40, 8, 128, 2
    syn0, syn1 = _tables(V, D, seed=11)
    xs = [_step_inputs(kind, V, B, seed=12 + i) for i in range(S)]
    names = _ORDER[kind]
    stacked = {n: np.stack([x[n] for x in xs]) for n in names}
    lrs = np.array([0.025, 0.0125], np.float32)
    w0, w1 = getattr(jax_lookup, f"{kind}_scan")(
        jnp.asarray(syn0), jnp.asarray(syn1), *_jax_args(stacked, names),
        jnp.asarray(lrs))
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    getattr(port_lookup, f"{kind}_scan")(t0, t1, *_port_args(stacked, names),
                                         torch.from_numpy(lrs))
    assert _rel(t0, w0) <= UPDATE_RTOL
    assert _rel(t1, w1) <= UPDATE_RTOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["hs", "ns"])
def test_bf16_update_matches_the_reference(scatter, kind, impl):
    scatter(impl)
    V, D, B = 50, 16, 256
    syn0, syn1 = _tables(V, D, seed=3)
    x = _step_inputs(kind, V, B, seed=4)
    names = _ORDER[kind]
    fn = getattr(jax_lookup, f"_{kind}_update")
    w0, w1 = fn(jnp.asarray(syn0, jnp.bfloat16),
                jnp.asarray(syn1, jnp.bfloat16), *_jax_args(x, names), 0.025)
    t0 = torch.from_numpy(syn0).to(torch.bfloat16)
    t1 = torch.from_numpy(syn1).to(torch.bfloat16)
    getattr(port_lookup, f"{kind}_step")(t0, t1, *_port_args(x, names),
                                         0.025)
    assert t0.dtype == torch.bfloat16 and t1.dtype == torch.bfloat16
    np.testing.assert_allclose(t0.float().numpy(), np.asarray(w0, np.float32),
                               atol=BF16_TOL)
    np.testing.assert_allclose(t1.float().numpy(), np.asarray(w1, np.float32),
                               atol=BF16_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_damped_scatter_matches_the_reference(scatter, impl):
    """Heavy collisions (N >> V), padding (w 0) and count weights > 1."""
    scatter(impl)
    r = np.random.RandomState(0)
    V, D, N = 40, 8, 600
    table = r.randn(V, D).astype(np.float32)
    idx = r.randint(0, V, N)
    rows = r.randn(N, D).astype(np.float32)
    w = ((r.rand(N) < 0.8) * r.randint(1, 3, N)).astype(np.float32)
    want = jax_lookup._scatter_damped(jnp.asarray(table),
                                      jnp.asarray(idx.astype(np.int32)),
                                      jnp.asarray(rows), jnp.asarray(w))
    got = torch.from_numpy(table.copy())
    port_lookup._scatter_damped(got, torch.from_numpy(idx),
                                torch.from_numpy(rows), torch.from_numpy(w))
    assert _rel(got, want) <= UPDATE_RTOL
    with pytest.raises(ValueError, match="unknown scatter impl"):
        port_lookup.set_scatter_impl("bogus")


def test_bf16_collision_counts_do_not_saturate(scatter):
    """More than 256 colliders a row: every strategy must damp by 32/cnt,
    not by 32/256 (bf16 counts would stop at 256)."""
    r = np.random.RandomState(1)
    V, D, N = 4, 8, 2048
    table = (0.1 * r.randn(V, D)).astype(np.float32)
    idx = torch.from_numpy(r.randint(0, V, N))
    rows = torch.from_numpy((0.01 * r.randn(N, D)).astype(np.float32))
    w = torch.ones(N)
    for impl in IMPLS:
        scatter(impl)
        f32 = torch.from_numpy(table.copy())
        port_lookup._scatter_damped(f32, idx, rows, w)
        b16 = torch.from_numpy(table).to(torch.bfloat16)
        port_lookup._scatter_damped(b16, idx, rows, w)
        np.testing.assert_allclose(b16.float().numpy() - table,
                                   f32.numpy() - table, atol=3e-3,
                                   err_msg=impl)


def test_device_negative_scan_matches_the_reference_with_its_draws():
    """``ns_scan_devneg`` with the reference's ``jax.random`` draws handed
    in through ``draw``: the same tables after S steps."""
    r = np.random.RandomState(5)
    V, D, S, B, K, T = 30, 8, 3, 64, 4, 100
    syn0, syn1 = _tables(V, D, seed=6)
    table = r.randint(0, V, T).astype(np.int32)
    centers = r.randint(0, V, (S, B)).astype(np.int32)
    positives = r.randint(0, V, (S, B)).astype(np.int32)
    valid = r.rand(S, B) < 0.9
    lrs = np.array([0.025, 0.02, 0.015], np.float32)
    key = jax.random.PRNGKey(17)
    w0, w1 = jax_lookup.ns_scan_devneg(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(table),
        jnp.asarray(centers), jnp.asarray(positives), jnp.asarray(valid),
        jnp.asarray(lrs), K, key)
    keys = jax.random.split(key, S)

    def draw(s):
        return torch.from_numpy(np.asarray(jax.random.randint(
            keys[s], (B, K), 0, T)).astype(np.int64))
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    port_lookup.ns_scan_devneg(
        t0, t1, torch.from_numpy(table.astype(np.int64)),
        torch.from_numpy(centers.astype(np.int64)),
        torch.from_numpy(positives.astype(np.int64)),
        torch.from_numpy(valid), torch.from_numpy(lrs), K, draw)
    assert _rel(t0, w0) <= UPDATE_RTOL
    assert _rel(t1, w1) <= UPDATE_RTOL


def test_lookup_table_starts_from_the_reference_values():
    for dtype in ("float32", "bfloat16"):
        want = jax_lookup.InMemoryLookupTable(37, 12, seed=9, negative=5,
                                              dtype=dtype)
        got = port_lookup.InMemoryLookupTable(37, 12, seed=9, negative=5,
                                              dtype=dtype, device="cpu")
        np.testing.assert_array_equal(got.syn0.float().numpy(),
                                      np.asarray(want.syn0, np.float32))
        assert got.syn1.shape == want.syn1.shape
        assert got.syn1neg.shape == want.syn1neg.shape
        freqs = np.arange(37, 0, -1).astype(np.float64)
        want.build_ns_table(freqs)
        got.build_ns_table(freqs)
        np.testing.assert_array_equal(got._ns_table, want._ns_table)
        for rng in (np.random.RandomState, np.random.default_rng):
            np.testing.assert_array_equal(
                got.sample_negatives(rng(3), (4, 5)),
                want.sample_negatives(rng(3), (4, 5)))
    with pytest.raises(ValueError, match="unsupported table dtype"):
        port_lookup.InMemoryLookupTable(4, 2, dtype="float16", device="cpu")


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------
def _fit_pair(algo, monkeypatch=None, **kw):
    """The same Word2Vec fit on both sides: (jax model, port model)."""
    sents = _zipf_sentences()
    conf = dict(layer_size=12, window=3, min_word_frequency=2,
                batch_size=256, seed=7, epochs=2, sampling=1e-2)
    conf.update(kw)
    want = jax_w2v.Word2Vec(elements_learning_algorithm=getattr(jax_sv, algo)(),
                            **conf)
    want.fit_corpus(sents)
    got = port_w2v.Word2Vec(
        elements_learning_algorithm=getattr(port_sv, algo)(), device="cpu",
        **conf)
    if monkeypatch is not None:
        monkeypatch.setattr(got, "_draw_negatives", _jax_draws(got))
    got.fit_corpus(sents)
    return want, got


def _jax_draws(model):
    """The reference's negative draws for a chunk keyed by ``key``: step
    ``step`` of ``jax.random.split(PRNGKey(key), S)``."""
    def draw(key, step, S, B):
        keys = jax.random.split(jax.random.PRNGKey(key), S)
        d = jax.random.randint(keys[step], (B, model.negative), 0,
                               model.lookup_table._table_size)
        return torch.from_numpy(np.asarray(d).astype(np.int64))
    return draw


@pytest.mark.parametrize("algo", ["SkipGram", "CBOW"])
def test_hierarchical_softmax_fit_matches_the_reference(algo):
    want, got = _fit_pair(algo, use_hierarchic_softmax=True, negative=0)
    assert got.vocab.words() == want.vocab.words()
    assert _rel(got.lookup_table.syn0, want.lookup_table.syn0) <= FIT_RTOL
    assert _rel(got.lookup_table.syn1, want.lookup_table.syn1) <= FIT_RTOL


@pytest.mark.parametrize("algo", ["SkipGram", "CBOW"])
def test_negative_sampling_fit_matches_with_the_reference_draws(
        monkeypatch, algo):
    want, got = _fit_pair(algo, monkeypatch, use_hierarchic_softmax=False,
                          negative=3)
    assert _rel(got.lookup_table.syn0, want.lookup_table.syn0) <= FIT_RTOL
    assert _rel(got.lookup_table.syn1neg,
                want.lookup_table.syn1neg) <= FIT_RTOL


def test_negative_sampling_fit_repeats_and_trains_on_its_own_draws():
    """With the port's own device draws: a fit from one seed repeats
    bitwise (the generator reseeds each epoch, the tables reset in place),
    two epochs draw differently, and the words train."""
    sents = _zipf_sentences()
    conf = dict(layer_size=12, window=3, min_word_frequency=2,
                batch_size=256, seed=7, epochs=1, negative=3,
                use_hierarchic_softmax=False, device="cpu")
    w = port_w2v.Word2Vec(**conf)
    w.fit_corpus(sents)
    first = w.lookup_table.syn0.clone()
    table_obj = w.lookup_table.syn0
    w.build_vocab(s.split() for s in sents)      # fresh tables, in place
    assert w.lookup_table.syn0 is table_obj
    w.fit_corpus(sents)
    assert torch.equal(w.lookup_table.syn0, first)
    d = [w._draw_negatives(0, 0, 1, 64) for _ in range(2)]
    assert not torch.equal(d[0], d[1])
    assert float(first.std()) > 1e-3 and bool(torch.isfinite(first).all())


def test_words_nearest_and_accuracy_agree():
    words = ["king", "man", "woman", "queen", "apple", "dog"]
    vecs = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                     [0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 1.0, 0.0],
                     [0.0, 0.0, 0.0, 1.0], [0.1, 0.1, 0.1, 0.9]],
                    np.float32)
    questions = ["man king woman queen", "king man woman zebra",
                 "man king woman apple"]
    answers = []
    for vocab, sv, lk, kw in (
            (jax_vocab, jax_sv, jax_lookup, {}),
            (port_vocab, port_sv, port_lookup, {"device": "cpu"})):
        model = sv.SequenceVectors(layer_size=4, **kw)
        cache = vocab.VocabConstructor(min_word_frequency=1) \
            .build_joint_vocabulary(
                [vocab.Sequence([vocab.VocabWord(w) for w in words])])
        model.vocab = cache
        model.lookup_table = lk.InMemoryLookupTable(len(words), 4, seed=0,
                                                    **kw)
        by_index = np.zeros_like(vecs)
        for w, v in zip(words, vecs):
            by_index[cache.index_of(w)] = v
        model.lookup_table.syn0 = by_index if not kw \
            else torch.from_numpy(by_index)
        answers.append((model.words_nearest("king", 3),
                        model.words_nearest(["king", "woman"], ["man"], 1),
                        model.words_nearest(vecs[4], top_n=2),
                        model.similarity("king", "queen"),
                        model.accuracy(questions)))
    assert answers[0] == answers[1]
    assert answers[1][1] == ["queen"] and answers[1][4] == pytest.approx(0.5)


def test_paragraph_vectors_dbow_matches_the_reference():
    docs = _zipf_sentences(n_words=2000, length=40)
    out = []
    for text, w2v, kw in ((jax_text, jax_w2v, {}),
                          (port_text, port_w2v, {"device": "cpu"})):
        pv = w2v.ParagraphVectors(layer_size=8, window=2,
                                  min_word_frequency=1, batch_size=128,
                                  seed=5, epochs=1, **kw)
        pv.fit_documents(text.LabelAwareIterator.from_sentences(docs))
        out.append(pv)
    want, got = out
    assert got.vocab.words() == want.vocab.words()
    assert _rel(got.lookup_table.syn0, want.lookup_table.syn0) <= FIT_RTOL
    v_want, v_got = (m.infer_vector(docs[0]) for m in (want, got))
    assert _rel(v_got, v_want) <= FIT_RTOL
    assert got.predict(docs[3]) == want.predict(docs[3])
