"""GloVe and WordVectorSerializer of the port against the JAX package's,
on the CPU.

- The co-occurrence table (the port builds it with numpy, the reference
  with a dict): the same pairs in the same first-seen order, and the
  same float64 counts, bitwise.
- ``Glove.fit_corpus`` from one seed: the same vocabulary, the same
  initial tables and batches (numpy draws in the reference's order), so
  after 2 epochs the embedding is within 1e-5 of its max abs of the
  reference's and the mean loss within 1e-5 relative (only f32 rounding
  differs: the port sums colliding rows by sorted f64 prefix sums, the
  reference adds them one by one in f32). Two port fits give the same
  bits.
- WordVectorSerializer: files written by either package read in the
  other to the same vocabulary and vectors (text within its ``%.6f``
  and one f32 rounding,
  Google binary and the zip bitwise, syn1 and syn1neg included), and
  the text and binary files of one model are the same bytes.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu_torch.nlp import glove as pglove
from deeplearning4j_tpu_torch.nlp import serializer as pser
from deeplearning4j_tpu_torch.nlp.text import CollectionSentenceIterator
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

TABLE_REL = 1e-5
# %.6f: half a unit, then the f32 rounding of the value read (one step)
TEXT_ATOL, TEXT_RTOL = 5e-7, 2.0 ** -23


def _corpus(n_sent=60, vocab=40, seed=0):
    """Zipf-ish sentences of 1-14 words (some shorter than the window)."""
    r = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(f"w{i}" for i in r.choice(vocab, r.randint(1, 15), p=p))
            for _ in range(n_sent)]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("window,symmetric", [(3, True), (5, True),
                                              (5, False)])
def test_co_occurrences_equal_the_reference(window, symmetric):
    r = np.random.RandomState(window)
    seqs = [list(r.randint(0, 30, r.randint(0, 20))) for _ in range(50)]
    want = jglove.AbstractCoOccurrences(window, symmetric)
    got = pglove.AbstractCoOccurrences(window, symmetric)
    for s in seqs:
        want.accumulate(s)
        got.accumulate(s)
    assert list(got.counts.items()) == list(want.counts.items())
    for a, b in zip(got.pairs(), want.pairs()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _fit(pkg, corpus, **kw):
    kw = dict(dict(layer_size=16, window=5, min_word_frequency=1, epochs=2,
                   batch_size=64, seed=17), **kw)
    if pkg is pglove:
        kw["device"] = "cpu"
    g = pkg.Glove(**kw)
    g.fit_corpus(corpus)
    return g


@pytest.mark.parametrize("symmetric", [True, False])
def test_glove_fit_matches_the_reference(symmetric):
    corpus = _corpus()
    want = _fit(jglove, corpus, symmetric=symmetric)
    got = _fit(pglove, corpus, symmetric=symmetric)
    assert got.vocab.words() == want.vocab.words()
    syn0 = np.asarray(want.lookup_table.syn0)
    assert _rel(got.lookup_table.all_vectors(), syn0) <= TABLE_REL
    assert abs(got.loss_ - want.loss_) <= 1e-5 * abs(want.loss_)
    assert len(got.epoch_losses_) == 2


def test_two_fits_give_the_same_bits_and_learn():
    corpus = _corpus(n_sent=0) + [
        "the cat sat on the mat", "the dog sat on the rug",
        "a cat and a dog are pets", "the king rules the land",
        "the queen rules the kingdom", "king and queen wear crowns"] * 10
    kw = dict(epochs=8, batch_size=256, learning_rate=0.1)
    a, b = _fit(pglove, corpus, **kw), _fit(pglove, corpus, **kw)
    np.testing.assert_array_equal(a.lookup_table.all_vectors(),
                                  b.lookup_table.all_vectors())
    assert a.epoch_losses_ == b.epoch_losses_
    assert a.epoch_losses_[-1] < a.epoch_losses_[0]
    assert a.similarity("king", "queen") > a.similarity("king", "mat")


def test_chunked_route_gives_the_step_route_s_bits(monkeypatch):
    """The card's route (``_GLOVE_S`` steps a captured chunk, the last
    chunk padded with steps of mask 0) run here eagerly: the same
    embedding bits and losses as one step a call."""
    corpus = _corpus(n_sent=80)
    want = _fit(pglove, corpus, batch_size=32)
    monkeypatch.setattr(pglove, "captures_graphs", lambda device: True)
    monkeypatch.setattr(pglove, "_GLOVE_S", 7)
    got = _fit(pglove, corpus, batch_size=32)
    np.testing.assert_array_equal(got.lookup_table.all_vectors(),
                                  want.lookup_table.all_vectors())
    assert got.epoch_losses_ == want.epoch_losses_


# ---------------------------------------------------------------------------
# WordVectorSerializer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One trained port model (hierarchical softmax and negative sampling,
    so the zip holds syn1 and syn1neg), and the same model loaded in the
    JAX package from the port's zip."""
    w2v = Word2Vec(layer_size=12, window=3, min_word_frequency=1, epochs=1,
                   batch_size=128, negative=3, seed=3, device="cpu")
    w2v.fit_corpus(CollectionSentenceIterator(_corpus(seed=1)))
    path = str(tmp_path_factory.mktemp("w2v") / "w2v.zip")
    pser.WordVectorSerializer.write_word2vec_model(w2v, path)
    return w2v, jser.WordVectorSerializer.read_word2vec_model(path)


def _vectors(model):
    return {w: np.asarray(model.get_word_vector(w))
            for w in model.vocab.words()}


FORMATS = {"text": ("write_word_vectors", "read_word_vectors",
                    (TEXT_ATOL, TEXT_RTOL)),
           "binary": ("write_google_binary", "read_google_binary", (0, 0)),
           "zip": ("write_word2vec_model", "read_word2vec_model", (0, 0))}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_files_read_across_the_packages(models, tmp_path, fmt, direction):
    port_model, jax_model = models
    write, read, (atol, rtol) = FORMATS[fmt]
    if direction == "port_to_jax":
        src, writer, reader, kw = port_model, pser, jser, {}
    else:
        src, writer, reader, kw = jax_model, jser, pser, {"device": "cpu"}
    path = str(tmp_path / f"vectors.{fmt}")
    getattr(writer.WordVectorSerializer, write)(src, path)
    back = getattr(reader.WordVectorSerializer, read)(path, **kw)
    assert back.vocab.words() == src.vocab.words()
    want, got = _vectors(src), _vectors(back)
    for w in want:
        np.testing.assert_allclose(got[w], want[w], rtol=rtol, atol=atol,
                                   err_msg=w)
    if fmt == "zip":
        assert back.vocab.word_frequency("w0") == \
            src.vocab.word_frequency("w0")
        for name in ("syn1", "syn1neg"):
            np.testing.assert_array_equal(
                np.asarray(getattr(back.lookup_table, name)),
                np.asarray(getattr(src.lookup_table, name)))


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_text_and_binary_files_are_the_same_bytes(models, tmp_path, fmt):
    port_model, jax_model = models
    write = FORMATS[fmt][0]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    getattr(pser.WordVectorSerializer, write)(port_model, a)
    getattr(jser.WordVectorSerializer, write)(jax_model, b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_zip_model_keeps_training_state(models, tmp_path):
    """A zip read back in the port keeps its configuration, Huffman codes
    on the device and negative-sampling table, so it can train on."""
    port_model, _ = models
    path = str(tmp_path / "w2v.zip")
    pser.WordVectorSerializer.write_word2vec_model(port_model, path)
    back = pser.WordVectorSerializer.read_word2vec_model(path, device="cpu")
    cfg = pser.VectorsConfiguration(layer_size=12, window=3, negative=3,
                                    seed=3)
    assert (back.layer_size, back.window, back.negative, back.seed) == \
        (cfg.layer_size, cfg.window, cfg.negative, cfg.seed)
    for a, b in zip(back._hs_dev, (port_model._codes, port_model._points,
                                   port_model._lengths)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(back.lookup_table._ns_table,
                                  port_model.lookup_table._ns_table)
    back.fit(lambda: [s.split() for s in _corpus(seed=2)])
    assert np.isfinite(back.lookup_table.all_vectors()).all()


def test_jax_word2vec_zip_reads_in_the_port(tmp_path):
    w2v = JWord2Vec(layer_size=8, window=2, min_word_frequency=1, epochs=1,
                    batch_size=64, seed=5)
    from deeplearning4j_tpu.nlp.text import \
        CollectionSentenceIterator as JIter
    w2v.fit_corpus(JIter(_corpus(n_sent=20, seed=4)))
    path = str(tmp_path / "j.zip")
    jser.WordVectorSerializer.write_word2vec_model(w2v, path)
    back = pser.WordVectorSerializer.read_word2vec_model(path, device="cpu")
    for w in w2v.vocab.words():
        np.testing.assert_array_equal(back.get_word_vector(w),
                                      np.asarray(w2v.get_word_vector(w)))
