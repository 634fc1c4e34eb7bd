"""The port's distributed embeddings (``nlp/distributed.py``) on the CPU,
held against the reference's (``tests/test_nlp_distributed.py``):

- the map-reduce vocabulary equals the reference's (counts, indices,
  Huffman codes and points) for 1, 3 and 5 partitions, and truncates;
- one worker is, table for table and bit for bit, the port's single
  ``Word2Vec`` fit over the same corpus (negative sampling and
  hierarchical softmax);
- two workers (averaging every epoch) learn the corpus's topics, and
  the hierarchical-softmax path runs.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import distributed as jdist
from deeplearning4j_tpu.nlp.text import \
    DefaultTokenizerFactory as JTokenizerFactory
from deeplearning4j_tpu.nlp.word2vec import \
    _tokenize_to_sequences as j_tokenize
from deeplearning4j_tpu_torch.nlp.distributed import (DistributedWord2Vec,
                                                      build_vocab_mapreduce)
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                   _tokenize_to_sequences)


def _corpus(n=120, seed=3):
    rng = np.random.RandomState(seed)
    topics = {
        "animal": "cat dog bird fish horse".split(),
        "food": "bread milk cheese apple rice".split(),
        "tech": "code chip data model tensor".split(),
    }
    keys = list(topics)
    return [" ".join(rng.choice(topics[keys[i % 3]], 8)) for i in range(n)]


def _vocab_view(cache):
    codes, points, lengths = cache.huffman_arrays()
    return {w: (cache.index_of(w), cache.word_frequency(w),
                int(lengths[cache.index_of(w)]),
                codes[cache.index_of(w)].tolist(),
                points[cache.index_of(w)].tolist())
            for w in cache.words()}


@pytest.mark.parametrize("parts", [1, 3, 5])
def test_mapreduce_vocab_equals_reference(parts):
    sents = _corpus()
    seqs = list(_tokenize_to_sequences(sents, DefaultTokenizerFactory()))
    jseqs = list(j_tokenize(sents, JTokenizerFactory()))
    got = build_vocab_mapreduce(seqs, parts, min_word_frequency=1)
    want = jdist.build_vocab_mapreduce(jseqs, parts, min_word_frequency=1)
    assert got.num_words() == want.num_words()
    assert _vocab_view(got) == _vocab_view(want)
    # and the single-process constructor's counts
    single = VocabConstructor(1).build_joint_vocabulary(iter(seqs))
    assert {w: got.word_frequency(w) for w in got.words()} == \
        {w: single.word_frequency(w) for w in single.words()}


def test_mapreduce_min_frequency_truncates():
    seqs = list(_tokenize_to_sequences(
        ["rare word here", "common common common"],
        DefaultTokenizerFactory()))
    cache = build_vocab_mapreduce(seqs, 2, min_word_frequency=2)
    assert cache.index_of("common") >= 0
    assert cache.index_of("rare") < 0


@pytest.mark.parametrize("hs", [False, True])
def test_one_worker_bitwise_single_fit(hs):
    """One worker averaging every epoch is the single-process fit."""
    sents = _corpus(60)
    kwargs = dict(layer_size=16, window=3, negative=0 if hs else 3,
                  use_hierarchic_softmax=hs, min_word_frequency=1, seed=42,
                  batch_size=64, device="cpu")
    single = Word2Vec(epochs=2, **kwargs)
    single.fit_corpus(sents)
    dist = DistributedWord2Vec(n_workers=1, epochs=2, **kwargs)
    dist.fit_corpus(sents)
    assert dist.coordinator_kind == "native"
    assert dist.vocab.words() == single.vocab.words()
    for name in ("syn0", "syn1", "syn1neg"):
        a = getattr(dist.lookup_table, name)
        b = getattr(single.lookup_table, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    w = single.vocab.words()[0]
    np.testing.assert_array_equal(dist.word_vector(w),
                                  single.get_word_vector(w))


def test_two_workers_learn_topic_structure():
    dist = DistributedWord2Vec(n_workers=2, epochs=3, prefer_native=False,
                               layer_size=24, window=4, negative=5,
                               use_hierarchic_softmax=False,
                               min_word_frequency=1, seed=7, batch_size=128,
                               device="cpu")
    dist.fit_corpus(_corpus(150))
    assert dist.coordinator_kind == "python" and dist.words_per_s > 0

    def sim(a, b):
        va, vb = dist.word_vector(a), dist.word_vector(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
    same = np.mean([sim("cat", "dog"), sim("bread", "milk"),
                    sim("code", "chip")])
    cross = np.mean([sim("cat", "bread"), sim("milk", "chip"),
                     sim("code", "fish")])
    assert same > cross, (same, cross)
    assert "dog" in dist.words_nearest("cat", 8)


def test_hs_path_two_workers():
    dist = DistributedWord2Vec(n_workers=2, epochs=1, layer_size=12,
                               window=3, negative=0,
                               use_hierarchic_softmax=True,
                               min_word_frequency=1, seed=1, batch_size=64,
                               device="cpu")
    dist.fit_corpus(_corpus(60))
    v = dist.word_vector("cat")
    assert v is not None and np.isfinite(v).all()
    assert dist.word_vector("absent") is None
    assert dist.words_nearest("absent") == []
