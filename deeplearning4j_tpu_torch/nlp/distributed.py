"""Distributed SequenceVectors and Word2Vec over the collective
coordinator: the port of ``deeplearning4j_tpu/nlp/distributed.py``.

The reference library's ``SparkSequenceVectors.java:48``
(``fitSequences:113-124``: export the sequences, train each partition,
exchange the parameters), ``TextPipeline.java`` (the vocabulary counted
map-reduce style, with Spark accumulators) and ``Word2VecPerformer``
(per-partition SGD against broadcast syn0/syn1).

Each worker is a thread with a full replica of the lookup tables on the
device (``nlp/lookup.py``; on the card its chunk programs are CUDA
graphs it captures itself, ``models/_cuda_graph.py`` serialising the
captures of the device) and an equal round-robin shard of the corpus.
After every epoch the replicas average syn0, syn1 and syn1neg through
the coordinator's allreduce, a float32 host round trip written back into
each replica's tables in place, so the captured programs stay bound to
them. With ``n_workers=1`` the whole path is bit for bit a single
``SequenceVectors.fit`` (the
TestCompareParameterAveragingSparkVsSingleMachine invariant).
"""

from __future__ import annotations

import threading
import time
from collections import Counter, OrderedDict
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import (AbstractCache, Huffman,
                                                Sequence, VocabWord)
from deeplearning4j_tpu_torch.parallel.coordinator import (connect,
                                                           start_coordinator)

__all__ = ["DistributedSequenceVectors", "DistributedWord2Vec",
           "build_vocab_mapreduce"]


# ---------------------------------------------------------------------------
# the map-reduce vocabulary (TextPipeline's part)
# ---------------------------------------------------------------------------
def _count_partition(sequences: List[Sequence]):
    """Map: one partition's word and label counts
    (``UpdateWordFreqAccumulatorFunction``'s part)."""
    words = Counter()
    labels = Counter()
    first_seen = OrderedDict()
    for seq in sequences:
        if not isinstance(seq, Sequence):   # a raw token list
            words.update(seq)
            first_seen.update(OrderedDict.fromkeys(seq))
            continue
        for el in seq.elements:
            words[el.label] += el.element_frequency
            first_seen.setdefault(el.label, None)
        for lab in seq.labels:
            labels[lab.label] += 1.0
            first_seen.setdefault(lab.label, None)
    return words, labels, list(first_seen)


def build_vocab_mapreduce(sequences: Iterable[Sequence], n_partitions: int,
                          min_word_frequency: float = 1,
                          build_huffman: bool = True) -> AbstractCache:
    """The vocabulary built as a cluster builds it: partition the corpus,
    count each partition concurrently (map), merge the counts in a fixed
    order (reduce), then truncate and Huffman-code once on the master.

    It holds the counts ``VocabConstructor.build_joint_vocabulary`` gives
    on the whole corpus."""
    seqs = list(sequences)
    parts: List[List[Sequence]] = [[] for _ in range(max(1, n_partitions))]
    for i, s in enumerate(seqs):
        parts[i % len(parts)].append(s)

    results = [None] * len(parts)

    def run(pi):
        results[pi] = _count_partition(parts[pi])

    threads = [threading.Thread(target=run, args=(pi,))
               for pi in range(len(parts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # reduce: a fixed merge in partition order
    words = Counter()
    labels = Counter()
    order: "OrderedDict[str, None]" = OrderedDict()
    for r in results:
        if r is None:
            continue
        w, l, seen = r
        words.update(w)
        labels.update(l)
        for lab in seen:
            order.setdefault(lab, None)

    cache = AbstractCache()
    for label in order:
        if label in labels:
            el = VocabWord(label, labels[label])
            el.special = True
        else:
            el = VocabWord(label, words[label])
        cache.add_token(el)
    cache.truncate(min_word_frequency)
    cache.update_words_occurrences()
    if build_huffman:
        Huffman(cache.vocab_words()).apply_indexes(cache)
    return cache


# ---------------------------------------------------------------------------
# distributed training
# ---------------------------------------------------------------------------
class DistributedSequenceVectors:
    """Partitioned SequenceVectors training with parameter averaging.

    Each worker owns a full replica of the lookup tables and an equal
    round-robin shard of the corpus; after every epoch the replicas are
    averaged through the coordinator's allreduce. ``sv_kwargs`` are
    ``SequenceVectors``'s (``device`` included: None means the card).
    ``words_per_s`` holds the last fit's rate over the whole corpus, and
    ``coordinator_kind`` which coordinator served it.
    """

    def __init__(self, n_workers: int = 2, coordinator_port: int = 0,
                 prefer_native: bool = True, **sv_kwargs):
        self.n_workers = max(1, int(n_workers))
        self.coordinator_port = coordinator_port
        self.prefer_native = prefer_native
        self.sv_kwargs = dict(sv_kwargs)
        self.epochs = int(self.sv_kwargs.pop("epochs", 1))
        self.vocab: Optional[AbstractCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._template = SequenceVectors(epochs=1, **self.sv_kwargs)
        self.coordinator_kind = None
        self.words_per_s = None

    # -- SparkSequenceVectors.fitSequences:113-124 ----------------------
    def fit(self, sequences_provider: Callable[[], Iterable[Sequence]]) -> None:
        seqs = list(sequences_provider())
        if self.vocab is None:
            self.vocab = build_vocab_mapreduce(
                seqs, self.n_workers,
                min_word_frequency=self._template.min_word_frequency,
                build_huffman=self._template.use_hs)

        shards = [seqs[w::self.n_workers] for w in range(self.n_workers)]
        workers = [self._make_worker(w) for w in range(self.n_workers)]
        total_global = max(self.vocab.total_word_count * self.epochs, 1.0)

        t0 = time.perf_counter()
        with start_coordinator(self.n_workers, self.coordinator_port,
                               prefer_native=self.prefer_native) as coord:
            self.coordinator_kind = coord.kind
            errors: List[BaseException] = []

            def run(w: int):
                try:
                    self._worker_loop(workers[w], shards[w], w, coord.port,
                                      total_global)
                except BaseException as e:  # surfaced after the join
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(w,), daemon=True,
                                        name=f"dl4j-torch-sv-worker-{w}")
                       for w in range(self.n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            alive = [t for t in threads if t.is_alive()]
            if alive:
                raise RuntimeError(f"{len(alive)} embedding worker(s) hung")
            if errors:
                raise errors[0]
        self.words_per_s = total_global / (time.perf_counter() - t0)

        # the master adopts worker 0's tables (averaged, so the consensus)
        self.lookup_table = workers[0].lookup_table

    def _make_worker(self, w: int) -> SequenceVectors:
        kwargs = dict(self.sv_kwargs)
        # a stream of its own for each worker; worker 0 keeps the master's
        # seed, so that one worker is a single-process fit to the bit
        kwargs["seed"] = int(kwargs.get("seed", 123)) + w
        sv = SequenceVectors(epochs=1, **kwargs)
        sv.install_vocab(self.vocab,
                         table_seed=int(self.sv_kwargs.get("seed", 123)))
        return sv

    def _worker_loop(self, sv: SequenceVectors, shard: List[Sequence], w: int,
                     port: int, total_global: float):
        client = connect("127.0.0.1", port, w, prefer_native=self.prefer_native)
        try:
            rng = np.random.RandomState(sv.seed)
            # the learning rate decays on the GLOBAL schedule: this worker
            # sees 1/n of the words, so its count is scaled to the global
            # clock
            processed = 0.0
            for _ in range(self.epochs):
                local = sv._fit_epoch(
                    shard, rng,
                    processed / self.n_workers, total_global / self.n_workers)
                processed = local * self.n_workers
                # parameter averaging over the collective (the
                # VoidParameterServer exchange of SparkSequenceVectors as
                # one allreduce an epoch): f32 on the host, written back
                # into the tables in place, in their dtype
                tbl = sv.lookup_table
                for name in ("syn0", "syn1", "syn1neg"):
                    t = getattr(tbl, name)
                    if t is None:
                        continue
                    avg = client.allreduce(t.float().cpu().numpy(),
                                           tag=name) / self.n_workers
                    with torch.no_grad():
                        t.copy_(torch.from_numpy(avg).to(t.device))
        finally:
            client.close()

    # -- lookups (the reference's wordVectors surface) ------------------
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return self.lookup_table.vector(i)

    def words_nearest(self, word: str, top_n: int = 10) -> List[str]:
        v = self.word_vector(word)
        if v is None:
            return []
        m = self.lookup_table.all_vectors()
        sims = m @ v / (np.linalg.norm(m, axis=1) * np.linalg.norm(v) + 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            lab = self.vocab.word_at_index(int(i))
            if lab != word:
                out.append(lab)
            if len(out) >= top_n:
                break
        return out


class DistributedWord2Vec(DistributedSequenceVectors):
    """Distributed Word2Vec (``SparkWord2Vec``'s part): raw sentences,
    tokenized into sequences, through DistributedSequenceVectors.fit."""

    def __init__(self, tokenizer_factory=None, **kwargs):
        super().__init__(**kwargs)
        from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def fit_corpus(self, sentences: Iterable[str]) -> None:
        from deeplearning4j_tpu_torch.nlp.word2vec import \
            _tokenize_to_sequences
        sents = list(sentences)

        def provider():
            return _tokenize_to_sequences(sents, self.tokenizer_factory)

        self.fit(provider)
