"""DeepWalk graph embeddings: the port of
``deeplearning4j_tpu/graph/deepwalk.py``.

``deeplearning4j-graph``'s ``models/deepwalk/DeepWalk.java`` (``fit:93-154``:
random walks, then hierarchical-softmax SkipGram over a Huffman tree of
the vertices), the ``GraphVectors`` query surface and
``util/GraphVectorSerializer.java``. The walks become ``Sequence``s of
vertex-id tokens and train through the port's ``SequenceVectors`` (the
Word2Vec trainer, on the device: None means the card), as the reference
reuses its own. The walks come from numpy seeds, so they are the
reference's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walkers import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import (AbstractCache, Sequence,
                                                VocabWord)

__all__ = ["DeepWalk", "GraphVectorSerializer"]


class DeepWalk:
    """``DeepWalk.java``'s builder surface: vectorSize, windowSize,
    learningRate, walkLength, walks per vertex, seed; ``device`` is where
    the tables live and train (None means the card)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 1, batch_size: int = 512,
                 seed: int = 123, device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sv: Optional[SequenceVectors] = None
        self.graph: Optional[Graph] = None

    def fit(self, graph_or_walks) -> "DeepWalk":
        """Fit from a Graph (walks made here, ``fit:93``) or from any
        iterable of integer walks (``fit(GraphWalkIterator)``)."""
        if isinstance(graph_or_walks, Graph):
            self.graph = graph_or_walks

            def provider():
                for rep in range(self.walks_per_vertex):
                    it = RandomWalkIterator(self.graph, self.walk_length,
                                            seed=self.seed + rep)
                    for walk in it:
                        yield Sequence([VocabWord(str(v)) for v in walk])
        else:
            walks = [list(w) for w in graph_or_walks]

            def provider():
                for walk in walks:
                    yield Sequence([VocabWord(str(v)) for v in walk])

        self._sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window_size,
            min_word_frequency=1, learning_rate=self.learning_rate,
            use_hierarchic_softmax=True, batch_size=self.batch_size,
            seed=self.seed, device=self.device)
        self._sv.fit(provider)
        return self

    # the GraphVectors query surface (models/GraphVectors.java)
    def get_vertex_vector(self, vertex: int) -> np.ndarray:
        v = self._sv.get_word_vector(str(vertex))
        if v is None:
            raise ValueError(f"vertex {vertex} not in trained vocab")
        return v

    def similarity(self, v1: int, v2: int) -> float:
        return self._sv.similarity(str(v1), str(v2))

    def verticesNearest(self, vertex: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(vertex), top_n)]

    vertices_nearest = verticesNearest

    def num_vertices(self) -> int:
        return self._sv.vocab.num_words()


class GraphVectorSerializer:
    """``util/GraphVectorSerializer.java``: a line a vertex,
    ``<vertex>\\t<v0>\\t<v1>...`` with ``%.8f`` values."""

    @staticmethod
    def write_graph_vectors(model: DeepWalk, path: str) -> None:
        with open(path, "w") as f:
            for w in model._sv.vocab.words():
                vec = model._sv.get_word_vector(w)
                f.write(w + "\t" + "\t".join(f"{x:.8f}" for x in vec) + "\n")

    @staticmethod
    def read_graph_vectors(path: str, device=None) -> DeepWalk:
        """A DeepWalk holding the file's vectors, on ``device`` (None
        means the card)."""
        idxs, vecs = [], []
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2:
                    continue
                idxs.append(parts[0])
                vecs.append([float(x) for x in parts[1:]])
        syn0 = np.array(vecs, np.float32)
        dw = DeepWalk(vector_size=syn0.shape[1], device=device)
        sv = SequenceVectors(layer_size=syn0.shape[1], device=dw.device)
        cache = AbstractCache()
        for k, lab in enumerate(idxs):
            cache.add_token(VocabWord(lab, float(len(idxs) - k)))
        cache.update_words_occurrences()
        sv.vocab = cache
        sv.lookup_table = InMemoryLookupTable(
            len(idxs), syn0.shape[1], use_hs=False, negative=0,
            device=dw.device)
        pos = {lab: i for i, lab in enumerate(idxs)}
        order = [pos[cache.word_at_index(k)]
                 for k in range(cache.num_words())]
        sv.lookup_table.syn0 = torch.from_numpy(syn0[order]).to(dw.device)
        dw._sv = sv
        return dw
