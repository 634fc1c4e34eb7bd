"""Random-walk iterators over graphs: the port of
``deeplearning4j_tpu/graph/walkers.py``, which uses no JAX and is carried
over as it is.

``deeplearning4j-graph``'s ``iterator/RandomWalkIterator.java`` (uniform
next vertex, fixed walk length, ``NoEdgeHandling``
SELF_LOOP_ON_DISCONNECTED or EXCEPTION_ON_DISCONNECTED) and
``iterator/WeightedRandomWalkIterator.java`` (edge-weight-proportional
steps). Each walk set draws from ``np.random.RandomState(seed)`` in the
reference's order, so the walks are the reference's.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph

__all__ = ["EXCEPTION_ON_DISCONNECTED", "RandomWalkIterator",
           "SELF_LOOP_ON_DISCONNECTED", "WeightedRandomWalkIterator"]

SELF_LOOP_ON_DISCONNECTED = "self_loop"
EXCEPTION_ON_DISCONNECTED = "exception"


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex
    (``RandomWalkIterator.java``)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 no_edge_handling: str = SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling

    def _next_vertex(self, cur: int, rng) -> int:
        if self.graph.get_degree(cur) == 0:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise ValueError(
                    f"vertex {cur} has no edges "
                    "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)")
            return cur  # self loop
        return self.graph.get_random_connected_vertex(cur, rng)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(self.graph.num_vertices())
        for start in order:
            walk = [int(start)]
            cur = int(start)
            for _ in range(self.walk_length):
                cur = self._next_vertex(cur, rng)
                walk.append(cur)
            yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (``WeightedRandomWalkIterator.java``)."""

    def _next_vertex(self, cur: int, rng) -> int:
        edges = self.graph.get_edges_out(cur)
        if not edges:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise ValueError(
                    f"vertex {cur} has no edges "
                    "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)")
            return cur
        w = np.array([float(e.value) if e.value is not None else 1.0
                      for e in edges])
        p = w / w.sum()
        return edges[rng.choice(len(edges), p=p)].to
