"""In-memory graph and its loaders: the port of
``deeplearning4j_tpu/graph/graph.py``, which uses no JAX and is carried
over as it is.

``deeplearning4j-graph``'s ``graph/Graph.java`` (the adjacency-list
``api/IGraph.java``: addEdge, getEdgesOut, getDegree,
getRandomConnectedVertex), ``api/{Vertex,Edge}.java`` and the edge-list
file loaders (``data/GraphLoader.java``). A graph lives on the host;
random walks draw from numpy seeds, so they equal the reference's.
"""

from __future__ import annotations

from typing import Generic, List, Optional, Sequence, TypeVar

import numpy as np

__all__ = ["Edge", "Graph", "GraphLoader", "Vertex"]

T = TypeVar("T")


class Vertex(Generic[T]):
    """``api/Vertex.java`` — (index, value)."""

    def __init__(self, idx: int, value: T = None):
        self.idx = idx
        self.value = value

    def __repr__(self):
        return f"Vertex({self.idx}, {self.value!r})"


class Edge(Generic[T]):
    """``api/Edge.java`` — (from, to, value, directed)."""

    def __init__(self, frm: int, to: int, value: T = None,
                 directed: bool = False):
        self.frm = frm
        self.to = to
        self.value = value
        self.directed = directed

    def __repr__(self):
        arrow = "->" if self.directed else "--"
        return f"Edge({self.frm}{arrow}{self.to}, {self.value!r})"


class Graph(Generic[T]):
    """Adjacency-list graph (``graph/Graph.java``)."""

    def __init__(self, vertices: "int | Sequence[Vertex]",
                 allow_multiple_edges: bool = False):
        if isinstance(vertices, int):
            self.vertices = [Vertex(i) for i in range(vertices)]
        else:
            self.vertices = list(vertices)
            for i, v in enumerate(self.vertices):
                assert v.idx == i, "vertex indices must be 0..n-1 in order"
        self.allow_multiple_edges = allow_multiple_edges
        self._edges_out: List[List[Edge]] = [[] for _ in self.vertices]

    # --- IGraph surface ---
    def num_vertices(self) -> int:
        return len(self.vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    def add_edge(self, frm_or_edge, to: Optional[int] = None, value=None,
                 directed: bool = False) -> None:
        if isinstance(frm_or_edge, Edge):
            e = frm_or_edge
        else:
            e = Edge(frm_or_edge, to, value, directed)
        if not (0 <= e.frm < len(self.vertices)
                and 0 <= e.to < len(self.vertices)):
            raise ValueError(f"edge {e} out of vertex range "
                             f"[0, {len(self.vertices)})")
        if not self.allow_multiple_edges and any(
                x.to == e.to for x in self._edges_out[e.frm]):
            return
        self._edges_out[e.frm].append(e)
        if not e.directed and e.frm != e.to:
            self._edges_out[e.to].append(Edge(e.to, e.frm, e.value, False))

    def get_edges_out(self, idx: int) -> List[Edge]:
        return list(self._edges_out[idx])

    def get_degree(self, idx: int) -> int:
        return len(self._edges_out[idx])

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return [e.to for e in self._edges_out[idx]]

    def get_random_connected_vertex(self, idx: int,
                                    rng: np.random.RandomState) -> int:
        out = self._edges_out[idx]
        if not out:
            raise ValueError(f"vertex {idx} has no outgoing edges")
        return out[rng.randint(0, len(out))].to


class GraphLoader:
    """``data/GraphLoader.java`` — edge-list / weighted edge-list files."""

    @staticmethod
    def load_undirected_graph_edge_list_file(path: str, num_vertices: int,
                                             delim: str = ",") -> Graph:
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim)
                g.add_edge(int(parts[0]), int(parts[1]))
        return g

    @staticmethod
    def load_weighted_edge_list_file(path: str, num_vertices: int,
                                     delim: str = ",",
                                     directed: bool = False) -> Graph:
        g = Graph(num_vertices, allow_multiple_edges=True)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim)
                g.add_edge(int(parts[0]), int(parts[1]),
                           value=float(parts[2]) if len(parts) > 2 else 1.0,
                           directed=directed)
        return g
