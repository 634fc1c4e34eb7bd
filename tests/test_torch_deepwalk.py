"""The graph package of the port (graphs, loaders, random walks, DeepWalk
and GraphVectorSerializer) against the JAX package's, on the CPU.

- A graph built by each package's loaders from the same files has the
  same adjacency, edge values and degrees.
- Random walks (uniform and weighted, self-loop and exception handling)
  draw from the same numpy seeds, so they equal the reference's walk for
  walk.
- DeepWalk fits on the same walks through hierarchical softmax: the same
  vertex vocabulary, and syn0 and syn1 within 1e-5 of their max abs of
  the reference's (Word2Vec's fit bar, ``tests/test_torch_word2vec.py``).
- GraphVectorSerializer files read across the packages to the same
  vertices and vectors, within the ``%.8f`` of the format plus one f32
  rounding.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import graph as jgraph
from deeplearning4j_tpu_torch import graph as pgraph

PACKAGES = {"jax": jgraph, "port": pgraph}
FIT_RTOL = 1e-5


def _two_cluster_graph(g):
    """Two 5-cliques joined by one bridge edge."""
    gr = g.Graph(10)
    for base in (0, 5):
        for i in range(base, base + 5):
            for j in range(i + 1, base + 5):
                gr.add_edge(i, j)
    gr.add_edge(4, 5)
    return gr


def _edges(gr):
    return [[(e.frm, e.to, e.value, e.directed) for e in gr.get_edges_out(v)]
            for v in range(gr.num_vertices())]


def _random_edge_file(path, n=60, m=200, seed=0, weighted=False):
    r = np.random.RandomState(seed)
    lines = ["# a comment"]
    for _ in range(m):
        a, b = r.randint(0, n, 2)
        lines.append(f"{a},{b}" + (f",{r.rand() * 5:.3f}" if weighted
                                   else ""))
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


def test_graph_surface():
    for g in PACKAGES.values():
        gr = g.Graph(4)
        gr.add_edge(0, 1)
        gr.add_edge(1, 2, directed=True)
        assert gr.get_degree(0) == 1 and gr.get_degree(1) == 2
        assert gr.get_connected_vertex_indices(1) == [0, 2]
        assert gr.get_degree(2) == 0
        gr.add_edge(0, 1)
        assert gr.get_degree(0) == 1
        gr.add_edge(3, 3)
        assert gr.get_degree(3) == 1
        with pytest.raises(ValueError):
            gr.add_edge(0, 99)


@pytest.mark.parametrize("weighted", [False, True])
def test_loaders_build_the_reference_s_graph(tmp_path, weighted):
    path = _random_edge_file(tmp_path / "edges.txt", weighted=weighted)
    load = ("load_weighted_edge_list_file" if weighted
            else "load_undirected_graph_edge_list_file")
    got, want = (_edges(getattr(g.GraphLoader, load)(path, 60))
                 for g in (pgraph, jgraph))
    assert got == want and sum(map(len, got)) > 200


@pytest.mark.parametrize("kind", ["uniform", "weighted"])
def test_walks_equal_the_reference_s(tmp_path, kind):
    path = _random_edge_file(tmp_path / "edges.txt", weighted=True, seed=1)
    walks = {}
    for name, g in PACKAGES.items():
        gr = g.GraphLoader.load_weighted_edge_list_file(path, 60)
        it = (g.RandomWalkIterator if kind == "uniform"
              else g.WeightedRandomWalkIterator)
        walks[name] = [list(w) for seed in (1, 2)
                       for w in it(gr, walk_length=12, seed=seed)]
    assert walks["port"] == walks["jax"] and len(walks["port"]) == 120


def test_disconnected_vertex_handling():
    for g in PACKAGES.values():
        gr = g.Graph(3)
        gr.add_edge(0, 1)
        iso = [w for w in g.RandomWalkIterator(gr, 3, seed=2) if w[0] == 2]
        assert iso == [[2, 2, 2, 2]]
        with pytest.raises(ValueError):
            list(g.RandomWalkIterator(
                gr, 3, seed=2, no_edge_handling=g.EXCEPTION_ON_DISCONNECTED))


def _fit(g, source, **kw):
    kw = dict(dict(vector_size=12, window_size=3, walk_length=10,
                   walks_per_vertex=3, batch_size=128, seed=9), **kw)
    if g is pgraph:
        kw["device"] = "cpu"
    return g.DeepWalk(**kw).fit(source)


@pytest.mark.parametrize("source", ["graph", "walks"])
def test_deepwalk_matches_the_reference(source):
    if source == "graph":
        src = {n: _two_cluster_graph(g) for n, g in PACKAGES.items()}
    else:
        walks = [[0, 1, 2, 1, 0, 3], [2, 1, 0, 1, 2], [3, 0, 1]] * 15
        src = {n: walks for n in PACKAGES}
    want, got = _fit(jgraph, src["jax"]), _fit(pgraph, src["port"])
    assert got._sv.vocab.words() == want._sv.vocab.words()
    for name in ("syn0", "syn1"):
        a = np.asarray(getattr(want._sv.lookup_table, name), np.float64)
        b = getattr(got._sv.lookup_table, name).numpy().astype(np.float64)
        assert np.abs(b - a).max() <= FIT_RTOL * np.abs(a).max(), name
    assert got.num_vertices() == want.num_vertices()
    if source == "walks":
        with pytest.raises(ValueError):
            got.get_vertex_vector(99)


def test_deepwalk_learns_community_structure():
    dw = _fit(pgraph, _two_cluster_graph(pgraph), vector_size=24,
              window_size=4, walk_length=20, walks_per_vertex=8,
              batch_size=256, seed=7)
    intra = np.mean([dw.similarity(0, j) for j in (1, 2, 3)])
    inter = np.mean([dw.similarity(0, j) for j in (6, 7, 8)])
    assert intra > inter
    assert len(set(dw.vertices_nearest(0, 4)) & {1, 2, 3, 4}) >= 2


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_graph_vector_files_read_across(tmp_path, direction):
    src_pkg, dst_pkg = ((pgraph, jgraph) if direction == "port_to_jax"
                        else (jgraph, pgraph))
    dw = _fit(src_pkg, _two_cluster_graph(src_pkg))
    path = str(tmp_path / "gv.txt")
    src_pkg.GraphVectorSerializer.write_graph_vectors(dw, path)
    kw = {"device": "cpu"} if dst_pkg is pgraph else {}
    back = dst_pkg.GraphVectorSerializer.read_graph_vectors(path, **kw)
    assert back._sv.vocab.words() == dw._sv.vocab.words()
    for v in range(10):
        want = np.asarray(dw.get_vertex_vector(v), np.float64)
        got = np.asarray(back.get_vertex_vector(v), np.float64)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-9 + 1e-7 * np.abs(want).max())
