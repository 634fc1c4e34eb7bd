"""The port's k-means, spatial trees and t-SNE (``clustering/``,
``plot/tsne.py``) against the JAX package's, on the committed digits
fixture (``tests/fixtures/real_digits``, 8x8 images).

- k-means (the Lloyd steps as torch on the CPU here): the same k-means++
  seeds (numpy, one RandomState), then the same assignments and centres
  within 1e-5 of their scale, and one Lloyd step's cost within 1e-5;
- the trees are host numpy in both: the same neighbours, distances and
  Barnes-Hut forces, bitwise;
- exact t-SNE: 20 steps each from the reference's state within 1e-5,
  and a 20-iteration fit's embedding and KL within 1e-4 of their scale
  (f32 on both sides, summation order only; see the test for the
  learning rate);
- Barnes-Hut t-SNE: its gradient equals the reference's numpy gradient.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import trees as jtrees
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.clustering import kmeans as pkm
from deeplearning4j_tpu_torch.clustering import trees as ptrees
from deeplearning4j_tpu_torch.plot import tsne as ptsne

DIGITS = Path(__file__).resolve().parent / "fixtures" / "real_digits"


def _digits(n):
    from deeplearning4j_tpu_torch.datasets.fetchers import read_idx
    x = read_idx(str(DIGITS / "train-images-idx3-ubyte"))
    return x.reshape(len(x), -1)[:n].astype(np.float32) / 16.0


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_matches_the_reference(distance, init):
    x = _digits(200)
    kw = dict(max_iterations=30, distance=distance, seed=7, init=init)
    jset = jkm.KMeansClustering.setup(6, **kw).apply_to(x)
    pk = pkm.KMeansClustering.setup(6, device="cpu", **kw)
    pset = pk.apply_to(x)
    jc, pc = jset.get_centers(), pset.get_centers()
    assert np.abs(pc - jc).max() <= 1e-5 * np.abs(jc).max()
    for jcl, pcl in zip(jset.clusters, pset.clusters):
        assert [p.id for p in pcl.points] == [p.id for p in jcl.points]
    # one Lloyd step from the same centres: assignments, centres, cost
    import jax.numpy as jnp
    ja, jn, jcost = jkm._assign_and_update(jnp.asarray(x), jnp.asarray(jc),
                                           distance == "cosine")
    pa, pn, pcost = pkm._assign_and_update(torch.tensor(x), torch.tensor(jc),
                                           distance == "cosine")
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert np.abs(pn.numpy() - np.asarray(jn)).max() <= \
        1e-5 * np.abs(np.asarray(jn)).max()
    assert abs(float(pcost) - float(jcost)) <= 1e-5 * abs(float(jcost))
    p = pkm.Point(x[3], pid="3")
    assert pset.classify_point(p).idx == jset.classify_point(
        jkm.Point(x[3], pid="3")).idx


def test_kmeans_refuses_more_clusters_than_points():
    with pytest.raises(ValueError, match="number of points"):
        pkm.KMeansClustering(5, device="cpu").apply_to(_digits(3))


def test_tree_queries_equal_the_references():
    x = _digits(120)
    jkd, pkd = jtrees.KDTree(64), ptrees.KDTree(64)
    for row in x[:80]:
        jkd.insert(row)
        pkd.insert(row)
    for q in x[80:90]:
        for (jp, jd), (pp, pd) in zip(jkd.knn(q, 5), pkd.knn(q, 5)):
            np.testing.assert_array_equal(pp, jp)
            assert pd == jd
    jvp, pvp = jtrees.VPTree(x, seed=3), ptrees.VPTree(x, seed=3)
    for i in range(0, 120, 17):
        assert pvp.knn(x[i], 7, exclude=i) == jvp.knn(x[i], 7, exclude=i)
    y = np.random.RandomState(0).randn(60, 2)
    jsp, psp = jtrees.QuadTree(y), ptrees.QuadTree(y)
    for i in range(0, 60, 7):
        jf, pf = np.zeros(2), np.zeros(2)
        jz = jsp.compute_non_edge_forces(y[i], 0.5, jf)
        pz = psp.compute_non_edge_forces(y[i], 0.5, pf)
        assert pz == jz
        np.testing.assert_array_equal(pf, jf)
    y3 = np.random.RandomState(1).randn(40, 3)
    assert ptrees.SpTree(y3).cum_size == jtrees.SpTree(y3).cum_size == 40


def test_exact_tsne_steps_match_the_reference():
    """At the reference's defaults (learning rate 200, perplexity 30),
    each of 20 steps taken from the reference's own state lands within
    1e-5 of its next state, and the input P is the reference's."""
    import jax.numpy as jnp
    x = _digits(200)
    jt, pt = jtsne.Tsne(seed=5), ptsne.Tsne(seed=5, device="cpu")
    P = jt._input_probabilities(x).astype(np.float32)
    np.testing.assert_array_equal(pt._input_probabilities(x), P)
    y = np.random.RandomState(5).randn(200, 2).astype(np.float32) * 1e-2
    dy, gains, pj = np.zeros_like(y), np.ones_like(y), P * 4.0
    for it in range(20):
        mom = jt.momentum
        # the reference's loop body (Tsne.fit)
        grad, _ = jtsne._exact_grad(jnp.asarray(y), jnp.asarray(pj))
        grad = np.asarray(grad)
        jg = np.maximum(np.where(np.sign(grad) != np.sign(dy), gains + 0.2,
                                 gains * 0.8), 0.01).astype(np.float32)
        jdy = (mom * dy - jt.learning_rate * jg * grad).astype(np.float32)
        jy = y + jdy
        jy = jy - jy.mean(0)
        py, pdy, pg, _ = pt._step(torch.tensor(y), torch.tensor(dy),
                                  torch.tensor(gains), torch.tensor(pj), mom)
        for got, want in ((py, jy), (pdy, jdy), (pg, jg)):
            assert np.abs(got.numpy() - want).max() <= \
                1e-5 * np.abs(want).max(), it
        y, dy, gains = jy, jdy, jg


def test_exact_tsne_matches_the_reference_after_20_iterations():
    """The whole fit, 20 iterations. Early exaggeration expands the
    embedding and a rounding difference with it (at the defaults: 4e-7
    of the scale after one iteration, 2e-5 after five, 0.7 after twenty,
    measured on this data), so this end-to-end comparison runs at a
    learning rate of 20 and perplexity 10, where the expansion is mild;
    the defaults are held step by step above."""
    x = _digits(150)
    kw = dict(max_iter=20, perplexity=10.0, learning_rate=20.0, seed=5)
    jt = jtsne.Tsne(**kw)
    jy = jt.fit(x)
    pt = ptsne.Tsne(device="cpu", **kw)
    py = pt.fit(x)
    assert py.shape == (150, 2) and py.dtype == np.float32
    assert np.abs(py - jy).max() <= 1e-4 * np.abs(jy).max()
    assert abs(pt.kl_ - jt.kl_) <= 1e-4 * abs(jt.kl_)


def test_exact_tsne_refuses_a_perplexity_too_large():
    with pytest.raises(ValueError, match="too large"):
        ptsne.Tsne(perplexity=30.0, device="cpu").fit(_digits(50))


def test_barnes_hut_gradient_and_fit_equal_the_references():
    x = _digits(80)
    kw = dict(theta=0.5, max_iter=12, perplexity=8.0, seed=2,
              stop_lying_iteration=6)
    jb, pb = jtsne.BarnesHutTsne(**kw), ptsne.BarnesHutTsne(**kw)
    np.testing.assert_array_equal(pb.fit(x), jb.fit(x))
    assert pb.kl_ == jb.kl_
    r = np.random.RandomState(4)
    y = r.randn(80, 2)
    keys = np.stack([r.randint(0, 80, 300), r.randint(0, 80, 300)], 1)
    vals = r.rand(300) / 300
    np.testing.assert_array_equal(pb._bh_grad(y, keys, vals),
                                  jb._bh_grad(y, keys, vals))
