"""K-means clustering and the cluster-set framework: the port of
``deeplearning4j_tpu/clustering/kmeans.py`` (``clustering/kmeans/
KMeansClustering.java``: ``setup(k, maxIter, distanceFn)``, ``applyTo``;
the cluster framework of ``clustering/cluster/``: ``Point``, ``Cluster``,
``ClusterSet``; ``clustering/algorithm/BaseClusteringAlgorithm.java``'s
loop: seed the centres, assign, recompute, until ``max_iterations`` or
the cost stops moving).

The assignment and the centre update run as torch on the caller's
device (the card unless ``device="cpu"``): the pairwise distances as one
matrix product, the new centres as a one-hot product. The k-means++
seeding stays in numpy, drawn from ``RandomState(seed)`` as the
reference's. The loop reads the cost on the host once an iteration, for
its convergence test.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["Cluster", "ClusterSet", "KMeansClustering", "Point"]


class Point:
    """``clustering/cluster/Point.java`` — (id, label, array)."""

    def __init__(self, array, pid: Optional[str] = None,
                 label: Optional[str] = None):
        self.array = np.asarray(array, np.float32)
        self.id = pid
        self.label = label

    @staticmethod
    def to_points(matrix) -> List["Point"]:
        return [Point(row, pid=str(i)) for i, row in enumerate(np.asarray(matrix))]


class Cluster:
    """``clustering/cluster/Cluster.java`` — center + member points."""

    def __init__(self, center: np.ndarray, idx: int):
        self.center = np.asarray(center)
        self.idx = idx
        self.points: List[Point] = []

    def distance_to_center(self, point: Point, distance: str = "euclidean") -> float:
        if distance == "cosine":
            a, b = point.array, self.center
            return 1.0 - float(a @ b / ((np.linalg.norm(a) + 1e-12)
                                        * (np.linalg.norm(b) + 1e-12)))
        return float(np.linalg.norm(point.array - self.center))


class ClusterSet:
    """``clustering/cluster/ClusterSet.java``."""

    def __init__(self, clusters: List[Cluster], distance: str = "euclidean"):
        self.clusters = clusters
        self.distance = distance

    def classify_point(self, point: Point) -> Cluster:
        ds = [c.distance_to_center(point, self.distance) for c in self.clusters]
        return self.clusters[int(np.argmin(ds))]

    def get_centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])


def _assign_and_update(points, centers, use_cosine):
    """One Lloyd iteration: (N, D) and (K, D) -> assignments (N,), new
    centres (K, D), total distance to the assigned centres."""
    if use_cosine:
        pn = points / (torch.linalg.norm(points, dim=1, keepdim=True) + 1e-12)
        cn = centers / (torch.linalg.norm(centers, dim=1, keepdim=True)
                        + 1e-12)
        dist = 1.0 - pn @ cn.T
    else:
        # |p - c|^2 = |p|^2 + |c|^2 - 2 p.c, one matrix product
        d2 = ((points * points).sum(1)[:, None]
              + (centers * centers).sum(1)[None, :]
              - 2.0 * points @ centers.T)
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
    assign = torch.argmin(dist, dim=1)
    one_hot = torch.nn.functional.one_hot(
        assign, centers.shape[0]).to(points.dtype)
    counts = one_hot.sum(0)
    sums = one_hot.T @ points
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    return assign, new_centers, dist.min(dim=1).values.sum()


class KMeansClustering:
    """``KMeansClustering.setup(k, maxIter, distanceFn)`` -> ``applyTo``;
    ``device``: where the Lloyd iterations run."""

    def __init__(self, k: int, max_iterations: int = 100,
                 distance: str = "euclidean", seed: int = 123,
                 tolerance: float = 1e-4, init: str = "kmeans++",
                 device=None):
        self.k = k
        self.device = device
        self.max_iterations = max_iterations
        self.distance = distance
        self.seed = seed
        self.tolerance = tolerance
        self.init = init
        self.iterations_done = 0

    def _init_centers(self, X: np.ndarray, rng) -> np.ndarray:
        n = X.shape[0]
        if self.init != "kmeans++":
            return X[rng.choice(n, self.k, replace=False)]
        # k-means++ (Arthur & Vassilvitskii): D²-weighted seeding avoids the
        # multiple-centers-in-one-blob local optima of plain random init
        centers = [X[rng.randint(n)]]
        d2 = ((X - centers[0]) ** 2).sum(1)
        for _ in range(1, self.k):
            s = d2.sum()
            if s <= 0:  # all remaining points coincide with chosen centers
                centers.append(X[rng.randint(n)])
                continue
            centers.append(X[rng.choice(n, p=d2 / s)])
            d2 = np.minimum(d2, ((X - centers[-1]) ** 2).sum(1))
        return np.stack(centers)

    @classmethod
    def setup(cls, k: int, max_iterations: int = 100,
              distance: str = "euclidean", **kw) -> "KMeansClustering":
        return cls(k, max_iterations, distance, **kw)

    def apply_to(self, points: "Sequence[Point] | np.ndarray") -> ClusterSet:
        if not isinstance(points, (list, tuple)):
            pts = Point.to_points(points)
        else:
            pts = list(points)
        X = np.stack([p.array for p in pts]).astype(np.float32)
        n = X.shape[0]
        if self.k > n:
            raise ValueError(f"k={self.k} > number of points {n}")
        rng = np.random.RandomState(self.seed)
        dev = resolve_device(self.device)
        centers = torch.from_numpy(self._init_centers(X, rng)).to(dev)
        Xd = torch.from_numpy(X).to(dev)
        use_cosine = self.distance == "cosine"
        prev_cost = np.inf
        assign = None
        for it in range(self.max_iterations):
            assign, centers, cost = _assign_and_update(Xd, centers, use_cosine)
            self.iterations_done = it + 1
            cost = float(cost)
            if abs(prev_cost - cost) < self.tolerance * max(abs(prev_cost), 1.0):
                break
            prev_cost = cost
        centers = centers.cpu().numpy()
        clusters = [Cluster(centers[i], i) for i in range(self.k)]
        a = assign.cpu().numpy()
        for p, ci in zip(pts, a):
            clusters[int(ci)].points.append(p)
        return ClusterSet(clusters, self.distance)
