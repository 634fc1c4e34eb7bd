"""Spatial partition trees: the port's own copy of
``deeplearning4j_tpu/clustering/trees.py`` (``clustering/kdtree/
KDTree.java``: insert, nearest neighbour, knn; ``clustering/vptree/
VPTree.java``: the vantage-point tree, t-SNE's neighbour search;
``clustering/quadtree/QuadTree.java`` and ``clustering/sptree/
SpTree.java``: the centre-of-mass tree behind Barnes-Hut t-SNE's
``computeNonEdgeForces``).

Host code in numpy, as in the reference: pointer-chasing trees do not map
onto a device, so the same trees answer the same queries.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["KDTree", "QuadTree", "SpTree", "VPTree"]


# ---------------------------------------------------------------------------
# KD-tree
# ---------------------------------------------------------------------------

class _KDNode:
    __slots__ = ("point", "left", "right")

    def __init__(self, point):
        self.point = point
        self.left: Optional[_KDNode] = None
        self.right: Optional[_KDNode] = None


class KDTree:
    """``KDTree.java`` — axis-cycled binary partition tree."""

    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_KDNode] = None
        self.size = 0

    def insert(self, point) -> None:
        point = np.asarray(point, np.float32)
        assert point.shape == (self.dims,)
        self.size += 1
        if self.root is None:
            self.root = _KDNode(point)
            return
        node, depth = self.root, 0
        while True:
            axis = depth % self.dims
            if point[axis] < node.point[axis]:
                if node.left is None:
                    node.left = _KDNode(point)
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = _KDNode(point)
                    return
                node = node.right
            depth += 1

    def nn(self, point) -> Tuple[np.ndarray, float]:
        """Nearest neighbor (point, distance)."""
        res = self.knn(point, 1)
        return res[0]

    def knn(self, point, k: int) -> List[Tuple[np.ndarray, float]]:
        point = np.asarray(point, np.float32)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap via -dist
        counter = [0]

        def visit(node, depth):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, counter[0], node.point))
                counter[0] += 1
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, counter[0], node.point))
                counter[0] += 1
            axis = depth % self.dims
            diff = point[axis] - node.point[axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far, depth + 1)

        visit(self.root, 0)
        out = sorted(((-negd, pt) for negd, _, pt in heap), key=lambda t: t[0])
        return [(pt, d) for d, pt in out]


# ---------------------------------------------------------------------------
# VP-tree
# ---------------------------------------------------------------------------

class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    """``VPTree.java`` — metric tree over a fixed item set; knn by index."""

    def __init__(self, items: np.ndarray, distance: str = "euclidean",
                 seed: int = 123):
        self.items = np.asarray(items, np.float32)
        self.distance = distance
        self._rng = np.random.RandomState(seed)
        self.root = self._build(list(range(len(self.items))))

    def _dist(self, i: int, q: np.ndarray) -> float:
        a = self.items[i]
        if self.distance == "cosine":
            return 1.0 - float(a @ q / ((np.linalg.norm(a) + 1e-12)
                                        * (np.linalg.norm(q) + 1e-12)))
        return float(np.linalg.norm(a - q))

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[self._rng.randint(len(idxs))]
        rest = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        ds = [self._dist(i, self.items[vp]) for i in rest]
        node.threshold = float(np.median(ds))
        inside = [i for i, d in zip(rest, ds) if d <= node.threshold]
        outside = [i for i, d in zip(rest, ds) if d > node.threshold]
        if not outside and len(inside) > 1:
            # all remaining items equidistant from the vantage point (e.g.
            # duplicate rows): median split degenerates, so split arbitrarily
            # to keep the tree depth O(log n) instead of O(n)
            half = len(inside) // 2
            inside, outside = inside[:half], inside[half:]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query, k: int, exclude: Optional[int] = None
            ) -> List[Tuple[int, float]]:
        query = np.asarray(query, np.float32)
        heap: List[Tuple[float, int]] = []  # (-dist, idx)
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = self._dist(node.index, query)
            if node.index != exclude:
                if len(heap) < k:
                    heapq.heappush(heap, (-d, node.index))
                elif d < -heap[0][0]:
                    heapq.heapreplace(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if d <= node.threshold:
                visit(node.inside)
                if d + tau[0] > node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        out = sorted((-negd, i) for negd, i in heap)
        return [(i, d) for d, i in out]


# ---------------------------------------------------------------------------
# Quad/Sp-tree (Barnes-Hut)
# ---------------------------------------------------------------------------

class SpTree:
    """``SpTree.java`` — generalized octree with center-of-mass per cell and
    Barnes-Hut ``computeNonEdgeForces`` (t-SNE repulsive term). The 2D case is
    the reference's ``QuadTree.java``."""

    MAX_DEPTH = 32

    def __init__(self, data: np.ndarray, center=None, width=None, depth=0):
        data = np.asarray(data, np.float64)
        self.dim = data.shape[1]
        self.depth = depth
        if center is None:
            mins, maxs = data.min(0), data.max(0)
            center = (mins + maxs) / 2
            width = (maxs - mins) / 2 + 1e-5
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.cum_com = np.zeros(self.dim)
        self.cum_size = 0
        self.point: Optional[np.ndarray] = None
        self.children: Optional[List[Optional[SpTree]]] = None
        for row in data:
            self.insert(row)

    def insert(self, point: np.ndarray) -> None:
        point = np.asarray(point, np.float64)
        self.cum_com = (self.cum_com * self.cum_size + point) / (self.cum_size + 1)
        self.cum_size += 1
        if self.point is None and self.children is None:
            self.point = point
            return
        if self.children is None:
            if self.depth >= self.MAX_DEPTH or np.allclose(self.point, point):
                # duplicate / depth cap: aggregate only
                return
            self._subdivide()
        self._child_for(point).insert(point)

    def _subdivide(self) -> None:
        self.children = [None] * (2 ** self.dim)
        old = self.point
        self.point = None
        self._child_for(old)._insert_leaf(old)

    def _insert_leaf(self, point):
        self.cum_com = (self.cum_com * self.cum_size + point) / (self.cum_size + 1)
        self.cum_size += 1
        self.point = point

    def _child_for(self, point: np.ndarray) -> "SpTree":
        idx = 0
        for d in range(self.dim):
            if point[d] > self.center[d]:
                idx |= (1 << d)
        if self.children[idx] is None:
            offset = np.where(
                [(idx >> d) & 1 for d in range(self.dim)],
                self.width / 2, -self.width / 2)
            self.children[idx] = SpTree.__new__(SpTree)
            c = self.children[idx]
            c.dim = self.dim
            c.depth = self.depth + 1
            c.center = self.center + offset
            c.width = self.width / 2
            c.cum_com = np.zeros(self.dim)
            c.cum_size = 0
            c.point = None
            c.children = None
        return self.children[idx]

    def compute_non_edge_forces(self, point: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Barnes-Hut accumulation of repulsive forces; returns sum_Z
        contribution (``SpTree.computeNonEdgeForces``)."""
        if self.cum_size == 0:
            return 0.0
        diff = point - self.cum_com
        d2 = float(diff @ diff)
        max_width = float(np.max(self.width) * 2)
        is_self = self.cum_size == 1 and d2 < 1e-12
        if is_self:
            return 0.0
        if self.children is None or max_width / (np.sqrt(d2) + 1e-12) < theta:
            q = 1.0 / (1.0 + d2)
            mult = self.cum_size * q
            neg_f += mult * q * diff
            return mult
        z = 0.0
        for c in self.children:
            if c is not None:
                z += c.compute_non_edge_forces(point, theta, neg_f)
        return z


class QuadTree(SpTree):
    """2D specialization (``QuadTree.java``)."""

    def __init__(self, data: np.ndarray, **kw):
        data = np.asarray(data)
        assert data.shape[1] == 2, "QuadTree is 2D (use SpTree otherwise)"
        super().__init__(data, **kw)
