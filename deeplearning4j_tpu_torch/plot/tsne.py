"""t-SNE, exact and Barnes-Hut: the port of ``deeplearning4j_tpu/plot/tsne.py``
(``plot/Tsne.java``: exact O(N^2) t-SNE, the perplexity binary search,
early exaggeration, momentum and adaptive gains;
``plot/BarnesHutTsne.java:64``: VP-tree kNN input similarities, SpTree
repulsion at ``theta``).

The split is the reference's. The input similarities P are host numpy
(the per-row binary search); exact t-SNE's gradient loop runs as torch
on the caller's device (the card unless ``device="cpu"``): pairwise
distances as one matrix product, the whole update on the device, with
no host read until the end. Barnes-Hut is host numpy throughout, over
the trees of ``clustering/trees.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.trees import SpTree, VPTree
from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["BarnesHutTsne", "Tsne"]


# ---------------------------------------------------------------------------
# shared: input similarities with perplexity calibration
# ---------------------------------------------------------------------------

def _binary_search_sigmas(d2: np.ndarray, perplexity: float, tol: float = 1e-5,
                          max_iter: int = 50) -> np.ndarray:
    """Per-row beta=1/(2σ²) search so that H(P_i) = log(perplexity).
    d2: (N, K) squared distances to candidate neighbors (self excluded).
    Returns row-conditional probabilities P (N, K). (Tsne.java hBeta loop.)"""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros_like(d2)
    for i in range(n):
        beta, lo, hi = 1.0, -np.inf, np.inf
        for _ in range(max_iter):
            p = np.exp(-d2[i] * beta)
            s = p.sum()
            if s <= 0:
                h = 0.0
                p = np.full_like(p, 1.0 / len(p))
            else:
                h = np.log(s) + beta * (d2[i] * p).sum() / s
                p = p / s
            diff = h - target
            if abs(diff) < tol:
                break
            if diff > 0:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        P[i] = p
    return P


# ---------------------------------------------------------------------------
# exact t-SNE — jitted gradient
# ---------------------------------------------------------------------------

def _exact_grad(Y, P):
    """dC/dY of exact t-SNE and the unnormalised kernel ``num`` and
    ``Q`` it was taken from."""
    n = Y.shape[0]
    sum_y = (Y * Y).sum(1)
    d2 = sum_y[:, None] + sum_y[None, :] - 2.0 * Y @ Y.T
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(n, dtype=Y.dtype, device=Y.device))
    Q = torch.clamp(num / num.sum(), min=1e-12)
    PQ = (P - Q) * num
    grad = 4.0 * (torch.diag(PQ.sum(1)) - PQ) @ Y
    return grad, Q


def _kl(P, Q):
    return torch.where(P > 0, P * torch.log(torch.clamp(P, min=1e-12) / Q),
                       torch.zeros((), dtype=P.dtype, device=P.device)).sum()


class Tsne:
    """Exact t-SNE (``plot/Tsne.java``'s Builder: maxIter, perplexity,
    learningRate, momentum and finalMomentum, switchMomentumIteration,
    stopLyingIteration); ``device``: where the gradient loop runs."""

    def __init__(self, n_components: int = 2, max_iter: int = 500,
                 perplexity: float = 30.0, learning_rate: float = 200.0,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100, seed: int = 123,
                 device=None):
        self.n_components = n_components
        self.device = device
        self.max_iter = max_iter
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.seed = seed
        self.Y_: Optional[np.ndarray] = None
        self.kl_: Optional[float] = None

    def _input_probabilities(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        sum_x = (X * X).sum(1)
        d2 = sum_x[:, None] + sum_x[None, :] - 2.0 * X @ X.T
        np.fill_diagonal(d2, np.inf)  # exclude self
        cond = _binary_search_sigmas(
            np.where(np.isinf(d2), 1e12, d2), self.perplexity)
        cond[np.arange(n), :] *= (~np.isinf(d2)).astype(cond.dtype)
        P = cond
        P = (P + P.T) / (2.0 * n)
        return np.maximum(P, 1e-12)

    def _step(self, Y, dY, gains, Pj, mom):
        """One gradient step with momentum and adaptive gains; returns
        (Y, dY, gains, the step's Q)."""
        grad, Q = _exact_grad(Y, Pj)
        gains = torch.where(torch.sign(grad) != torch.sign(dY),
                            gains + 0.2, gains * 0.8)
        gains = torch.clamp(gains, min=0.01)
        dY = mom * dY - self.learning_rate * gains * grad
        Y = Y + dY
        return Y - Y.mean(0), dY, gains, Q

    def fit(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        if n - 1 < 3 * self.perplexity:
            raise ValueError(
                f"perplexity {self.perplexity} too large for {n} points "
                "(need n-1 >= 3*perplexity)")
        P = self._input_probabilities(X).astype(np.float32)
        rng = np.random.RandomState(self.seed)
        dev = resolve_device(self.device)
        Y = torch.from_numpy(rng.randn(n, self.n_components).astype(
            np.float32) * 1e-2).to(dev)
        Pj = torch.from_numpy(P * 4.0).to(dev)   # early exaggeration
        dY = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        Q = None
        for it in range(self.max_iter):
            if it == self.stop_lying_iteration:
                Pj = Pj / 4.0
            mom = (self.momentum if it < self.switch_momentum_iteration
                   else self.final_momentum)
            Y, dY, gains, Q = self._step(Y, dY, gains, Pj, mom)
        # the KL of the last gradient's Q against the P it used
        self.kl_ = float(_kl(Pj, Q))
        self.Y_ = Y.cpu().numpy()
        return self.Y_


# ---------------------------------------------------------------------------
# Barnes-Hut t-SNE
# ---------------------------------------------------------------------------

class BarnesHutTsne(Tsne):
    """``plot/BarnesHutTsne.java``: O(N log N), a sparse input P over
    3 x perplexity VP-tree neighbours, SpTree repulsion at ``theta``;
    host numpy throughout (``device`` is not used)."""

    def __init__(self, theta: float = 0.5, **kwargs):
        kwargs.setdefault("max_iter", 300)
        super().__init__(**kwargs)
        self.theta = theta

    def fit(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        if k < 1:
            raise ValueError("need at least 2 points")
        tree = VPTree(X, seed=self.seed)
        rows = np.zeros((n, k), np.int64)
        d2 = np.zeros((n, k), np.float64)
        for i in range(n):
            nb = tree.knn(X[i], k, exclude=i)
            for j, (idx, d) in enumerate(nb):
                rows[i, j] = idx
                d2[i, j] = d * d
        condP = _binary_search_sigmas(d2, min(self.perplexity, k))
        # symmetrize sparse P
        P = {}
        for i in range(n):
            for j in range(k):
                a, b = i, int(rows[i, j])
                P[(a, b)] = P.get((a, b), 0.0) + condP[i, j]
                P[(b, a)] = P.get((b, a), 0.0) + condP[i, j]
        total = sum(P.values())
        for key in P:
            P[key] /= total

        rng = np.random.RandomState(self.seed)
        Y = rng.randn(n, self.n_components) * 1e-2
        dY = np.zeros_like(Y)
        gains = np.ones_like(Y)
        keys = np.array(list(P.keys()), np.int64)
        vals = np.array(list(P.values()))
        lie = 12.0  # BH implementations use stronger early exaggeration
        for it in range(self.max_iter):
            if it == self.stop_lying_iteration:
                lie = 1.0
            mom = (self.momentum if it < self.switch_momentum_iteration
                   else self.final_momentum)
            grad = self._bh_grad(Y, keys, vals * lie)
            inc = np.sign(grad) != np.sign(dY)
            gains = np.where(inc, gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            dY = mom * dY - self.learning_rate * gains * grad
            Y = Y + dY
            Y = Y - Y.mean(0)
        self.Y_ = Y
        self.kl_ = self._sparse_kl(Y, keys, vals)
        return Y

    def _sparse_kl(self, Y, keys, vals) -> float:
        """Approximate KL over the sparse P support, with Z estimated by the
        same Barnes-Hut pass the gradient uses (BarnesHutTsne.java logisxPlusC
        role)."""
        sp = SpTree(Y)
        sum_z = 0.0
        for i in range(Y.shape[0]):
            sum_z += sp.compute_non_edge_forces(
                Y[i], self.theta, np.zeros(Y.shape[1]))
        diff = Y[keys[:, 0]] - Y[keys[:, 1]]
        q_un = 1.0 / (1.0 + (diff * diff).sum(1))
        q = np.maximum(q_un / max(sum_z, 1e-12), 1e-12)
        p = np.maximum(vals, 1e-12)
        return float(np.sum(vals * np.log(p / q)))

    def _bh_grad(self, Y, keys, vals) -> np.ndarray:
        n = Y.shape[0]
        # attractive (edge) forces over sparse P
        diff = Y[keys[:, 0]] - Y[keys[:, 1]]
        q = 1.0 / (1.0 + (diff * diff).sum(1))
        w = (vals * q)[:, None] * diff
        pos_f = np.zeros_like(Y)
        np.add.at(pos_f, keys[:, 0], w)
        # repulsive via Barnes-Hut
        sp = SpTree(Y)
        neg_f = np.zeros_like(Y)
        sum_z = 0.0
        for i in range(n):
            buf = np.zeros(Y.shape[1])
            sum_z += sp.compute_non_edge_forces(Y[i], self.theta, buf)
            neg_f[i] = buf
        return pos_f - neg_f / max(sum_z, 1e-12)
