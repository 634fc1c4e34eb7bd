"""The line-search solvers: the port of
``deeplearning4j_tpu/optimize/solvers.py`` (``optimize/Solver.java:48``,
``optimize/solvers/{LineGradientDescent,ConjugateGradient,LBFGS,
BackTrackLineSearch}.java``).

Each solver runs ``iterations`` whole-batch iterations over a flat
parameter vector on the model's device (f32 from the models; a float64
vector stays float64): a search direction, an Armijo
backtracking line search along it, and one value-and-gradient at the
point it lands on. The reference runs the whole loop as one XLA program,
its line search a ``lax.while_loop`` that exits at the first step
meeting the Armijo condition. Here the loop runs on the host and the
line search stops on the host too: each probe is one forward evaluation,
and its Armijo test is one read of the device. So an iteration costs one
value-and-gradient (forward and backward) and ``1 + b`` forward
evaluations, ``b`` the backtracks the line search took (at most
``max_line_search_iterations``, 16): the probes the reference's loop
runs, and no more. The steps and scores are the reference's; the float
sums differ in order only.

Every quantity the reference selects with ``jnp.where`` (a failed line
search keeps the point, L-BFGS skips a pair that fails the curvature
condition) is decided the same way here, on the host.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["ConjugateGradient", "LBFGS", "LineGradientDescent",
           "backtrack_line_search", "solver_for"]


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def backtrack_line_search(f: Callable, x, fx, g, d, *, initial_step=1.0,
                          c1=1e-4, rho=0.5, max_iterations=16,
                          min_step=1e-12):
    """Armijo backtracking (``BackTrackLineSearch.java``): shrink ``step``
    until ``f(x + step·d) <= f(x) + c1·step·gᵀd``. Returns ``(step,
    f_new)`` as 0-d tensors; step 0 (and ``f_new = fx``) when no decrease
    was found above ``min_step`` within ``max_iterations`` backtracks."""
    gd = _vdot(g, d)
    step = torch.tensor(initial_step, dtype=x.dtype, device=x.device)
    fnew = f(x + step * d)
    it = 0
    while True:
        armijo = bool(fnew <= fx + c1 * step * gd)
        if armijo or not bool(step > min_step) or it >= max_iterations:
            break
        step = step * rho
        fnew = f(x + step * d)
        it += 1
    if bool(fnew <= fx + c1 * step * gd):
        return step, fnew
    return torch.zeros_like(step), fx


def _descent_or_restart(g, d):
    """Steepest descent where ``d`` is not a descent direction
    (BaseOptimizer's check, the conjugate gradient's restart)."""
    return d if bool(_vdot(g, d) < 0) else -g


class _LineSearchSolver:
    """The iteration driver the three solvers share: direction, line
    search, value-and-gradient at the new point."""

    def __init__(self, max_line_search_iterations=16, initial_step=1.0):
        self.max_ls = max_line_search_iterations
        self.initial_step = initial_step

    # subclasses: init_extra(x0, g0); direction(g, extra) -> d;
    # update_extra(extra, x, x_new, g, g_new, d)
    def make_run(self, value_and_grad: Callable, iterations: int, *,
                 value: Callable = None):
        """The run function ``run(x0, *args) -> (x, score, score
        history)``. ``value_and_grad(vec, *args) -> (loss, flat
        gradient)``; ``value(vec, *args) -> loss`` is the line search's
        forward-only probe (default: the loss of ``value_and_grad``)."""
        def run(x0, *args):
            def f(x):
                if value is not None:
                    return value(x, *args)
                return value_and_grad(x, *args)[0]
            x = x0.detach()
            fx, g = value_and_grad(x, *args)
            extra = self.init_extra(x, g)
            hist = []
            for _ in range(iterations):
                d = _descent_or_restart(g, self.direction(g, extra))
                step, fnew = backtrack_line_search(
                    f, x, fx, g, d, initial_step=self.initial_step,
                    max_iterations=self.max_ls)
                if bool(step > 0):
                    x_new = x + step * d
                    f_new, g_new = value_and_grad(x_new, *args)
                else:
                    # a failed line search keeps the point and gradient
                    x_new, f_new, g_new = x, fx, g
                extra = self.update_extra(extra, x, x_new, g, g_new, d)
                x, fx, g = x_new, f_new, g_new
                hist.append(fx)
            return x, fx, (torch.stack(hist) if hist
                           else torch.zeros(0, device=x.device))
        return run

    def optimize(self, value_and_grad: Callable, x0, iterations: int, *args,
                 value: Callable = None):
        """One-shot convenience over :meth:`make_run`."""
        x0 = torch.as_tensor(x0, dtype=torch.float32)
        return self.make_run(value_and_grad, iterations, value=value)(
            x0, *args)

    # defaults: steepest descent
    def init_extra(self, x0, g0):
        return None

    def direction(self, g, extra):
        return -g

    def update_extra(self, extra, x, x_new, g, g_new, d):
        return extra


class LineGradientDescent(_LineSearchSolver):
    """Steepest descent with the line search (``LineGradientDescent.java``)."""


class ConjugateGradient(_LineSearchSolver):
    """Nonlinear conjugate gradient, Polak-Ribière with restart (PR+,
    ``ConjugateGradient.java``)."""

    def init_extra(self, x0, g0):
        return {"g_prev": g0, "d_prev": -g0, "first": True}

    def direction(self, g, extra):
        if extra["first"]:
            return -g
        g_prev, d_prev = extra["g_prev"], extra["d_prev"]
        beta = _vdot(g, g - g_prev) / torch.clamp(_vdot(g_prev, g_prev),
                                                  min=1e-30)
        beta = torch.clamp(beta, min=0.0)   # PR+ restart
        return -g + beta * d_prev

    def update_extra(self, extra, x, x_new, g, g_new, d):
        return {"g_prev": g, "d_prev": d, "first": False}


class LBFGS(_LineSearchSolver):
    """Limited-memory BFGS (``LBFGS.java``): the two-loop recursion over a
    rolling history of the last ``m`` (s, y) pairs."""

    def __init__(self, m: int = 10, **kw):
        super().__init__(**kw)
        self.m = m

    def init_extra(self, x0, g0):
        return {"S": [None] * self.m, "Y": [None] * self.m,
                "rho": [None] * self.m, "k": 0}

    def direction(self, g, extra):
        S, Y, rho, k = extra["S"], extra["Y"], extra["rho"], extra["k"]
        m = self.m
        have = min(k, m)
        q = g
        alphas = [None] * m
        for i in range(have):             # newest to oldest
            j = (k - 1 - i) % m
            alphas[i] = rho[j] * _vdot(S[j], q)
            q = q - alphas[i] * Y[j]
        if k > 0:
            n = (k - 1) % m
            gamma = _vdot(S[n], Y[n]) / torch.clamp(_vdot(Y[n], Y[n]),
                                                    min=1e-30)
        else:
            gamma = 1.0
        r = gamma * q
        for i2 in reversed(range(have)):  # oldest to newest
            j = (k - 1 - i2) % m
            beta = rho[j] * _vdot(Y[j], r)
            r = r + S[j] * (alphas[i2] - beta)
        return -r

    def update_extra(self, extra, x, x_new, g, g_new, d):
        s, y = x_new - x, g_new - g
        sy = _vdot(s, y)
        if not bool(sy > 1e-10):   # curvature condition: skip the pair
            return extra
        slot = extra["k"] % self.m
        S, Y, rho = list(extra["S"]), list(extra["Y"]), list(extra["rho"])
        S[slot], Y[slot] = s, y
        rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
        return {"S": S, "Y": Y, "rho": rho, "k": extra["k"] + 1}


_SOLVERS = {
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


def solver_for(optimization_algo: str, **kw):
    """``Solver.java``'s facade role: an ``optimization_algo`` name to its
    solver. An unknown name raises ``ValueError``; the
    ``stochastic_gradient_descent`` path is the models' own step."""
    algo = str(optimization_algo).lower()
    cls = _SOLVERS.get(algo)
    if cls is None:
        raise ValueError(
            f"unknown optimization algorithm {optimization_algo!r}; "
            f"expected one of {sorted(_SOLVERS)} or "
            "'stochastic_gradient_descent'")
    return cls(**kw)
