"""Numerical against analytic gradient checking: the port of
``deeplearning4j_tpu/gradientcheck/gradient_check_util.py``
(``gradientcheck/GradientCheckUtil.java:76`` for a MultiLayerNetwork,
``:223`` for a ComputationGraph).

Central differences over the flat parameter vector are held, parameter
by parameter, against the analytic gradient (``torch.autograd``), in
float64, with a relative-error threshold and an absolute floor for tiny
gradients. The float64 copies of the parameters, layer state and data
live on the model's device: the card unless the model was built on the
CPU. The LSTM kernels take float32 and bfloat16 only, so on the card a
float64 LSTM net's check raises the kernel's ``TypeError`` (the
reference runs its checks on the CPU by design); on the CPU it runs the
kernels' plain twins. ``subset`` draws the same indices as the
reference: ``RandomState(seed).choice(n, subset, replace=False)``.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["check_gradients", "check_gradients_graph"]


def _f64(a, device):
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)))
    return t.detach().to(device=device, dtype=torch.float64)


def _tree64(tree, device):
    return [{k: _f64(v, device) for k, v in d.items()} for d in tree]


def _mln_loss(net, x, y, fmask=None, lmask=None):
    """(loss of a flat float64 parameter vector, the net's vector)."""
    dev = net.device
    states64 = _tree64(net.states_list, dev)
    x64, y64 = _f64(x, dev), _f64(y, dev)
    fm, lm = _f64(fmask, dev), _f64(lmask, dev)

    def loss_from_vector(vec):
        plist = flat_params.vector_to_params(net.layers, vec)
        score, _ = net._loss_fn(plist, states64, x64, y64, fm, lm, None,
                                train=False)
        return score
    vec0 = flat_params.params_to_vector(net.layers,
                                        _tree64(net.params_list, dev))
    return loss_from_vector, vec0


def _graph_loss(graph, mds):
    """(loss of a flat float64 parameter vector, the graph's vector) for
    a MultiDataSet (or a DataSet)."""
    from deeplearning4j_tpu_torch.models.computation_graph import _as_multi
    mds = _as_multi(mds)
    dev = graph.device
    states64 = _tree64(graph.states_list, dev)

    def streams(arrs):
        return None if arrs is None else [_f64(a, dev) for a in arrs]
    inputs, labels = streams(mds.features), streams(mds.labels)
    fmasks, lmasks = streams(mds.features_masks), streams(mds.labels_masks)

    def loss_from_vector(vec):
        plist = flat_params.vector_to_params(graph.layers, vec)
        score, _ = graph._loss_fn(plist, states64, inputs, labels, fmasks,
                                  lmasks, None, train=False)
        return score
    vec0 = flat_params.params_to_vector(graph.layers,
                                        _tree64(graph.params_list, dev))
    return loss_from_vector, vec0


def analytic_gradient(loss_from_vector, vec0):
    """The flat analytic gradient at ``vec0``, as float64 numpy."""
    v = vec0.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_from_vector(v), [v],
                                   allow_unused=True)
    return np.zeros(v.shape[0]) if g is None else g.detach().cpu().numpy()


def _central_difference(loss_from_vector, vec0, *, epsilon, max_rel_error,
                        min_abs_error, print_results, subset, seed):
    """The central-difference loop (GradientCheckUtil.checkGradients's
    body). Returns (passed, max relative error, failures)."""
    analytic = analytic_gradient(loss_from_vector, vec0)
    n = vec0.shape[0]
    idxs = range(n)
    if subset is not None and subset < n:
        idxs = np.random.RandomState(seed).choice(n, subset, replace=False)
    max_rel = 0.0
    failures = 0
    with torch.no_grad():
        for i in idxs:
            i = int(i)
            vp = vec0.clone()
            vp[i] += epsilon
            vm = vec0.clone()
            vm[i] -= epsilon
            numeric = (float(loss_from_vector(vp))
                       - float(loss_from_vector(vm))) / (2 * epsilon)
            a = float(analytic[i])
            diff = abs(a - numeric)
            denom = abs(a) + abs(numeric)
            rel = 0.0 if denom == 0 else diff / denom
            if rel > max_rel_error and diff > min_abs_error:
                failures += 1
                if print_results:
                    print(f"param {i}: analytic={a:.8g} "
                          f"numeric={numeric:.8g} rel={rel:.3g}")
            max_rel = max(max_rel, rel if diff > min_abs_error else 0.0)
    return failures == 0, max_rel, failures


def check_gradients(net, x, y, fmask=None, lmask=None, *, epsilon=1e-6,
                    max_rel_error=1e-3, min_abs_error=1e-8,
                    print_results=False, subset=None, seed=0):
    """Gradient-check a MultiLayerNetwork. Returns (passed, max observed
    relative error, failures). ``subset``: check only this many randomly
    chosen parameters."""
    fn, vec0 = _mln_loss(net, x, y, fmask, lmask)
    return _central_difference(
        fn, vec0, epsilon=epsilon, max_rel_error=max_rel_error,
        min_abs_error=min_abs_error, print_results=print_results,
        subset=subset, seed=seed)


def check_gradients_graph(graph, mds, *, epsilon=1e-6, max_rel_error=1e-3,
                          min_abs_error=1e-8, print_results=False,
                          subset=None, seed=0):
    """Gradient-check a ComputationGraph on a MultiDataSet (a DataSet is
    converted)."""
    fn, vec0 = _graph_loss(graph, mds)
    return _central_difference(
        fn, vec0, epsilon=epsilon, max_rel_error=max_rel_error,
        min_abs_error=min_abs_error, print_results=print_results,
        subset=subset, seed=seed)
