"""Flattened parameter vector views: the port of
``deeplearning4j_tpu/utils/flat_params.py``.

The flat vector is the reference's: layers in order, each layer's params
in its declared ``param_order``, each raveled row-major. So
``port_net.set_params(jax_net.params())`` carries a JAX net's parameters
across, and the two ``params()`` vectors compare element for element.
"""

from __future__ import annotations

import math

import torch

__all__ = ["n_params", "params_to_vector", "vector_to_params"]


def params_to_vector(layer_confs, params_list):
    """Concatenate per-layer named params into one 1-D tensor."""
    chunks = [params[name].reshape(-1)
              for conf, params in zip(layer_confs, params_list)
              for name in conf.param_order]
    if not chunks:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(chunks)


def vector_to_params(layer_confs, vec):
    """Inverse of :func:`params_to_vector`: split a flat tensor back into
    per-layer dicts (each piece a fresh contiguous tensor)."""
    params_list = []
    offset = 0
    for conf in layer_confs:
        shapes = conf.param_shapes()
        d = {}
        for name in conf.param_order:
            shape = shapes[name]
            n = math.prod(shape) if shape else 1
            d[name] = vec[offset:offset + n].reshape(shape).clone()
            offset += n
        params_list.append(d)
    if offset != vec.shape[0]:
        raise ValueError(f"Parameter vector length {vec.shape[0]} != "
                         f"expected {offset}")
    return params_list


def n_params(layer_confs):
    return sum(conf.n_params() for conf in layer_confs)
