"""Flattened parameter vector views: the port of
``deeplearning4j_tpu/utils/flat_params.py``.

The flat vector is the reference's: layers in order, each layer's params
in its declared ``param_order``, each raveled row-major. So
``port_net.set_params(jax_net.params())`` carries a JAX net's parameters
across, and the two ``params()`` vectors compare element for element.
The updater-state vector is the reference's too: layers in order, each
layer's state keys sorted, each key's tensors in ``param_order``; an
optax rule's state (a list of tensors in the optax state's leaf order,
its int32 step count included) is raveled leaf by leaf, as the
reference ravels ``jax.tree.leaves``. A model archive stores both
vectors, so archives load in either package.
"""

from __future__ import annotations

import math

import torch

__all__ = ["n_params", "params_to_vector", "params_to_vector_np",
           "updater_state_to_vector", "updater_state_to_vector_np",
           "vector_to_params", "vector_to_updater_state"]


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


def params_to_vector_np(layer_confs, params_list):
    """:func:`params_to_vector` on the host: a float32 numpy vector (the
    archive writers' form)."""
    return params_to_vector(layer_confs, params_list).detach().cpu().numpy()


def updater_state_to_vector(layer_confs, updater_states):
    """Flatten per-layer updater state (e.g. Adam's m and v) into one
    f32 tensor, in the reference's leaf order."""
    chunks = []
    for conf, state in zip(layer_confs, updater_states):
        for key in sorted(state):
            sub = state[key]
            if isinstance(sub, dict):
                chunks.extend(sub[pname].reshape(-1)
                              for pname in conf.param_order)
            else:   # an optax rule's leaves
                chunks.extend(leaf.reshape(-1).to(torch.float32)
                              for leaf in sub)
    if not chunks:
        return torch.zeros((0,), dtype=torch.float32)
    dev = chunks[0].device
    return torch.cat([c.to(dev) for c in chunks])


def updater_state_to_vector_np(layer_confs, updater_states):
    """:func:`updater_state_to_vector` on the host, as float32 numpy."""
    return updater_state_to_vector(layer_confs,
                                   updater_states).detach().cpu().numpy()


def vector_to_updater_state(layer_confs, updater_states_template, vec):
    """Inverse of :func:`updater_state_to_vector`; the template gives each
    layer's state keys. ``vec`` is a tensor; the pieces are fresh
    contiguous tensors on its device."""
    out = []
    offset = 0
    for conf, state in zip(layer_confs, updater_states_template):
        shapes = conf.param_shapes()
        new_state = {}
        for key in sorted(state):
            tpl = state[key]
            if not isinstance(tpl, dict):
                # an optax rule's leaves, in the template's shapes and dtypes
                sub = []
                for leaf in tpl:
                    n = leaf.numel()
                    sub.append(vec[offset:offset + n].reshape(leaf.shape)
                               .to(leaf.dtype).clone())
                    offset += n
                new_state[key] = sub
                continue
            sub = {}
            for pname in conf.param_order:
                shape = shapes[pname]
                n = math.prod(shape) if shape else 1
                sub[pname] = vec[offset:offset + n].reshape(shape).clone()
                offset += n
            new_state[key] = sub
        out.append({key: new_state[key] for key in state})
    if offset != vec.shape[0]:
        raise ValueError(f"Updater state vector length {vec.shape[0]} != "
                         f"expected {offset}")
    return out
