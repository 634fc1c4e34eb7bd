"""Weight trees shared by the families: seeded draws on the device, and
the nested parameter tree the program's models hold."""

from __future__ import annotations

import math

import torch

from perfbench import seeds


def draw_weights(spec, seed, stream, dev):
    """The flat float32 weight dict of run ``seed`` on ``dev`` from
    ``spec``, a list of (name, shape, init) where init is a std, "ones"
    or "zeros": one normal draw for every random leaf, split and
    scaled."""
    g = seeds.device(seed, stream, dev)
    total = sum(math.prod(s) for _, s, init in spec
                if not isinstance(init, str))
    flat = torch.randn(total, generator=g, device=dev)
    w, o = {}, 0
    for name, shape, init in spec:
        if init == "ones":
            w[name] = torch.ones(shape, device=dev)
        elif init == "zeros":
            w[name] = torch.zeros(shape, device=dev)
        else:
            n = math.prod(shape)
            w[name] = flat[o:o + n].view(shape) * init
            o += n
    del flat
    return w


def nested(flat):
    """{"b0.qkv": t} -> {"b0": {"qkv": t}}."""
    tree = {}
    for path, leaf in flat.items():
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = leaf
    return tree


def flatten(tree, prefix=""):
    """{"b0": {"qkv": t}} (dicts or ParameterDicts) -> {"b0.qkv": t}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, torch.nn.ParameterDict)):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def parameter_tree(tree):
    """A nested dict of tensors as nested ``ParameterDict``s holding
    those tensors (not copies)."""
    return torch.nn.ParameterDict({
        k: parameter_tree(v) if isinstance(v, dict)
        else torch.nn.Parameter(v) for k, v in tree.items()})
