"""Model archives: the port of ``deeplearning4j_tpu/utils/model_serializer.py``
(ModelSerializer.java).

An archive is the reference's zip, entry for entry, so a model written by
either package loads in the other:

- ``configuration.json``: the ``MultiLayerConfiguration`` or
  ``ComputationGraphConfiguration`` JSON;
- ``coefficients.npy``: the flat float32 parameter vector (layers in
  order, a graph's in topological order; each layer's ``param_order``;
  conv weights HWIO, dense ``W`` [n_in, n_out], LSTM gates [i, f, g, o]);
- ``updaterState.npy``: the flat updater-state vector (sorted state keys,
  then ``param_order``);
- ``state.npz``: non-trainable layer state under ``{layer}.{key}``, the
  layer being a MultiLayerNetwork's index or a graph's vertex name
  (BatchNormalization's ``mean`` and ``var``);
- ``metadata.json``: ``model_type``, ``iteration``, ``epoch``,
  ``framework`` (this package's name) and ``dropout_draws``, the
  model's dropout draw counter (the masks of its next update are a
  function of it), which the reference ignores. An archive without it
  (the reference's, or one this package wrote before the counter) starts
  the counter at its ``iteration``;
- ``preprocessor.bin``: a fitted normalizer (``datasets/normalizers.py``,
  whose bytes both packages read);
- ``manifest.json``: the CRC-32 of each entry (``utils/atomic_io.py``).

A ``TransformerLM`` archive (the reference's pytree family) holds the
configuration dataclass as JSON (the 27 fields of ``TransformerConfig``,
which the reference rebuilds with ``TransformerConfig(**json)``), the
parameters and the optimizer state (``ema`` if kept, then ``m``, then
``v``) each flattened in the reference's leaf order
(``models/transformer.py`` :func:`leaf_paths`), and ``metadata.json``
with ``iteration``. The reference's metadata carries its threefry
dropout key under ``rng``, which no torch generator can continue (the
ROADMAP's RNG rule): the port reads such an archive and starts its
dropout stream afresh, seeded as ``init`` seeds it, and writes its own
generator's state under ``torch_rng`` (with ``torch_rng_device``), which
the reference ignores. ``MoETransformerLM`` and ``ViT`` archives are
the same family: their configuration dataclasses (``MoETransformerConfig``,
``ViTConfig``) as JSON, their trees in the reference's leaf order (a MoE
block's ``W1, W1_b, W2, W2_b, gate`` in place of ``fc ... out_b``; the
ViT's ``b{i}``, ``head``, ``head_b``, ``lnf_*``, ``wpatch``,
``wpatch_b``, ``wpe``), and ``model_type`` naming the class.

Every write commits through ``atomic_io`` (temporary file, fsync,
rename); a restore verifies the manifest and raises
``CheckpointCorruptError`` for a torn or bit-rotted archive. The write
side is numpy on the host.
"""

from __future__ import annotations

import io
import json
import zipfile
from contextlib import contextmanager

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.normalizers import DataNormalization
from deeplearning4j_tpu_torch.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.models.moe_transformer import (
    MoETransformerConfig, MoETransformerLM)
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, _flatten, _fresh_opt_state, leaf_paths)
from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils import atomic_io, flat_params

__all__ = ["CONFIG_NAME", "COEFFICIENTS_NAME", "META_NAME", "NORMALIZER_NAME",
           "STATE_NAME", "UPDATER_NAME", "add_normalizer_to_model",
           "is_pytree_model", "load_transformer_lm_", "model_entries", "model_type",
           "restore_computation_graph", "restore_model",
           "restore_multi_layer_network", "restore_normalizer_from_file",
           "restore_transformer_lm", "write_model"]

CONFIG_NAME = "configuration.json"
COEFFICIENTS_NAME = "coefficients.npy"
UPDATER_NAME = "updaterState.npy"
STATE_NAME = "state.npz"
META_NAME = "metadata.json"
NORMALIZER_NAME = "preprocessor.bin"
FRAMEWORK = "deeplearning4j_tpu_torch"


# the configuration fields that fix the parameter shapes
_LM_SHAPE_FIELDS = ("vocab_size", "max_len", "d_model", "n_heads",
                    "n_layers", "d_ff", "n_kv_heads", "pos_embed")
# the reference's pytree family: a configuration dataclass and parameter
# and optimizer trees, one zip layout, dispatched by metadata's
# model_type: (class, configuration class, shape fields)
_PYTREE_FAMILY = {
    "TransformerLM": (TransformerLM, TransformerConfig, _LM_SHAPE_FIELDS),
    "MoETransformerLM": (MoETransformerLM, MoETransformerConfig,
                         _LM_SHAPE_FIELDS + ("n_experts", "moe_every",
                                             "d_expert")),
    "ViT": (ViT, ViTConfig, ("image_size", "n_channels", "patch_size",
                             "n_classes", "d_model", "n_layers", "d_ff")),
}


def is_pytree_model(net):
    """Whether ``net`` is of the pytree family (a TransformerLM, an
    MoETransformerLM or a ViT)."""
    return isinstance(net, tuple(cls for cls, _, _ in
                                 _PYTREE_FAMILY.values()))


def _np_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


def _np_load(data):
    return np.load(io.BytesIO(data), allow_pickle=False)


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@contextmanager
def _verified(path):
    """Open an archive with its integrity check, and turn what storage
    damage can still raise while reading (a zip CRC error with
    ``DL4J_TORCH_CKPT_VERIFY=0``, a missing entry, an I/O error) into
    ``CheckpointCorruptError``. What is not storage damage (a
    configuration from another code version, a vector of the wrong
    length) propagates as it is: a caller falling back past corrupt
    checkpoints must not skip a healthy one over version skew."""
    z = atomic_io.open_zip_verified(path)
    try:
        with z:
            yield z
    except CheckpointCorruptError:
        raise
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is corrupt or incomplete: {e!r}") from e
    except KeyError as e:
        if "no item named" in str(e):   # zipfile's missing-member KeyError
            raise CheckpointCorruptError(
                f"checkpoint {path!r} is missing a required entry: "
                f"{e!s}") from e
        raise
    except OSError as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} failed to read: {e!r}") from e


def _normalizer_bytes(normalizer):
    """A normalizer's ``preprocessor.bin`` bytes; bytes pass as they are."""
    if isinstance(normalizer, DataNormalization):
        return normalizer.to_bytes()
    return bytes(normalizer)


def _tree_vec(tree):
    """The tree's leaves as one flat f32 host vector, in the reference's
    leaf order (one device-side concatenation, one copy to the host)."""
    flat = _flatten(tree)
    paths = leaf_paths(tree)
    if not paths:
        return np.zeros((0,), np.float32)
    with torch.no_grad():
        return torch.cat([flat[p].detach().reshape(-1).float()
                          for p in paths]).cpu().numpy()


def _check_tree_vec(tree, vec, what):
    n = sum(t.numel() for t in _flatten(tree).values())
    if vec.shape[0] != n:
        raise ValueError(f"{what} vector length {vec.shape[0]} != "
                         f"expected {n}")


def _load_tree_(tree, vec):
    """Copy the flat vector ``vec`` into the tree's tensors, in place and
    in the reference's leaf order, so that programs captured over those
    tensors stay bound to them. The caller checked the length."""
    flat = _flatten(tree)
    paths = leaf_paths(tree)
    if not paths:
        return
    dev = flat[paths[0]].device
    src = torch.from_numpy(np.ascontiguousarray(vec, np.float32)).to(dev)
    ofs = 0
    with torch.no_grad():
        for p in paths:
            t = flat[p]
            t.copy_(src[ofs:ofs + t.numel()].view(t.shape))
            ofs += t.numel()


def _transformer_entries(net, save_updater, normalizer):
    import dataclasses
    meta = {"model_type": type(net).__name__,
            "iteration": int(net.iteration),
            "framework": FRAMEWORK}
    state = net.rng_state()
    if state is not None:
        # the dropout stream advances with each step; without it a
        # restored dropout model would start it again and leave the
        # original's continuation
        meta["torch_rng"] = state.tolist()
        meta["torch_rng_device"] = net.device.type
    entries = {CONFIG_NAME: json.dumps(dataclasses.asdict(net.conf)),
               COEFFICIENTS_NAME: _np_bytes(_tree_vec(net.params))}
    if save_updater and net.opt_state is not None:
        entries[UPDATER_NAME] = _np_bytes(_tree_vec(net.opt_state))
    entries[META_NAME] = json.dumps(meta)
    if normalizer is not None:
        entries[NORMALIZER_NAME] = _normalizer_bytes(normalizer)
    return entries


def _family(kind, path):
    if kind not in _PYTREE_FAMILY:
        raise ValueError(
            f"checkpoint {path!r} holds a {kind!r} model, not one of the "
            f"pytree family {sorted(_PYTREE_FAMILY)}: use restore_model()")
    return _PYTREE_FAMILY[kind]


def _read_transformer(path, load_updater):
    """(kind, configuration dict, metadata, coefficients, updater vector
    or None) of a pytree-family archive, verified."""
    with _verified(path) as z:
        names = set(z.namelist())
        meta = (json.loads(z.read(META_NAME).decode())
                if META_NAME in names else {})
        kind = meta.get("model_type", "TransformerLM")
        _family(kind, path)
        conf = json.loads(z.read(CONFIG_NAME).decode())
        coeff = _np_load(z.read(COEFFICIENTS_NAME))
        upd = (_np_load(z.read(UPDATER_NAME))
               if load_updater and UPDATER_NAME in names else None)
    return kind, conf, meta, coeff, upd


def _adopt_rng(net, meta):
    """The archive's dropout stream, if this package wrote it for this
    kind of device; otherwise (a reference archive's threefry ``rng``,
    or a generator of another device kind) the stream starts afresh."""
    state = meta.get("torch_rng")
    if state is not None and meta.get("torch_rng_device",
                                      net.device.type) == net.device.type:
        net.set_rng_state(state)
    else:
        net.set_rng_state(None)


def restore_transformer_lm(path, load_updater=True, device=None):
    """Restore a pytree-family model (a ``TransformerLM``, an
    ``MoETransformerLM`` or a ``ViT``; the class comes from the metadata,
    the configuration from its dataclass) on ``device`` (the card unless
    the caller asks for the CPU)."""
    kind, conf, meta, coeff, upd = _read_transformer(path, load_updater)
    cls, conf_cls, _ = _family(kind, path)
    net = cls(conf_cls(**conf), device=device).init()
    _check_tree_vec(net.params, coeff, "coefficients")
    if upd is not None:
        _check_tree_vec(net.opt_state, upd, "updater state")
        _load_tree_(net.opt_state, upd)
    _load_tree_(net.params, coeff)
    net.iteration = int(meta.get("iteration", 0))
    _adopt_rng(net, meta)
    return net


def load_transformer_lm_(net, path, load_updater=True):
    """Load a pytree-family archive into the existing ``net`` (an LM, an
    MoE LM or a ViT of the archive's kind), in place: the archive's
    parameters, optimizer state, iteration and dropout stream go into the
    tensors ``net`` already holds, so CUDA graphs captured over them
    (``ContinuousLM``'s programs, ``generate()``'s) answer from the loaded
    weights without a new capture. The archive's parameter shapes must be
    ``net``'s; a failure leaves ``net`` as it was. Without an optimizer
    state in the archive (or with ``load_updater`` False) the model gets
    a fresh one, as a restored model does. Returns the archive's
    metadata."""
    kind, conf, meta, coeff, upd = _read_transformer(path, load_updater)
    if kind != type(net).__name__:
        raise ValueError(f"checkpoint {path!r} holds a {kind}, cannot load "
                         f"it into a {type(net).__name__}")
    fields = _family(kind, path)[2]
    mine = {f: getattr(net.conf, f) for f in fields}
    theirs = {f: conf.get(f, mine[f]) for f in fields}
    if mine != theirs:
        raise ValueError(f"checkpoint {path!r} holds a {kind} of other "
                         f"shapes: {theirs} against {mine}")
    if net.params is None:
        net.init()
    opt = net.opt_state
    if upd is not None and opt is None:
        opt = _fresh_opt_state(net.conf, net.params)
    _check_tree_vec(net.params, coeff, "coefficients")
    if upd is not None:
        _check_tree_vec(opt, upd, "updater state")
    _load_tree_(net.params, coeff)
    if upd is not None:
        _load_tree_(opt, upd)
        net.opt_state = opt
    else:
        # no optimizer state in the archive (or not asked for): a fresh
        # one, as a restored model's is
        net.opt_state = _fresh_opt_state(net.conf, net.params)
    net.iteration = int(meta.get("iteration", 0))
    _adopt_rng(net, meta)
    net.score_ = float("nan")
    return meta


def model_entries(net, save_updater=True, normalizer=None):
    """The archive's entries ({name: bytes | str}) for a
    MultiLayerNetwork, a ComputationGraph or a pytree-family model (a
    TransformerLM, an MoETransformerLM, a ViT): the common part of
    :func:`write_model` and the training checkpoint (which adds its own
    entry before the commit). ``normalizer`` is a fitted normalizer (or
    its ``preprocessor.bin`` bytes)."""
    if is_pytree_model(net):
        return _transformer_entries(net, save_updater, normalizer)
    if not isinstance(net, (MultiLayerNetwork, ComputationGraph)):
        # the reference fails here with an AttributeError (net.params_list)
        raise TypeError(
            f"no model archive for a {type(net).__name__}: write_model "
            "takes a MultiLayerNetwork, a ComputationGraph or a model of "
            "the pytree family (TransformerLM, MoETransformerLM, ViT)")
    graph = isinstance(net, ComputationGraph)
    slots = net.layer_names if graph else range(len(net.layers))
    entries = {
        CONFIG_NAME: net.conf.to_json(),
        COEFFICIENTS_NAME: _np_bytes(
            flat_params.params_to_vector_np(net.layers, net.params_list)),
    }
    if save_updater and net.updater_states is not None:
        entries[UPDATER_NAME] = _np_bytes(
            flat_params.updater_state_to_vector_np(net.layers,
                                                   net.updater_states))
    states = {f"{slot}.{k}": _host(v)
              for slot, s in zip(slots, net.states_list or [])
              for k, v in s.items()}
    if states:
        buf = io.BytesIO()
        np.savez(buf, **states)
        entries[STATE_NAME] = buf.getvalue()
    entries[META_NAME] = json.dumps({
        "model_type": type(net).__name__,
        "iteration": int(net.iteration),
        "epoch": int(net.epoch_count),
        "framework": FRAMEWORK,
        "dropout_draws": net.dropout_draws,
    })
    if normalizer is not None:
        entries[NORMALIZER_NAME] = _normalizer_bytes(normalizer)
    return entries


def writer_plan(net):
    """The sharding plan of more than one rank ``net`` trains under, or
    None. Under one, a save is a collective: every rank gathers the
    host view, rank 0 alone writes."""
    dp = getattr(net, "_dp", None)
    return None if dp is None else dp()


def write_model(net, path, save_updater=True, normalizer=None,
                extra_entries=None):
    """Save a MultiLayerNetwork, a ComputationGraph or a pytree-family
    model (ModelSerializer.writeModel) through the atomic commit. ``normalizer``
    goes in as ``preprocessor.bin`` (ModelSerializer.addNormalizerToModel);
    ``extra_entries`` ride in the same commit (the training checkpoint's
    state). Under a sharding plan of more than one rank every rank calls
    it: the archive holds the whole trees (gathered, so it does not
    depend on the level or the width) and rank 0 writes it."""
    plan = writer_plan(net)
    if plan is None:
        entries = model_entries(net, save_updater, normalizer)
    else:
        with net._whole(tuple(attr for attr, _ in net._plan_trees)):
            entries = model_entries(net, save_updater, normalizer)
    if extra_entries:
        entries.update(extra_entries)
    if plan is None:
        return atomic_io.write_zip_atomic(path, entries)
    out = atomic_io.write_zip_atomic(path, entries) if plan.rank == 0 \
        else path
    plan.barrier()
    return out


def add_normalizer_to_model(path, normalizer):
    """Attach a fitted normalizer (or its bytes) to an existing archive,
    replacing any there (ModelSerializer.addNormalizerToModel). The
    archive is committed again whole: an append would leave a moment
    where a crash tears the only copy."""
    entries = atomic_io.read_zip_entries(path, exclude=(NORMALIZER_NAME,))
    entries[NORMALIZER_NAME] = _normalizer_bytes(normalizer)
    atomic_io.write_zip_atomic(path, entries)


def restore_normalizer_from_file(path):
    """The archive's normalizer, or None
    (ModelSerializer.restoreNormalizerFromFile). It keeps its statistics
    on the host; a batch on the card is normalised there."""
    with _verified(path) as z:
        if NORMALIZER_NAME not in z.namelist():
            return None
        return DataNormalization.from_bytes(z.read(NORMALIZER_NAME))


def _restore(path, load_updater, make_net, slot_of):
    """A model from an archive: ``make_net(conf JSON)`` builds and inits
    it, then the coefficients, the updater state, the layer state (each
    ``state.npz`` key's layer found by ``slot_of(net, layer part)``) and
    the counters are loaded."""
    with _verified(path) as z:
        names = set(z.namelist())
        net = make_net(z.read(CONFIG_NAME).decode())
        net.set_params(_np_load(z.read(COEFFICIENTS_NAME)))
        if load_updater and UPDATER_NAME in names:
            vec = torch.from_numpy(np.array(_np_load(z.read(UPDATER_NAME)),
                                            np.float32)).to(net.device)
            net.updater_states = flat_params.vector_to_updater_state(
                net.layers, net.updater_states, vec)
        if STATE_NAME in names:
            with np.load(io.BytesIO(z.read(STATE_NAME))) as data:
                for key in data.files:
                    layer, name = key.rsplit(".", 1)
                    net.states_list[slot_of(net, layer)][name] = \
                        torch.from_numpy(np.array(data[key])).to(net.device)
        if META_NAME in names:
            meta = json.loads(z.read(META_NAME).decode())
            net.iteration = meta.get("iteration", 0)
            net.epoch_count = meta.get("epoch", 0)
            net.set_dropout_draws(meta.get("dropout_draws", net.iteration))
    return net


def restore_multi_layer_network(path, load_updater=True, device=None):
    """Restore a MultiLayerNetwork (ModelSerializer.restoreMultiLayerNetwork)
    on ``device`` (the card unless the caller asks for the CPU)."""
    return _restore(
        path, load_updater,
        lambda js: MultiLayerNetwork(MultiLayerConfiguration.from_json(js),
                                     device=device).init(),
        lambda net, layer: int(layer))


def restore_computation_graph(path, load_updater=True, device=None):
    """Restore a ComputationGraph (ModelSerializer.restoreComputationGraph)
    on ``device`` (the card unless the caller asks for the CPU)."""
    return _restore(
        path, load_updater,
        lambda js: ComputationGraph(
            ComputationGraphConfiguration.from_json(js),
            device=device).init(),
        lambda net, layer: net.layer_names.index(layer))


def restore_model(path, load_updater=True, device=None):
    """Load a model archive of any kind (ModelGuesser's role), dispatched
    by its metadata's ``model_type``: a ComputationGraph, a pytree-family
    model (TransformerLM, MoETransformerLM, ViT), else a
    MultiLayerNetwork."""
    kind = model_type(path)
    if kind == "ComputationGraph":
        return restore_computation_graph(path, load_updater, device=device)
    if kind in _PYTREE_FAMILY:
        return restore_transformer_lm(path, load_updater, device=device)
    return restore_multi_layer_network(path, load_updater, device=device)


def model_type(path):
    """The archive's model kind from its metadata, or None."""
    with _verified(path) as z:
        if META_NAME in z.namelist():
            return json.loads(z.read(META_NAME).decode()).get("model_type")
        return None
