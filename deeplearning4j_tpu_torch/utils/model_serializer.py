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
- ``metadata.json``: ``model_type``, ``iteration``, ``epoch`` and
  ``framework`` (this package's name);
- ``preprocessor.bin``: a fitted normalizer's bytes, kept as they are;
- ``manifest.json``: the CRC-32 of each entry (``utils/atomic_io.py``).

Every write commits through ``atomic_io`` (temporary file, fsync,
rename); a restore verifies the manifest and raises
``CheckpointCorruptError`` for a torn or bit-rotted archive. The write
side is numpy on the host. TransformerLM archives and the normalizer
classes are not ported yet: they raise ``NotImplementedError`` naming
ROADMAP.md.
"""

from __future__ import annotations

import io
import json
import zipfile
from contextlib import contextmanager

import numpy as np
import torch

from deeplearning4j_tpu_torch.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils import atomic_io, flat_params

__all__ = ["CONFIG_NAME", "COEFFICIENTS_NAME", "META_NAME", "NORMALIZER_NAME",
           "STATE_NAME", "UPDATER_NAME", "add_normalizer_to_model",
           "model_entries", "model_type", "restore_computation_graph",
           "restore_model", "restore_multi_layer_network",
           "restore_normalizer_from_file", "write_model"]

CONFIG_NAME = "configuration.json"
COEFFICIENTS_NAME = "coefficients.npy"
UPDATER_NAME = "updaterState.npy"
STATE_NAME = "state.npz"
META_NAME = "metadata.json"
NORMALIZER_NAME = "preprocessor.bin"
FRAMEWORK = "deeplearning4j_tpu_torch"


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, "
        "queue 1, \"Persistence gaps\")")


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


def model_entries(net, save_updater=True, normalizer=None):
    """The archive's entries ({name: bytes | str}) for a
    MultiLayerNetwork or a ComputationGraph: the common part of
    :func:`write_model` and the training checkpoint (which adds its own
    entry before the commit). ``normalizer`` is a fitted normalizer's
    bytes, stored as they are."""
    if not isinstance(net, (MultiLayerNetwork, ComputationGraph)):
        raise _not_ported(f"the {type(net).__name__} archive")
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
    })
    if normalizer is not None:
        entries[NORMALIZER_NAME] = bytes(normalizer)
    return entries


def write_model(net, path, save_updater=True, normalizer=None,
                extra_entries=None):
    """Save a MultiLayerNetwork (ModelSerializer.writeModel) through the
    atomic commit. ``extra_entries`` ride in the same commit (the training
    checkpoint's state)."""
    entries = model_entries(net, save_updater, normalizer)
    if extra_entries:
        entries.update(extra_entries)
    return atomic_io.write_zip_atomic(path, entries)


def add_normalizer_to_model(path, normalizer):
    """Attach a normalizer's bytes to an existing archive, replacing any
    there (ModelSerializer.addNormalizerToModel). The archive is committed
    again whole: an append would leave a moment where a crash tears the
    only copy."""
    entries = atomic_io.read_zip_entries(path, exclude=(NORMALIZER_NAME,))
    entries[NORMALIZER_NAME] = bytes(normalizer)
    atomic_io.write_zip_atomic(path, entries)


def restore_normalizer_from_file(path):
    """Not ported: the normalizer classes come later."""
    raise _not_ported("restore_normalizer_from_file (the normalizers)")


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
    """Load a model archive of any kind this package has (ModelGuesser's
    role): a MultiLayerNetwork or a ComputationGraph; the other kinds
    raise."""
    kind = model_type(path)
    if kind in (None, "MultiLayerNetwork"):
        return restore_multi_layer_network(path, load_updater, device=device)
    if kind == "ComputationGraph":
        return restore_computation_graph(path, load_updater, device=device)
    raise _not_ported(f"restoring a {kind} archive")


def model_type(path):
    """The archive's model kind from its metadata, or None."""
    with _verified(path) as z:
        if META_NAME in z.namelist():
            return json.loads(z.read(META_NAME).decode()).get("model_type")
        return None
