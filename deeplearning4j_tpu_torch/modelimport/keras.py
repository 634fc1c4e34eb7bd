"""Keras HDF5 model import: the port of
``deeplearning4j_tpu/modelimport/keras.py`` (``deeplearning4j-modelimport``:
``KerasModel.java``, ``KerasSequentialModel.java``, ``KerasLayer.java``'s
class-name dispatch, the ``KerasModelImport.java`` entry points and the
weight conventions of ``KerasModel.helperImportWeights:288``).

Reads Keras 1 and Keras 2 ``model.save()`` files with the package's own
HDF5 reader (``utils/h5.py``); h5py, where it is installed, is only a
second try for a layout the reader rejects (``_h5_fallback``). Without
h5py the reader's own error surfaces. The file holds:

- root attr ``model_config``: JSON {"class_name": "Sequential"|"Model",
  "config"}; root attr ``training_config`` (optional): the loss;
- group ``model_weights`` (or the root): per-layer groups with attr
  ``weight_names`` and the datasets.

Layouts (the reference's):

- Dense W is (in, out): this package's layout.
- Conv2D 'tf' kernels are (rows, cols, in, out) = HWIO, the native
  layout; 'th' kernels (out, in, rows, cols) are transposed, and the
  first Dense after a Flatten gets its rows permuted from the (c, h, w)
  flatten order to (h, w, c), once at import.
- LSTM: Keras 1 stores 12 arrays [i, c, f, o] x [W, U, b], packed here
  into W/RW/b with gate order [i, f, g(c), o]; Keras 2 stores 3 packed
  arrays already in that order.
- BatchNormalization's weights are [gamma, beta, running_mean,
  running_var]; the last two go into the layer's state.

The networks are built on the configuration builders and initialised
on their device (the card unless the caller passes ``device="cpu"``);
each imported array is then copied into the tensor the net already
holds, in place, so captured graphs and the flat view stay bound.
"""

from __future__ import annotations

import json

import numpy as np

import torch

from deeplearning4j_tpu_torch.nn.conf.graph import (ElementWiseVertex,
                                                    LastTimeStepVertex,
                                                    MergeVertex, ScaleVertex)
from deeplearning4j_tpu_torch.nn.conf.input_type import (Convolutional,
                                                         InputType)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    CnnToFeedForwardPreProcessor
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, EmbeddingLayer, GlobalPoolingLayer, GravesBidirectionalLSTM,
    LastTimeStepLayer, OutputLayer, SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.utils.h5 import H5Error, H5File

__all__ = ["KerasImportError", "KerasModelImport",
           "import_keras_model_and_weights",
           "import_keras_sequential_model_and_weights"]

# keras activation name → ours (KerasLayer.mapActivation)
ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "softmax": "softmax",
    "sigmoid": "sigmoid", "tanh": "tanh", "hard_sigmoid": "hardsigmoid",
    "softplus": "softplus", "softsign": "softsign", "elu": "elu",
    "leakyrelu": "leakyrelu",
}

# keras loss name → ours (KerasModel training config mapping)
LOSSES = {
    "categorical_crossentropy": "mcxent", "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "kullback_leibler_divergence": "kl_divergence",
    "poisson": "poisson", "cosine_proximity": "cosine_proximity",
}


def _act(name):
    if name is None:
        return "identity"
    if name not in ACTIVATIONS:
        raise ValueError(f"Unsupported Keras activation {name!r}")
    return ACTIVATIONS[name]


def _loss(name, default="mcxent", strict=False):
    if name is None:
        return default
    if name not in LOSSES:
        if strict:
            raise KerasImportError(f"Unsupported Keras loss {name!r}")
        return default  # non-enforcing import: architecture+weights still usable
    return LOSSES[name]


class KerasImportError(ValueError):
    """Invalid/unsupported Keras configuration
    (reference InvalidKerasConfigurationException family)."""


# ---------------------------------------------------------------------------
# config translation
# ---------------------------------------------------------------------------

def _pair_of(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _map_layer(class_name, cfg, dim_ordering):
    """One Keras layer config → (our layer | marker string, metadata dict).

    Markers: 'input', 'flatten', 'merge' (handled by the callers).
    Mirrors KerasLayer's switch (KerasLayer.java:192-240)."""
    act = cfg.get("activation")
    if class_name in ("InputLayer",):
        return "input", {}
    if class_name == "Flatten":
        return "flatten", {}
    if class_name == "Merge":
        return "merge", {"mode": cfg.get("mode", "concat")}
    if class_name in ("Add", "Concatenate", "Multiply", "Average", "Maximum"):
        # keras2 splits Merge into per-op layer classes
        return "merge", {"mode": {"Add": "add", "Concatenate": "concat",
                                  "Multiply": "mul", "Average": "ave",
                                  "Maximum": "max"}[class_name]}
    if class_name in ("Dense", "TimeDistributedDense"):
        units = cfg.get("units", cfg.get("output_dim"))   # keras2 | keras1
        return DenseLayer(n_out=int(units), activation=_act(act)), {}
    if class_name in ("Convolution2D", "Conv2D"):
        # keras1: nb_filter/nb_row/nb_col/subsample/border_mode
        # keras2: filters/kernel_size/strides/padding
        if "filters" in cfg:
            n_out = int(cfg["filters"])
            kh, kw = _pair_of(cfg["kernel_size"])
            stride = tuple(cfg.get("strides", (1, 1)))
            border = cfg.get("padding", "valid")
        else:
            n_out = int(cfg["nb_filter"])
            kh, kw = int(cfg["nb_row"]), int(cfg["nb_col"])
            stride = tuple(cfg.get("subsample", (1, 1)))
            border = cfg.get("border_mode", "valid")
        if border not in ("valid", "same"):
            raise KerasImportError(
                f"Unsupported Conv2D padding/border_mode {border!r} "
                "(only 'valid'/'same'; Theano 'full' has no DL4J equivalent)")
        layer = ConvolutionLayer(
            n_out=n_out,
            kernel_size=(kh, kw),
            stride=_pair_of(stride),
            padding=(0, 0),
            convolution_mode="same" if border == "same" else "truncate",
            activation=_act(act))
        return layer, {}
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        pool = _pair_of(cfg.get("pool_size", (2, 2)))
        stride = cfg.get("strides") or pool
        border = cfg.get("padding", cfg.get("border_mode", "valid"))
        return SubsamplingLayer(
            pooling_type="max" if class_name.startswith("Max") else "avg",
            kernel_size=pool, stride=_pair_of(stride),
            convolution_mode="same" if border == "same" else "truncate"), {}
    if class_name in ("GlobalMaxPooling1D", "GlobalMaxPooling2D"):
        return GlobalPoolingLayer(pooling_type="max"), {}
    if class_name in ("GlobalAveragePooling1D", "GlobalAveragePooling2D"):
        return GlobalPoolingLayer(pooling_type="avg"), {}
    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        return ZeroPaddingLayer(padding=_pair_of(pad)), {}
    if class_name == "Dropout":
        # keras p/rate = drop prob; DL4J 0.7 dropout field = retain prob
        drop = float(cfg.get("rate", cfg.get("p", 0.5)))   # keras2 | keras1
        return DropoutLayer(dropout=1.0 - drop), {}
    if class_name == "Activation":
        return ActivationLayer(activation=_act(act)), {}
    if class_name == "BatchNormalization":
        if cfg.get("mode", 0) not in (0, 2):
            raise KerasImportError(
                f"Unsupported BatchNormalization mode {cfg.get('mode')}")
        return BatchNormalization(eps=float(cfg.get("epsilon", 1e-5)),
                                  decay=float(cfg.get("momentum", 0.99))), {}
    if class_name == "LSTM":
        units = cfg.get("units", cfg.get("output_dim"))   # keras2 | keras1
        gate = cfg.get("recurrent_activation",
                       cfg.get("inner_activation", "hard_sigmoid"))
        if "unit_forget_bias" in cfg:                      # keras2 flag
            fb = 1.0 if cfg["unit_forget_bias"] else 0.0
        else:
            fb = 1.0 if cfg.get("forget_bias_init", "one") == "one" else 0.0
        return LSTM(n_out=int(units),
                    activation=_act(cfg.get("activation", "tanh")),
                    gate_activation=_act(gate),
                    forget_gate_bias_init=fb), \
            {"return_sequences": bool(cfg.get("return_sequences", False))}
    if class_name == "Bidirectional":
        inner = cfg.get("layer", {})
        if inner.get("class_name") != "LSTM":
            raise KerasImportError(
                f"Bidirectional wraps {inner.get('class_name')!r}; only "
                "LSTM is supported")
        icfg = inner.get("config", {})
        units = icfg.get("units", icfg.get("output_dim"))
        merge = cfg.get("merge_mode", "concat")
        if merge not in ("concat", "sum", "add", "ave"):
            raise KerasImportError(
                f"Unsupported Bidirectional merge_mode {merge!r}")
        if merge == "ave":
            raise KerasImportError(
                "Bidirectional merge_mode 'ave' has no layer equivalent "
                "(use concat or sum)")
        gate = icfg.get("recurrent_activation",
                        icfg.get("inner_activation", "hard_sigmoid"))
        if not icfg.get("return_sequences", False):
            raise KerasImportError(
                "Bidirectional with return_sequences=False is not "
                "supported: keras takes the backward direction's own final "
                "state (original t=0), which a last-time-step view of the "
                "merged sequence cannot reproduce")
        return GravesBidirectionalLSTM(
            n_out=int(units),
            mode="concat" if merge == "concat" else "add",
            activation=_act(icfg.get("activation", "tanh")),
            gate_activation=_act(gate)), \
            {"return_sequences": True}
    if class_name == "Embedding":
        return EmbeddingLayer(n_in=int(cfg["input_dim"]),
                              n_out=int(cfg["output_dim"]),
                              activation="identity"), {}
    raise KerasImportError(f"Unsupported Keras layer class {class_name!r} "
                           f"(KerasLayer.java registry parity)")


def _input_type_from_shape(shape, dim_ordering):
    """Keras input shape tuple (no batch dim) → InputType. NHWC here; 'th'
    shapes (c, h, w) are converted. A None time dim ([None, F] variable-length
    sequences) maps to Recurrent(F, timeseries_length=None)."""
    shape = list(shape)
    if len(shape) == 1 and shape[0] is not None:
        return InputType.feed_forward(int(shape[0]))
    if len(shape) == 2 and shape[1] is not None:
        t = None if shape[0] is None else int(shape[0])
        return InputType.recurrent(int(shape[1]), t)
    if len(shape) == 3 and all(s is not None for s in shape):
        if dim_ordering == "th":
            c, h, w = shape
        else:
            h, w, c = shape
        return InputType.convolutional(int(h), int(w), int(c))
    raise KerasImportError(f"Cannot infer InputType from Keras shape {shape}")


def _detect_dim_ordering(layer_cfgs):
    for lc in layer_cfgs:
        cfg = lc.get("config", {})
        d = cfg.get("dim_ordering")                      # keras1
        if d in ("tf", "th"):
            return d
        df = cfg.get("data_format")                      # keras2
        if df == "channels_last":
            return "tf"
        if df == "channels_first":
            return "th"
    return "tf"


# ---------------------------------------------------------------------------
# weight translation (helperImportWeights:288 parity)
# ---------------------------------------------------------------------------

def _keras_layer_weights(wgroup, lname):
    g = wgroup[lname]
    names = [n.decode() if isinstance(n, bytes) else n
             for n in g.attrs.get("weight_names", [])]
    return [np.asarray(g[n]) for n in names], names


def _convert_weights(layer, arrays, dim_ordering, post_flatten_shape=None):
    """Keras weight arrays → our param dict for one layer."""
    if isinstance(layer, ConvolutionLayer):
        W = arrays[0]
        if dim_ordering == "th":
            W = np.transpose(W, (2, 3, 1, 0))  # OIHW → HWIO
        b = arrays[1] if len(arrays) > 1 else np.zeros(W.shape[-1], W.dtype)
        return {"W": W, "b": b}
    if isinstance(layer, DenseLayer):  # covers OutputLayer
        W = arrays[0]
        if post_flatten_shape is not None and dim_ordering == "th":
            # rows are in (c,h,w) flatten order; permute to (h,w,c)
            c, h, w = post_flatten_shape
            perm = np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()
            W = W[perm]
        b = arrays[1] if len(arrays) > 1 else np.zeros(W.shape[-1], W.dtype)
        return {"W": W, "b": b}
    if isinstance(layer, BatchNormalization):
        gamma, beta, mean, var = arrays[:4]
        return {"gamma": gamma, "beta": beta}, {"mean": mean, "var": var}
    if isinstance(layer, GravesBidirectionalLSTM):
        # keras2 Bidirectional: 6 packed arrays (fwd K/RK/b, bwd K/RK/b).
        # Peephole weights P are set to ZERO, which reduces the Graves cell
        # exactly to the keras vanilla LSTM.
        if len(arrays) != 6:
            raise KerasImportError(
                f"Bidirectional LSTM expects 6 weight arrays, got "
                f"{len(arrays)}")
        fK, fR, fb, bK, bR, bb = arrays
        zp = np.zeros((3, layer.n_out), fK.dtype)
        return {"F_W": fK, "F_RW": fR, "F_b": fb, "F_P": zp,
                "B_W": bK, "B_RW": bR, "B_b": bb, "B_P": zp.copy()}
    if isinstance(layer, LSTM):
        if len(arrays) == 3:
            # keras2 packed form: kernel [in,4u] / recurrent_kernel [u,4u] /
            # bias [4u], gate column order [i,f,c,o] == our packed layout
            W, RW, b = arrays
            return {"W": W, "RW": RW, "b": b}
        if len(arrays) != 12:
            raise KerasImportError(
                f"LSTM expects 12 (keras1) or 3 (keras2) weight arrays, "
                f"got {len(arrays)}")
        (W_i, U_i, b_i, W_c, U_c, b_c, W_f, U_f, b_f, W_o, U_o, b_o) = arrays
        # keras order [i, c, f, o] → our packed [i, f, g(=c), o]
        W = np.concatenate([W_i, W_f, W_c, W_o], axis=1)
        RW = np.concatenate([U_i, U_f, U_c, U_o], axis=1)
        b = np.concatenate([b_i, b_f, b_c, b_o])
        return {"W": W, "RW": RW, "b": b}
    if isinstance(layer, EmbeddingLayer):
        W = arrays[0]
        return {"W": W, "b": np.zeros(W.shape[1], W.dtype)}
    if not arrays:
        return {}
    raise KerasImportError(f"Don't know how to import weights for "
                           f"{type(layer).__name__}")


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def _open(path, force_h5py=False):
    """Open a Keras HDF5 file with the package's own reader; h5py only
    when ``_h5_fallback`` retries."""
    if force_h5py:
        import h5py
        return h5py.File(path, "r")
    return H5File(path)


def _h5_fallback(fn):
    """Retry an import once through h5py when the minimal reader rejects a
    construct — it parses lazily, so the rejection can surface anywhere
    mid-import, not just at open time. Without h5py the reader's error
    is raised (the reference's bare ``raise`` there re-raises the
    ImportError instead)."""
    import functools

    @functools.wraps(fn)
    def wrapper(path, *args, **kwargs):
        try:
            return fn(path, *args, **kwargs)
        except H5Error as err:
            try:
                import h5py  # noqa: F401
            except ImportError:
                raise err from None   # no fallback: the reader's error
            return fn(path, *args, _force_h5py=True, **kwargs)
    return wrapper


def _assign(net_tree, key, value, what):
    """Copy ``value`` into the tensor ``net_tree[key]`` in place (f32),
    after checking its shape."""
    dst = net_tree[key]
    if tuple(value.shape) != tuple(dst.shape):
        raise KerasImportError(
            f"Weight shape mismatch for {what}/{key}: keras {value.shape} "
            f"vs expected {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(value, np.float32)))


def _load_layer(params, states, layer, converted, what):
    """Write one layer's converted Keras arrays into the net's own
    parameter and state tensors."""
    if isinstance(converted, tuple):
        converted, state = converted
        for k, v in state.items():
            _assign(states, k, v, what)
    for k, v in converted.items():
        if k not in layer.param_shapes():
            raise KerasImportError(f"{what}: no parameter {k!r} in "
                                   f"{type(layer).__name__}")
        _assign(params, k, v, what)


def _read_configs(f):
    mc = f.attrs.get("model_config")
    if mc is None:
        raise KerasImportError("No model_config attribute in HDF5 file "
                               "(KerasModelImport expects model.save() output)")
    if isinstance(mc, bytes):
        mc = mc.decode()
    model_config = json.loads(mc)
    tc = f.attrs.get("training_config")
    if tc is not None and isinstance(tc, bytes):
        tc = tc.decode()
    training_config = json.loads(tc) if tc else None
    wgroup = f["model_weights"] if "model_weights" in f else f
    return model_config, training_config, wgroup


def _finalize_sequential(entries, training_config, enforce_training_config):
    """Convert the trailing Dense(+Activation) into an OutputLayer with the
    training-config loss (KerasSequentialModel output-layer handling)."""
    loss_name = None
    if training_config is not None:
        loss_name = training_config.get("loss")
    if enforce_training_config and loss_name is None:
        raise KerasImportError("enforce_training_config: no loss in training_config")
    # merge trailing Activation into preceding Dense
    if (len(entries) >= 2 and isinstance(entries[-1][0], ActivationLayer)
            and isinstance(entries[-2][0], DenseLayer)):
        act_layer, _ = entries.pop()
        dense, name = entries[-1]
        dense = dense.copy(activation=act_layer.activation)
        entries[-1] = (dense, name)
    last, name = entries[-1]
    if isinstance(last, DenseLayer) and not isinstance(last, OutputLayer):
        default = "mcxent" if last.activation == "softmax" else "mse"
        out = OutputLayer(n_out=last.n_out, activation=last.activation,
                          loss=_loss(loss_name, default,
                                     strict=enforce_training_config))
        entries[-1] = (out, name)
    return entries


@_h5_fallback
def import_keras_sequential_model_and_weights(path, enforce_training_config=False,
                                              device=None, _force_h5py=False):
    """Sequential .h5 → MultiLayerNetwork (KerasModelImport.
    importKerasSequentialModelAndWeights), on ``device`` (the card unless
    the caller passes ``device="cpu"``)."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork

    with _open(path, _force_h5py) as f:
        model_config, training_config, wgroup = _read_configs(f)
        if model_config.get("class_name") != "Sequential":
            raise KerasImportError(
                f"Not a Sequential model: {model_config.get('class_name')}")
        layer_cfgs = model_config["config"]
        if isinstance(layer_cfgs, dict):  # keras 2 style nesting
            layer_cfgs = layer_cfgs.get("layers", [])
        dim_ordering = _detect_dim_ordering(layer_cfgs)

        entries = []          # (our_layer, keras_name)
        input_type = None
        flatten_marks = set()  # our-layer indices directly after a Flatten
        pending_flatten = False

        for lc in layer_cfgs:
            cname = lc["class_name"]
            cfg = lc.get("config", {})
            kname = cfg.get("name") or lc.get("name") or cname.lower()
            if input_type is None:
                bis = cfg.get("batch_input_shape")
                if bis is not None:
                    input_type = _input_type_from_shape(bis[1:], dim_ordering)
            mapped, meta = _map_layer(cname, cfg, dim_ordering)
            if mapped == "input":
                continue
            if mapped == "flatten":
                pending_flatten = True
                continue
            if isinstance(mapped, str):
                raise KerasImportError(f"Unexpected marker {mapped} in Sequential")
            if pending_flatten and isinstance(mapped, DenseLayer):
                flatten_marks.add(len(entries))
                pending_flatten = False
            entries.append((mapped, kname))
            if isinstance(mapped, LSTM) and not meta.get("return_sequences", True):
                # keras return_sequences=False: only the last step flows on
                entries.append((LastTimeStepLayer(), f"{kname}__last_step"))

        entries = _finalize_sequential(entries, training_config,
                                       enforce_training_config)
        if input_type is None:
            raise KerasImportError("No batch_input_shape on the first layer")

        conf = (NeuralNetConfiguration.Builder().list())
        for layer, _ in entries:
            conf.layer(layer)
        conf.set_input_type(input_type)
        mlconf = conf.build()
        net = MultiLayerNetwork(mlconf, device=device).init()

        # 'th' flatten fix-up shapes come from the auto-inserted CnnToFeedForward
        # preprocessor (it knows the feature-map dims at the flatten point)
        flatten_before = {}
        if dim_ordering == "th":
            for i in flatten_marks:
                pre = mlconf.input_preprocessors.get(i)
                if isinstance(pre, CnnToFeedForwardPreProcessor):
                    flatten_before[i] = (pre.num_channels, pre.input_height,
                                         pre.input_width)

        # ---- copy weights ------------------------------------------------
        for i, (layer, kname) in enumerate(entries):
            if kname not in wgroup:
                if layer.param_shapes():
                    raise KerasImportError(f"No weights for layer {kname!r}")
                continue
            arrays, _ = _keras_layer_weights(wgroup, kname)
            if not arrays:
                continue
            converted = _convert_weights(net.layers[i], arrays, dim_ordering,
                                         flatten_before.get(i))
            _load_layer(net.params_list[i], net.states_list[i],
                        net.layers[i], converted, kname)
    return net


@_h5_fallback
def import_keras_model_and_weights(path, enforce_training_config=False,
                                   device=None, _force_h5py=False):
    """Functional Model .h5 → ComputationGraph (KerasModelImport.
    importKerasModelAndWeights), on ``device`` (the card unless the caller
    passes ``device="cpu"``). Sequential files are auto-routed."""
    with _open(path, _force_h5py) as f:
        model_config, training_config, wgroup = _read_configs(f)
        if model_config.get("class_name") == "Sequential":
            pass  # fall through below, outside the with
        else:
            return _import_functional(model_config, training_config, wgroup,
                                      enforce_training_config, device)
    return import_keras_sequential_model_and_weights(
        path, enforce_training_config, device=device)


def _import_functional(model_config, training_config, wgroup,
                       enforce_training_config, device):
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph

    cfg = model_config["config"]
    layer_cfgs = cfg["layers"]
    dim_ordering = _detect_dim_ordering(layer_cfgs)
    input_layers = [l[0] for l in cfg["input_layers"]]
    output_layers = [l[0] for l in cfg["output_layers"]]

    gb = NeuralNetConfiguration.Builder().graph_builder()
    input_type_by_name = {}
    kname_order = []
    flatten_inputs = {}            # flatten vertex name → its wired input name
    dense_after_flatten = {}       # dense vertex name → flatten vertex name
    _functional_weight_alias = {}  # our vertex name → keras h5 group name
    loss_name = training_config.get("loss") if training_config else None
    strict = enforce_training_config

    # pre-pass: an output that is a standalone Activation fed by a Dense is the
    # common Keras 1.x head idiom; fold the activation into the Dense (mirrors
    # the Sequential path's _finalize_sequential merge). The merged OutputLayer
    # vertex takes the Activation's (declared-output) name; its weights stay
    # under the Dense's h5 group via _functional_weight_alias. Only safe when
    # the Activation is the Dense's sole consumer.
    act_out_to_dense = {}   # activation kname → dense kname
    dense_act_merge = {}    # dense kname → (activation fn, activation kname)
    by_name = {(l.get("name") or l.get("config", {}).get("name")): l
               for l in layer_cfgs}
    consumers = {}          # layer name → set of consumer names
    for lc in layer_cfgs:
        kname = lc.get("name") or lc.get("config", {}).get("name")
        for node in lc.get("inbound_nodes", []):
            for n in node:
                consumers.setdefault(n[0], set()).add(kname)
    for lc in layer_cfgs:
        kcfg = lc.get("config", {})
        kname = lc.get("name") or kcfg.get("name")
        if lc["class_name"] != "Activation" or kname not in output_layers:
            continue
        inbound = [n[0] for node in lc.get("inbound_nodes", []) for n in node]
        if (len(inbound) == 1 and inbound[0] in by_name
                and by_name[inbound[0]]["class_name"] == "Dense"
                and consumers.get(inbound[0]) == {kname}):
            act_out_to_dense[kname] = inbound[0]
            dense_act_merge[inbound[0]] = (
                _act(kcfg.get("activation")), kname)

    for lc in layer_cfgs:
        cname = lc["class_name"]
        kcfg = lc.get("config", {})
        kname = lc.get("name") or kcfg.get("name")
        inbound_nodes = lc.get("inbound_nodes", [])
        if len(inbound_nodes) > 1:
            raise KerasImportError(
                f"Layer {kname!r} has {len(inbound_nodes)} inbound nodes "
                "(shared layer applied multiple times) — not supported")
        inbound = [n[0] for node in inbound_nodes for n in node]
        if kname in act_out_to_dense:
            continue  # folded into its Dense below
        mapped, meta = _map_layer(cname, kcfg, dim_ordering)
        if kname in dense_act_merge and isinstance(mapped, DenseLayer):
            act_fn, act_name = dense_act_merge[kname]
            default = "mcxent" if act_fn == "softmax" else "mse"
            ln = (loss_name.get(act_name) if isinstance(loss_name, dict)
                  else loss_name)
            mapped = OutputLayer(n_out=mapped.n_out, activation=act_fn,
                                 loss=_loss(ln, default, strict=strict))
            if inbound and inbound[0] in flatten_inputs:
                dense_after_flatten[act_name] = inbound[0]
            gb.add_layer(act_name, mapped, *inbound)
            kname_order.append(act_name)
            _functional_weight_alias[act_name] = kname
            continue
        if mapped == "input":
            bis = kcfg.get("batch_input_shape")
            if bis is None:
                raise KerasImportError(f"InputLayer {kname} without batch_input_shape")
            input_type_by_name[kname] = _input_type_from_shape(bis[1:], dim_ordering)
            continue
        if mapped == "flatten":
            # auto-preprocessor insertion handles CNN→FF; model as identity
            gb.add_vertex(kname, ScaleVertex(scale_factor=1.0), *inbound)
            flatten_inputs[kname] = inbound[0]
            continue
        if mapped == "merge":
            mode = meta["mode"]
            if mode in ("concat",):
                gb.add_vertex(kname, MergeVertex(), *inbound)
            elif mode in ("sum", "add"):
                gb.add_vertex(kname, ElementWiseVertex(op="add"), *inbound)
            elif mode == "mul":
                gb.add_vertex(kname, ElementWiseVertex(op="product"), *inbound)
            elif mode == "ave":
                gb.add_vertex(kname, ElementWiseVertex(op="average"), *inbound)
            elif mode == "max":
                gb.add_vertex(kname, ElementWiseVertex(op="max"), *inbound)
            else:
                raise KerasImportError(f"Unsupported Merge mode {mode!r}")
            continue
        if isinstance(mapped, str):
            raise KerasImportError(f"Unexpected marker {mapped}")
        if isinstance(mapped, DenseLayer) and inbound and inbound[0] in flatten_inputs:
            dense_after_flatten[kname] = inbound[0]
        if kname in output_layers and isinstance(mapped, DenseLayer) \
                and not isinstance(mapped, OutputLayer):
            default = "mcxent" if mapped.activation == "softmax" else "mse"
            if isinstance(loss_name, dict):
                ln = loss_name.get(kname)
            else:
                ln = loss_name
            mapped = OutputLayer(n_out=mapped.n_out, activation=mapped.activation,
                                 loss=_loss(ln, default, strict=strict))
        if isinstance(mapped, LSTM) and not meta.get("return_sequences", True):
            # keras return_sequences=False: expose the vertex name as the
            # last-step view so downstream wiring stays by keras name
            inner = f"{kname}__lstm"
            gb.add_layer(inner, mapped, *inbound)
            gb.add_vertex(kname, LastTimeStepVertex(), inner)
            kname_order.append(inner)
            _functional_weight_alias[inner] = kname
            continue
        gb.add_layer(kname, mapped, *inbound)
        kname_order.append(kname)

    # inputs registered in the declared keras input order, not layer-list order
    missing = [n for n in input_layers if n not in input_type_by_name]
    if missing:
        raise KerasImportError(f"input_layers reference unknown inputs: {missing}")
    gb.add_inputs(*input_layers)
    gb.set_outputs(*output_layers)
    gb.set_input_types(*[input_type_by_name[n] for n in input_layers])
    conf = gb.build()
    net = ComputationGraph(conf, device=device).init()

    # 'th' post-Flatten Dense row permutation (same fix as the Sequential path):
    # feature-map dims come from the flatten vertex's input output-type
    flatten_shape_for_dense = {}
    if dim_ordering == "th":
        for dname, fname in dense_after_flatten.items():
            src_type = conf.vertex_output_types.get(flatten_inputs[fname])
            if isinstance(src_type, Convolutional):
                flatten_shape_for_dense[dname] = (
                    src_type.channels, src_type.height, src_type.width)

    for kname in kname_order:
        layer = conf.vertices[kname].layer
        h5name = _functional_weight_alias.get(kname, kname)
        if h5name not in wgroup:
            if layer.param_shapes():
                raise KerasImportError(f"No weights for layer {h5name!r}")
            continue
        arrays, _ = _keras_layer_weights(wgroup, h5name)
        if not arrays:
            continue
        converted = _convert_weights(layer, arrays, dim_ordering,
                                     flatten_shape_for_dense.get(kname))
        i = net.layer_names.index(kname)
        _load_layer(net.params_list[i], net.states_list[i], layer,
                    converted, kname)
    return net


class KerasModelImport:
    """Static entry points (KerasModelImport.java)."""

    import_keras_sequential_model_and_weights = staticmethod(
        import_keras_sequential_model_and_weights)
    import_keras_model_and_weights = staticmethod(import_keras_model_and_weights)
