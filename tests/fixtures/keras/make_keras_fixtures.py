#!/usr/bin/env python3
"""Write the committed Keras fixtures of this directory (needs h5py, and
the PyTorch package on the CPU for the LeNet's training).

    python3 tests/fixtures/keras/make_keras_fixtures.py

Each file is a Keras ``model.save()`` HDF5 file in the layout Keras
writes (root attrs ``model_config`` and ``training_config``, group
``model_weights`` with ``layer_names``, per-layer groups with
``weight_names``). Initial weights are drawn as Keras draws them, from
``numpy.random.RandomState(SEED)``: kernels Glorot-uniform (limit
sqrt(6 / (fan_in + fan_out)), a conv's fans times its kernel area),
recurrent kernels orthogonal, biases 0 (an LSTM's forget-gate bias 1,
Keras 2's ``unit_forget_bias``), BatchNormalization's gamma 1, beta 0,
moving mean 0 and moving variance 1 (here the moments are drawn, so the
import's state copy shows).

- ``lenet_k1_tf.h5``: Keras 1 Sequential, 'tf' ordering, at the zoo's
  ``lenet_mnist`` widths (Convolution2D 20 and 50 filters of 5x5, linear;
  MaxPooling2D 2x2; Flatten; Dense 500 relu; Dense 10 softmax; 431,080
  parameters). Its Glorot draws are trained on ``tests/fixtures/
  real_mnist`` through the port's ``lenet_mnist`` configuration on the
  CPU (Nesterov momentum 0.9, lr 0.01; 40 epochs at batch 64, shuffle
  seed 5, the reference's real-MNIST recipe) until the held-out accuracy
  on the fixture's 64 test digits is at least 0.90, and the trained
  weights are written.
- ``residual_k1_th.h5``: a Keras 1 functional model in 'th' ordering:
  Input (4, 8, 8), Convolution2D 4 filters 3x3 'same' relu,
  BatchNormalization (mode 0, axis 1), Merge(sum) with the input,
  Flatten, Dense 5 softmax (the Dense rows in the 'th' (c, h, w) flatten
  order).
- ``lstm_k2_charrnn.h5``: a Keras 2 Sequential at the char-RNN's width:
  LSTM 200 units over 65 inputs, T 50, ``recurrent_activation`` sigmoid,
  ``return_sequences`` False, then Dense 65 softmax.
- ``resnet50_narrow_k1_tf.h5``: Keras applications' ``ResNet50`` at full
  depth as a Keras 1 functional model in 'tf' ordering, its filter
  widths narrowed 16x (4 ... 128 in place of 64 ... 2048): input
  224x224x3, ZeroPadding2D 3, Convolution2D 7x7/2, BatchNormalization
  (mode 0, axis 3), relu, MaxPooling2D 3x3/2; stages of 3, 4, 6 and 3
  bottleneck blocks (1x1, 3x3 'same', 1x1, each with its
  BatchNormalization), the first of each with a strided 1x1 projection
  shortcut (stride 1 in the first stage, 2 after), joined by Merge(sum)
  and relu; AveragePooling2D 7x7, Flatten, Dense 1000 softmax. Keras's
  layer names (``conv1``, ``res2a_branch2a``, ``bn2a_branch2a``, ...);
  Glorot-uniform kernels, zero biases and drawn BatchNormalization
  moments from ``RandomState(SEED)``; ``make_resnet50_narrow`` writes
  it alone.
- ``vgg16_tiny_k1_tf.h5``: a miniature VGG-shaped Keras 1 Sequential,
  'tf' ordering, that ``TrainedModelHelper(VGG16).set_path_to_h5`` loads
  in place of the real VGG16 weights: 8x8x3 input, Convolution2D 2
  filters 3x3 'same' relu, MaxPooling2D 2x2, Flatten, Dense 1000
  softmax, with the weights the reference's ``tests/test_trained_models.py``
  draws (``RandomState(7)``: the conv ``randn * 0.1`` HWIO, the dense
  ``randn * 0.1``, biases 0).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
SEED = 2024
LENET_FILE = "lenet_k1_tf.h5"
RESIDUAL_FILE = "residual_k1_th.h5"
LSTM_FILE = "lstm_k2_charrnn.h5"
VGG_FILE = "vgg16_tiny_k1_tf.h5"
RESNET50_FILE = "resnet50_narrow_k1_tf.h5"
# Keras applications' ResNet50 stages: (blocks, (f1, f2, f3), first stride),
# the filters narrowed 16x
RESNET50_STAGES = ((3, (4, 4, 16), 1), (4, (8, 8, 32), 2),
                   (6, (16, 16, 64), 2), (3, (32, 32, 128), 2))
RESNET50_STEM = 4
HELD_OUT_BAR = 0.90
LEARN = dict(epochs=40, batch=64, shuffle_seed=5)


def glorot(r, shape):
    """Keras's glorot_uniform for a (fan_in, fan_out) kernel."""
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return r.uniform(-limit, limit, shape).astype(np.float32)


def glorot_conv(r, kh, kw, c_in, c_out, ordering):
    """glorot_uniform for a conv kernel: each fan times the kernel area;
    'tf' (kh, kw, in, out), 'th' (out, in, kh, kw)."""
    limit = np.sqrt(6.0 / (kh * kw * c_in + kh * kw * c_out))
    shape = (kh, kw, c_in, c_out) if ordering == "tf" else \
        (c_out, c_in, kh, kw)
    return r.uniform(-limit, limit, shape).astype(np.float32)


def orthogonal(r, rows, cols):
    """Keras's orthogonal initializer for a (rows, cols) kernel."""
    a = r.normal(0.0, 1.0, (rows, cols))
    u, _, v = np.linalg.svd(a, full_matrices=False)
    return (u if u.shape == (rows, cols) else v).astype(np.float32)


def write_keras(path, model_config, layer_weights, training_config,
                keras_version):
    """``layer_weights``: {layer: [(weight name, array)]}; Keras 2 nests
    each layer's arrays one group down as ``<layer>/<name>:0``."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["keras_version"] = keras_version.encode()
        f.attrs["backend"] = b"tensorflow"
        f.attrs["model_config"] = json.dumps(model_config).encode()
        f.attrs["training_config"] = json.dumps(training_config).encode()
        wg = f.create_group("model_weights")
        wg.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_weights], dtype="S64")
        for lname, weights in layer_weights.items():
            g = wg.create_group(lname)
            k2 = keras_version.startswith("2")
            names = [f"{lname}/{wn}:0" if k2 else wn for wn, _ in weights]
            g.attrs["weight_names"] = np.array([n.encode() for n in names],
                                               dtype="S96")
            for name, (_, arr) in zip(names, weights):
                g.create_dataset(name, data=np.asarray(arr, np.float32))


def _sgd(loss):
    return {"loss": loss, "metrics": ["accuracy"],
            "optimizer_config": {"class_name": "SGD", "config": {
                "lr": 0.01, "momentum": 0.9, "nesterov": True}}}


def lenet_config():
    return {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "name": "convolution2d_1", "nb_filter": 20, "nb_row": 5,
            "nb_col": 5, "subsample": [1, 1], "border_mode": "valid",
            "dim_ordering": "tf", "activation": "linear",
            "batch_input_shape": [None, 28, 28, 1]}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "maxpooling2d_1", "pool_size": [2, 2],
            "strides": [2, 2], "border_mode": "valid",
            "dim_ordering": "tf"}},
        {"class_name": "Convolution2D", "config": {
            "name": "convolution2d_2", "nb_filter": 50, "nb_row": 5,
            "nb_col": 5, "subsample": [1, 1], "border_mode": "valid",
            "dim_ordering": "tf", "activation": "linear"}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "maxpooling2d_2", "pool_size": [2, 2],
            "strides": [2, 2], "border_mode": "valid",
            "dim_ordering": "tf"}},
        {"class_name": "Flatten", "config": {"name": "flatten_1"}},
        {"class_name": "Dense", "config": {
            "name": "dense_1", "output_dim": 500, "activation": "relu"}},
        {"class_name": "Dense", "config": {
            "name": "dense_2", "output_dim": 10, "activation": "softmax"}},
    ]}


LENET_LAYERS = ("convolution2d_1", "maxpooling2d_1", "convolution2d_2",
                "maxpooling2d_2", "flatten_1", "dense_1", "dense_2")


def lenet_weights(params_list):
    """The net's per-layer params (HWIO convs, (in, out) denses: Keras 1
    'tf' layouts) as Keras 1 layer weights."""
    with_params = iter([p for p in params_list if p])
    out = {}
    for name in LENET_LAYERS:
        if name.startswith(("convolution", "dense")):
            p = next(with_params)
            out[name] = [(f"{name}_W", p["W"]), (f"{name}_b", p["b"])]
        else:
            out[name] = []
    return out


def initial_lenet_params(r):
    return [{"W": glorot_conv(r, 5, 5, 1, 20, "tf"),
             "b": np.zeros(20, np.float32)}, {},
            {"W": glorot_conv(r, 5, 5, 20, 50, "tf"),
             "b": np.zeros(50, np.float32)}, {},
            {"W": glorot(r, (800, 500)), "b": np.zeros(500, np.float32)},
            {"W": glorot(r, (500, 10)), "b": np.zeros(10, np.float32)}]


def held_out_accuracy(net, test):
    return float((np.argmax(net.output(test.features), 1)
                  == test.label_ids).mean())


def make_lenet(path):
    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork, params_from_numpy)
    torch.manual_seed(SEED)
    data = str(REPO / "tests" / "fixtures" / "real_mnist")
    train = MnistDataSetIterator(LEARN["batch"], shuffle=True,
                                 seed=LEARN["shuffle_seed"], data_dir=data)
    test = MnistDataSetIterator(LEARN["batch"], train=False, data_dir=data)
    net = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    net.params_list = params_from_numpy(
        net.layers, initial_lenet_params(np.random.RandomState(SEED)), "cpu")
    net.fit(train, epochs=LEARN["epochs"])
    acc = held_out_accuracy(net, test)
    if acc < HELD_OUT_BAR:
        raise SystemExit(f"LeNet reached held-out accuracy {acc} < "
                         f"{HELD_OUT_BAR}")
    params = [{k: v.detach().numpy() for k, v in p.items()}
              for p in net.params_list]
    write_keras(path, lenet_config(), lenet_weights(params),
                _sgd("categorical_crossentropy"), "1.2.2")
    return acc


def residual_config():
    def node(*names):
        return [[[n, 0, 0] for n in names]]
    return {"class_name": "Model", "config": {
        "name": "residual_th",
        "layers": [
            {"class_name": "InputLayer", "name": "input_1",
             "config": {"name": "input_1",
                        "batch_input_shape": [None, 4, 8, 8]},
             "inbound_nodes": []},
            {"class_name": "Convolution2D", "name": "conv",
             "config": {"name": "conv", "nb_filter": 4, "nb_row": 3,
                        "nb_col": 3, "subsample": [1, 1],
                        "border_mode": "same", "dim_ordering": "th",
                        "activation": "relu"},
             "inbound_nodes": node("input_1")},
            {"class_name": "BatchNormalization", "name": "bn",
             "config": {"name": "bn", "epsilon": 1e-3, "mode": 0,
                        "axis": 1, "momentum": 0.99},
             "inbound_nodes": node("conv")},
            {"class_name": "Merge", "name": "add",
             "config": {"name": "add", "mode": "sum"},
             "inbound_nodes": node("bn", "input_1")},
            {"class_name": "Flatten", "name": "flat",
             "config": {"name": "flat"},
             "inbound_nodes": node("add")},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "output_dim": 5,
                        "activation": "softmax"},
             "inbound_nodes": node("flat")}],
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}


def make_residual(path, r):
    weights = {
        "conv": [("conv_W", glorot_conv(r, 3, 3, 4, 4, "th")),
                 ("conv_b", np.zeros(4, np.float32))],
        "bn": [("bn_gamma", (1.0 + 0.1 * r.randn(4)).astype(np.float32)),
               ("bn_beta", (0.1 * r.randn(4)).astype(np.float32)),
               ("bn_running_mean", (0.2 * r.randn(4)).astype(np.float32)),
               ("bn_running_std",
                (1.0 + 0.5 * r.rand(4)).astype(np.float32))],
        "add": [], "flat": [],
        "out": [("out_W", glorot(r, (256, 5))),
                ("out_b", np.zeros(5, np.float32))]}
    write_keras(path, residual_config(), weights,
                _sgd("categorical_crossentropy"), "1.2.2")


def lstm_config(vocab=65, units=200, t=50):
    return {"class_name": "Sequential", "config": {"name": "charrnn",
                                                   "layers": [
        {"class_name": "LSTM", "config": {
            "name": "lstm_1", "units": units, "activation": "tanh",
            "recurrent_activation": "sigmoid", "use_bias": True,
            "unit_forget_bias": True, "return_sequences": False,
            "batch_input_shape": [None, t, vocab]}},
        {"class_name": "Dense", "config": {
            "name": "dense_1", "units": vocab, "activation": "softmax"}}]}}


def make_lstm(path, r, vocab=65, units=200):
    bias = np.zeros(4 * units, np.float32)
    bias[units:2 * units] = 1.0
    recurrent = np.concatenate([orthogonal(r, units, units)
                                for _ in range(4)], axis=1)
    weights = {
        "lstm_1": [("kernel", glorot(r, (vocab, 4 * units))),
                   ("recurrent_kernel", recurrent), ("bias", bias)],
        "dense_1": [("kernel", glorot(r, (units, vocab))),
                    ("bias", np.zeros(vocab, np.float32))]}
    write_keras(path, lstm_config(vocab, units), weights,
                _sgd("categorical_crossentropy"), "2.1.6")


def vgg_tiny_config():
    return {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D",
         "config": {"name": "conv", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
                    "subsample": [1, 1], "border_mode": "same",
                    "activation": "relu", "dim_ordering": "tf",
                    "batch_input_shape": [None, 8, 8, 3]}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "pool", "pool_size": [2, 2], "strides": [2, 2],
                    "border_mode": "valid", "dim_ordering": "tf"}},
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        {"class_name": "Dense",
         "config": {"name": "predictions", "output_dim": 1000,
                    "activation": "softmax"}}]}


def make_vgg_tiny(path):
    r = np.random.RandomState(7)
    conv = (r.randn(3, 3, 3, 2) * 0.1).astype(np.float32)
    dense = (r.randn(2 * 4 * 4, 1000) * 0.1).astype(np.float32)
    weights = {"conv": [("conv_W", conv),
                        ("conv_b", np.zeros(2, np.float32))],
               "pool": [], "flatten": [],
               "predictions": [("predictions_W", dense),
                               ("predictions_b",
                                np.zeros(1000, np.float32))]}
    write_keras(path, vgg_tiny_config(), weights,
                _sgd("categorical_crossentropy"), "1.2.2")


def resnet50_narrow_layers(r):
    """(Keras 1 functional layer configs, {layer: weights}) of the narrow
    ResNet-50, in Keras's order and names."""
    layers, weights = [], {}
    counter = {"activation": 0, "merge": 0}

    def add(cls, name, cfg, inbound, w=()):
        layers.append({"class_name": cls, "name": name,
                       "config": dict(cfg, name=name),
                       "inbound_nodes": [[[n, 0, 0] for n in inbound]]
                       if inbound else []})
        weights[name] = list(w)
        return name

    def conv(name, x, c_in, c_out, k, stride=1, border="valid"):
        return add("Convolution2D", name, {
            "nb_filter": c_out, "nb_row": k, "nb_col": k,
            "subsample": [stride, stride], "border_mode": border,
            "dim_ordering": "tf", "activation": "linear"}, [x],
            [(f"{name}_W", glorot_conv(r, k, k, c_in, c_out, "tf")),
             (f"{name}_b", np.zeros(c_out, np.float32))])

    def bn(name, x, c):
        return add("BatchNormalization", name, {
            "epsilon": 1e-3, "mode": 0, "axis": 3, "momentum": 0.99}, [x],
            [(f"{name}_gamma", (1.0 + 0.1 * r.randn(c)).astype(np.float32)),
             (f"{name}_beta", (0.1 * r.randn(c)).astype(np.float32)),
             (f"{name}_running_mean", (0.1 * r.randn(c)).astype(np.float32)),
             (f"{name}_running_std",
              (1.0 + 0.5 * r.rand(c)).astype(np.float32))])

    def relu(x):
        counter["activation"] += 1
        return add("Activation", f"activation_{counter['activation']}",
                   {"activation": "relu"}, [x])

    def block(x, c_in, filters, stage, part, stride, project):
        f1, f2, f3 = filters
        base = f"{stage}{part}_branch"
        y = relu(bn(f"bn{base}2a", conv(f"res{base}2a", x, c_in, f1, 1,
                                         stride), f1))
        y = relu(bn(f"bn{base}2b", conv(f"res{base}2b", y, f1, f2, 3,
                                        border="same"), f2))
        y = bn(f"bn{base}2c", conv(f"res{base}2c", y, f2, f3, 1), f3)
        short = x
        if project:
            short = bn(f"bn{base}1", conv(f"res{base}1", x, c_in, f3, 1,
                                          stride), f3)
        counter["merge"] += 1
        m = add("Merge", f"merge_{counter['merge']}", {"mode": "sum"},
                [y, short])
        return relu(m)

    x = add("InputLayer", "input_1",
            {"batch_input_shape": [None, 224, 224, 3]}, [])
    x = add("ZeroPadding2D", "zeropadding2d_1",
            {"padding": [3, 3], "dim_ordering": "tf"}, [x])
    x = relu(bn("bn_conv1", conv("conv1", x, 3, RESNET50_STEM, 7, 2),
                RESNET50_STEM))
    x = add("MaxPooling2D", "maxpooling2d_1", {
        "pool_size": [3, 3], "strides": [2, 2], "border_mode": "valid",
        "dim_ordering": "tf"}, [x])
    c_in = RESNET50_STEM
    for stage, (n, filters, stride) in enumerate(RESNET50_STAGES, start=2):
        for j in range(n):
            x = block(x, c_in, filters, stage, "abcdef"[j],
                      stride if j == 0 else 1, project=j == 0)
            c_in = filters[2]
    x = add("AveragePooling2D", "avg_pool", {
        "pool_size": [7, 7], "strides": [7, 7], "border_mode": "valid",
        "dim_ordering": "tf"}, [x])
    x = add("Flatten", "flatten_1", {}, [x])
    add("Dense", "fc1000", {"output_dim": 1000, "activation": "softmax"},
        [x], [("fc1000_W", glorot(r, (c_in, 1000))),
              ("fc1000_b", np.zeros(1000, np.float32))])
    return layers, weights


def make_resnet50_narrow(path):
    layers, weights = resnet50_narrow_layers(np.random.RandomState(SEED))
    config = {"class_name": "Model", "config": {
        "name": "resnet50", "layers": layers,
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["fc1000", 0, 0]]}}
    write_keras(path, config, weights, _sgd("categorical_crossentropy"),
                "1.2.2")


def main():
    sys.path.insert(0, str(REPO))
    r = np.random.RandomState(SEED)
    make_residual(HERE / RESIDUAL_FILE, r)
    make_lstm(HERE / LSTM_FILE, r)
    make_vgg_tiny(HERE / VGG_FILE)
    make_resnet50_narrow(HERE / RESNET50_FILE)
    acc = make_lenet(HERE / LENET_FILE)
    sizes = {p.name: p.stat().st_size for p in sorted(HERE.glob("*.h5"))}
    print(json.dumps({"lenet_held_out_accuracy": acc, "bytes": sizes,
                      "total_bytes": sum(sizes.values())}))


if __name__ == "__main__":
    main()
