"""The port's Keras import against the JAX package's, on every fixture
form of the reference's ``tests/test_keras_import.py`` (Keras 1 and
Keras 2 files written with h5py in the ``model.save()`` layout: Dense,
Conv2D in 'tf' and 'th' ordering with the post-Flatten row permutation,
pooling, BatchNormalization with running statistics, LSTM in both
packings with and without ``return_sequences``, a variable-length LSTM
input, Bidirectional, Dropout, Embedding, the functional merges, the
Activation output head, a Sequential routed through the functional entry
point), and on its error forms.

Both packages import each file. Parameters and layer state must be
bitwise equal (both copy the file's float32 arrays unchanged); outputs
within 1e-5 of their scale (f32, summation order only); an error must be
raised by both, with the same type name (each package has its own
``KerasImportError``, a ValueError) and, where the reference's test
names one, the same message fragment.
"""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import keras as jk
from deeplearning4j_tpu_torch.modelimport import keras as pk
from deeplearning4j_tpu_torch.modelimport import KerasModelImport
from tests.test_keras_import import (TestKeras2Import, seq_config,
                                     write_keras_file)

write_k2 = TestKeras2Import._write_k2
TOL = 1e-5


def _f32(r, *shape, scale=1.0):
    return (scale * r.randn(*shape)).astype(np.float32)


def _dense(name, units, act, **extra):
    return {"class_name": "Dense",
            "config": {"name": name, "output_dim": units, "activation": act,
                       **extra}}


def _lstm12(r, prefix, d_in, d_out):
    out = []
    for g in "icfo":
        out += [(f"{prefix}_W_{g}", _f32(r, d_in, d_out, scale=0.5)),
                (f"{prefix}_U_{g}", _f32(r, d_out, d_out, scale=0.5)),
                (f"{prefix}_b_{g}", _f32(r, d_out, scale=0.1))]
    return out


def form_mlp(p, r):
    write_keras_file(p, seq_config([
        _dense("dense_1", 8, "relu", batch_input_shape=[None, 4]),
        _dense("dense_2", 3, "softmax")]), {
        "dense_1": [("dense_1_W", _f32(r, 4, 8)), ("dense_1_b", _f32(r, 8))],
        "dense_2": [("dense_2_W", _f32(r, 8, 3)), ("dense_2_b", _f32(r, 3))],
    }, training_config={"loss": "categorical_crossentropy"})
    return "seq", [_f32(r, 5, 4)]


def _cnn(p, r, ordering):
    th = ordering == "th"
    write_keras_file(p, seq_config([
        {"class_name": "Convolution2D",
         "config": {"name": "conv", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
                    "subsample": [1, 1], "border_mode": "valid",
                    "dim_ordering": ordering, "activation": "relu",
                    "batch_input_shape": [None, 1, 8, 8] if th
                    else [None, 8, 8, 1]}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "pool", "pool_size": [2, 2], "strides": [2, 2],
                    "dim_ordering": ordering}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        _dense("fc", 4, "softmax")]), {
        "conv": [("conv_W", _f32(r, 2, 1, 3, 3) if th
                  else _f32(r, 3, 3, 1, 2)), ("conv_b", _f32(r, 2))],
        "pool": [], "flat": [],
        "fc": [("fc_W", _f32(r, 18, 4)), ("fc_b", _f32(r, 4))]})
    return "seq", [r.rand(2, 8, 8, 1).astype(np.float32)]


def form_cnn_tf(p, r):
    return _cnn(p, r, "tf")


def form_cnn_th(p, r):
    return _cnn(p, r, "th")


def form_lstm_keras1(p, r):
    write_keras_file(p, seq_config([
        {"class_name": "LSTM",
         "config": {"name": "lstm", "output_dim": 5, "activation": "tanh",
                    "inner_activation": "sigmoid",
                    "batch_input_shape": [None, 7, 3]}},
        _dense("fc", 2, "softmax")]), {
        "lstm": _lstm12(r, "lstm", 3, 5),
        "fc": [("fc_W", _f32(r, 5, 2)), ("fc_b", _f32(r, 2))]})
    return "seq", [_f32(r, 4, 7, 3)]


def form_lstm_varlen(p, r):
    write_keras_file(p, seq_config([
        {"class_name": "LSTM",
         "config": {"name": "l", "output_dim": 4, "activation": "tanh",
                    "inner_activation": "hard_sigmoid",
                    "return_sequences": False,
                    "batch_input_shape": [None, None, 3]}},
        _dense("fc", 2, "softmax")]), {
        "l": _lstm12(r, "l", 3, 4),
        "fc": [("fc_W", _f32(r, 4, 2)), ("fc_b", _f32(r, 2))]})
    return "seq", [_f32(r, 2, 5, 3), _f32(r, 2, 9, 3)]


def form_batchnorm(p, r):
    write_keras_file(p, seq_config([
        {"class_name": "BatchNormalization",
         "config": {"name": "bn", "epsilon": 1e-5, "mode": 0,
                    "batch_input_shape": [None, 6]}},
        _dense("fc", 2, "softmax")]), {
        "bn": [("bn_gamma", r.rand(6).astype(np.float32) + 0.5),
               ("bn_beta", _f32(r, 6)), ("bn_mean", _f32(r, 6)),
               ("bn_var", r.rand(6).astype(np.float32) + 0.5)],
        "fc": [("fc_W", _f32(r, 6, 2)), ("fc_b", _f32(r, 2))]})
    return "seq", [_f32(r, 5, 6)]


def form_embedding(p, r):
    write_keras_file(p, seq_config([
        {"class_name": "Embedding",
         "config": {"name": "emb", "input_dim": 300, "output_dim": 6,
                    "batch_input_shape": [None, 1]}},
        _dense("fc", 3, "softmax")]), {
        "emb": [("emb_W", _f32(r, 300, 6))],
        "fc": [("fc_W", _f32(r, 6, 3)), ("fc_b", _f32(r, 3))]})
    return "seq", [r.randint(0, 300, (5, 1)).astype(np.float32)]


def _residual_model(units_key, merge, node):
    def inbound(*names):
        return [[[n, 0, 0] + node for n in names]]
    return {"class_name": "Model", "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "input_1",
             "config": {"name": "input_1", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "d1",
             "config": {"name": "d1", units_key: 4, "activation": "relu"},
             "inbound_nodes": inbound("input_1")},
            {"class_name": "Dense", "name": "d2",
             "config": {"name": "d2", units_key: 4, "activation": "linear"},
             "inbound_nodes": inbound("d1")},
            merge,
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", units_key: 2,
                        "activation": "softmax"},
             "inbound_nodes": inbound("add")}],
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}


def _residual_weights(r, w1, b1):
    return {"d1": [(w1, _f32(r, 4, 4)), (b1, _f32(r, 4))],
            "d2": [(w1, _f32(r, 4, 4)), (b1, _f32(r, 4))],
            "out": [(w1, _f32(r, 4, 2)), (b1, _f32(r, 2))]}


def form_functional_sum(p, r):
    mc = _residual_model("output_dim", {
        "class_name": "Merge", "name": "add",
        "config": {"name": "add", "mode": "sum"},
        "inbound_nodes": [[["d1", 0, 0], ["d2", 0, 0]]]}, [])
    w = _residual_weights(r, "W", "b")
    write_keras_file(p, mc, {k: [(f"{k}_{n}", a) for n, a in v]
                             for k, v in w.items()},
                     training_config={"loss": "categorical_crossentropy"})
    return "model", [_f32(r, 6, 4)]


def form_k2_functional_add(p, r):
    mc = _residual_model("units", {
        "class_name": "Add", "name": "add", "config": {"name": "add"},
        "inbound_nodes": [[["d1", 0, 0, {}], ["d2", 0, 0, {}]]]}, [{}])
    write_k2(p, mc, _residual_weights(r, "kernel", "bias"),
             training_config={"loss": "categorical_crossentropy"})
    return "model", [_f32(r, 6, 4)]


def form_functional_activation_head(p, r):
    mc = {"class_name": "Model", "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "input_1",
             "config": {"name": "input_1", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "logits",
             "config": {"name": "logits", "output_dim": 3,
                        "activation": "linear"},
             "inbound_nodes": [[["input_1", 0, 0]]]},
            {"class_name": "Activation", "name": "probs",
             "config": {"name": "probs", "activation": "softmax"},
             "inbound_nodes": [[["logits", 0, 0]]]}],
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["probs", 0, 0]]}}
    write_keras_file(p, mc, {"logits": [("logits_W", _f32(r, 4, 3)),
                                        ("logits_b", _f32(r, 3))]},
                     training_config={"loss": "categorical_crossentropy"})
    return "model", [_f32(r, 5, 4)]


def form_sequential_via_model_entry(p, r):
    write_keras_file(p, seq_config([
        _dense("d", 2, "softmax", batch_input_shape=[None, 3])]),
        {"d": [("d_W", _f32(r, 3, 2)), ("d_b", np.zeros(2, np.float32))]})
    return "model", [_f32(r, 2, 3)]


def form_unknown_loss_nonstrict(p, r):
    write_keras_file(p, seq_config([
        _dense("d", 2, "softmax", batch_input_shape=[None, 3])]),
        {"d": [("W", _f32(r, 3, 2)), ("b", np.zeros(2, np.float32))]},
        training_config={"loss": "sparse_categorical_crossentropy"})
    return "seq", [_f32(r, 2, 3)]


def form_k2_mlp_dropout(p, r):
    write_k2(p, {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Dense",
         "config": {"name": "dense_1", "units": 8, "activation": "relu",
                    "batch_input_shape": [None, 4]}},
        {"class_name": "Dropout", "config": {"name": "drop", "rate": 0.25}},
        {"class_name": "Dense",
         "config": {"name": "dense_2", "units": 3,
                    "activation": "softmax"}}]}}, {
        "dense_1": [("kernel", _f32(r, 4, 8)), ("bias", _f32(r, 8))],
        "drop": [],
        "dense_2": [("kernel", _f32(r, 8, 3)), ("bias", _f32(r, 3))]},
        training_config={"loss": "categorical_crossentropy"})
    return "seq", [_f32(r, 5, 4)]


def form_k2_conv(p, r):
    write_k2(p, {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Conv2D",
         "config": {"name": "conv", "filters": 2, "kernel_size": [3, 3],
                    "strides": [1, 1], "padding": "same",
                    "data_format": "channels_last", "activation": "relu",
                    "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "AveragePooling2D",
         "config": {"name": "pool", "pool_size": [2, 2], "strides": [2, 2],
                    "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense",
         "config": {"name": "dense", "units": 4,
                    "activation": "softmax"}}]}}, {
        "conv": [("kernel", _f32(r, 3, 3, 1, 2)), ("bias", _f32(r, 2))],
        "pool": [], "flat": [],
        "dense": [("kernel", _f32(r, 32, 4)), ("bias", _f32(r, 4))]})
    return "seq", [_f32(r, 3, 8, 8, 1)]


def form_k2_lstm_packed(p, r):
    write_k2(p, {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "LSTM",
         "config": {"name": "lstm", "units": 6, "activation": "tanh",
                    "recurrent_activation": "sigmoid",
                    "return_sequences": False,
                    "batch_input_shape": [None, 7, 4]}},
        {"class_name": "Dense",
         "config": {"name": "dense", "units": 3,
                    "activation": "softmax"}}]}}, {
        "lstm": [("kernel", _f32(r, 4, 24, scale=0.5)),
                 ("recurrent_kernel", _f32(r, 6, 24, scale=0.5)),
                 ("bias", _f32(r, 24, scale=0.1))],
        "dense": [("kernel", _f32(r, 6, 3)), ("bias", _f32(r, 3))]})
    return "seq", [_f32(r, 2, 7, 4)]


def form_k2_bidirectional(p, r):
    f, u, t = 3, 5, 7
    write_k2(p, {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Bidirectional",
         "config": {"name": "bidi", "merge_mode": "concat",
                    "batch_input_shape": [None, t, f],
                    "layer": {"class_name": "LSTM",
                              "config": {"units": u, "activation": "tanh",
                                         "recurrent_activation": "sigmoid",
                                         "return_sequences": True}}}},
        {"class_name": "TimeDistributedDense",
         "config": {"name": "dense", "output_dim": 3,
                    "activation": "linear"}}]}}, {
        "bidi": [(f"{d}_lstm/{n}", _f32(r, *s, scale=0.5))
                 for d in ("forward", "backward")
                 for n, s in (("kernel", (f, 4 * u)),
                              ("recurrent_kernel", (u, 4 * u)),
                              ("bias", (4 * u,)))],
        "dense": [("kernel", _f32(r, 2 * u, 3)), ("bias", _f32(r, 3))]})
    return "seq", [_f32(r, 2, t, f)]


FORMS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("form_")}


def _leaf_trees(net):
    if hasattr(net, "params_map"):
        return net.params_map, net.states_map
    return dict(enumerate(net.params_list)), dict(enumerate(net.states_list))


def _assert_bitwise(pnet, jnet):
    (pp, ps), (jp, js) = _leaf_trees(pnet), _leaf_trees(jnet)
    assert set(pp) == set(jp)
    for name in jp:
        for tree_p, tree_j in ((pp[name], jp[name]), (ps[name], js[name])):
            assert set(tree_p) == set(tree_j), name
            for k, v in tree_j.items():
                got = tree_p[k].detach().cpu().numpy()
                want = np.asarray(v)
                assert got.dtype == want.dtype == np.float32, (name, k)
                np.testing.assert_array_equal(got, want, err_msg=f"{name}.{k}")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL * scale, what


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fixture_form_imports_alike(tmp_path, form):
    r = np.random.RandomState(sorted(FORMS).index(form))
    path = str(tmp_path / f"{form}.h5")
    entry, xs = FORMS[form](path, r)
    if entry == "seq":
        jnet = jk.import_keras_sequential_model_and_weights(path)
        pnet = pk.import_keras_sequential_model_and_weights(path,
                                                            device="cpu")
    else:
        jnet = jk.import_keras_model_and_weights(path)
        pnet = KerasModelImport.import_keras_model_and_weights(
            path, device="cpu")
    assert type(pnet).__name__ == type(jnet).__name__
    assert pnet.conf.to_json() == jnet.conf.to_json()
    _assert_bitwise(pnet, jnet)
    np.testing.assert_array_equal(pnet.params(), np.asarray(jnet.params()))
    for i, x in enumerate(xs):
        _close(pnet.output(x), np.asarray(jnet.output(x)), f"output {i}")


def _error_forms():
    def shared(p, r):
        write_keras_file(p, {"class_name": "Model", "config": {
            "layers": [
                {"class_name": "InputLayer", "name": "input_1",
                 "config": {"name": "input_1",
                            "batch_input_shape": [None, 4]},
                 "inbound_nodes": []},
                {"class_name": "InputLayer", "name": "input_2",
                 "config": {"name": "input_2",
                            "batch_input_shape": [None, 4]},
                 "inbound_nodes": []},
                {"class_name": "Dense", "name": "shared",
                 "config": {"name": "shared", "output_dim": 2,
                            "activation": "softmax"},
                 "inbound_nodes": [[["input_1", 0, 0]],
                                   [["input_2", 0, 0]]]}],
            "input_layers": [["input_1", 0, 0], ["input_2", 0, 0]],
            "output_layers": [["shared", 0, 0]]}},
            {"shared": [("s_W", np.zeros((4, 2))), ("s_b", np.zeros(2))]})
        return "model", "shared"

    def border_full(p, r):
        write_keras_file(p, seq_config([
            {"class_name": "Convolution2D",
             "config": {"name": "c", "nb_filter": 2, "nb_row": 3,
                        "nb_col": 3, "border_mode": "full",
                        "dim_ordering": "tf",
                        "batch_input_shape": [None, 8, 8, 1]}}]), {})
        return "seq", "border_mode"

    def unsupported_class(p, r):
        write_keras_file(p, seq_config([
            {"class_name": "Wibble",
             "config": {"name": "w", "batch_input_shape": [None, 3]}}]), {})
        return "seq", "Wibble"

    def missing_model_config(p, r):
        with h5py.File(p, "w") as f:
            f.create_group("model_weights")
        return "seq", "model_config"

    def shape_mismatch(p, r):
        write_keras_file(p, seq_config([
            _dense("d", 2, "softmax", batch_input_shape=[None, 3])]),
            {"d": [("d_W", r.randn(5, 2)), ("d_b", np.zeros(2))]})
        return "seq", "mismatch"

    def strict_unknown_loss(p, r):
        write_keras_file(p, seq_config([
            _dense("d", 2, "softmax", batch_input_shape=[None, 3])]),
            {"d": [("W", r.randn(3, 2)), ("b", np.zeros(2))]},
            training_config={"loss": "sparse_categorical_crossentropy"})
        return "strict", "loss"

    def bidirectional_last_step(p, r):
        write_k2(p, {"class_name": "Sequential", "config": {"layers": [
            {"class_name": "Bidirectional",
             "config": {"name": "bidi", "merge_mode": "concat",
                        "batch_input_shape": [None, 4, 3],
                        "layer": {"class_name": "LSTM",
                                  "config": {"units": 4,
                                             "return_sequences": False}}}}
        ]}}, {"bidi": []})
        return "seq", "return_sequences=False"

    def not_a_file(p, r):
        with open(p, "wb") as f:
            f.write(b"definitely not hdf5")
        return "seq", None

    def sequential_entry_on_model(p, r):
        form_functional_sum(p, r)
        return "seq", "Not a Sequential"

    return {fn.__name__: fn for fn in (
        shared, border_full, unsupported_class, missing_model_config,
        shape_mismatch, strict_unknown_loss, bidirectional_last_step,
        not_a_file, sequential_entry_on_model)}


ERROR_FORMS = _error_forms()


def _raised(fn, path, kind, **kw):
    try:
        if kind == "model":
            fn.import_keras_model_and_weights(path, **kw)
        else:
            fn.import_keras_sequential_model_and_weights(
                path, enforce_training_config=kind == "strict", **kw)
    except Exception as e:
        return e
    raise AssertionError(f"{fn.__name__} imported {path}")


@pytest.mark.parametrize("form", sorted(ERROR_FORMS))
def test_error_form_raises_alike(tmp_path, form):
    path = str(tmp_path / f"{form}.h5")
    kind, match = ERROR_FORMS[form](path, np.random.RandomState(0))
    jerr = _raised(jk, path, kind)
    perr = _raised(pk, path, kind, device="cpu")
    assert type(perr).__name__ == type(jerr).__name__
    assert isinstance(perr, ValueError) == isinstance(jerr, ValueError)
    if match is not None:
        assert match in str(perr) and match in str(jerr)


def test_import_needs_no_h5py(tmp_path, monkeypatch):
    """The package's reader is the real path: with h5py unimportable, a
    file the reader takes imports, and one it rejects raises the reader's
    own error (``_h5_fallback`` has nothing to retry with)."""
    import builtins
    path = str(tmp_path / "m.h5")
    _, (x,) = form_mlp(path, np.random.RandomState(0))
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"definitely not hdf5")
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("h5py blocked for this test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    net = pk.import_keras_sequential_model_and_weights(path, device="cpu")
    assert net.output(x).shape == (5, 3)
    with pytest.raises(pk.H5Error, match="not an HDF5 file"):
        pk.import_keras_sequential_model_and_weights(str(bad), device="cpu")


def test_weights_land_in_the_nets_own_tensors(tmp_path):
    """Import writes into the tensors ``init()`` made (in place), so the
    leaves a captured graph or an optimizer holds stay the net's."""
    path = str(tmp_path / "bn.h5")
    form_batchnorm(path, np.random.RandomState(1))
    from deeplearning4j_tpu_torch.models import multi_layer_network as mln
    made = []
    real_init = mln.MultiLayerNetwork.init

    def spy(self, *a, **kw):
        out = real_init(self, *a, **kw)
        made.append([dict(p) for p in self.params_list] +
                    [dict(s) for s in self.states_list])
        return out

    mln.MultiLayerNetwork.init = spy
    try:
        net = pk.import_keras_sequential_model_and_weights(path,
                                                           device="cpu")
    finally:
        mln.MultiLayerNetwork.init = real_init
    now = [dict(p) for p in net.params_list] + \
        [dict(s) for s in net.states_list]
    for before, after in zip(made[0], now):
        for k in before:
            assert before[k] is after[k]
    assert not torch.equal(net.states_list[0]["mean"], torch.zeros(6))


def test_last_time_step_pre_padded_mask():
    from deeplearning4j_tpu_torch.nn.layers import LastTimeStepLayer
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    mask = torch.tensor([[0, 1, 1], [1, 1, 0]], dtype=torch.float32)
    out, _ = LastTimeStepLayer().forward({}, x, {}, mask=mask)
    assert torch.equal(out[0], x[0, 2]) and torch.equal(out[1], x[1, 1])


def test_training_config_loss_mapped():
    assert json.dumps(pk.LOSSES, sort_keys=True) == \
        json.dumps(jk.LOSSES, sort_keys=True)
    assert pk.ACTIVATIONS == jk.ACTIVATIONS


FIXTURES = Path(__file__).resolve().parent / "fixtures" / "keras"
MNIST = Path(__file__).resolve().parent / "fixtures" / "real_mnist"


def _fixture_input(name, r):
    if name.startswith("lenet"):
        from deeplearning4j_tpu_torch.datasets.fetchers import \
            MnistDataSetIterator
        return MnistDataSetIterator(64, train=False,
                                    data_dir=str(MNIST)).features
    if name.startswith("residual"):
        return r.randn(6, 8, 8, 4).astype(np.float32)
    return np.eye(65, dtype=np.float32)[r.randint(0, 65, (4, 50))]


@pytest.mark.parametrize("name", ["lenet_k1_tf.h5", "residual_k1_th.h5",
                                  "lstm_k2_charrnn.h5"])
def test_committed_fixture_imports_alike(name):
    """The committed files (``tests/fixtures/keras/make_keras_fixtures.py``)
    through both packages' functional entry point: parameters and state
    bitwise, outputs within 1e-5 of their scale."""
    path = str(FIXTURES / name)
    jnet = jk.import_keras_model_and_weights(path)
    pnet = pk.import_keras_model_and_weights(path, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    _assert_bitwise(pnet, jnet)
    x = _fixture_input(name, np.random.RandomState(0))
    _close(pnet.output(x), np.asarray(jnet.output(x)), name)


def test_committed_lenet_accuracy_and_zoo_equality():
    """The committed LeNet holds at least 0.90 on the fixture's held-out
    digits with no training, and its output equals a zoo-built
    ``lenet_mnist`` net given the same parameters, bit for bit."""
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = pk.import_keras_sequential_model_and_weights(
        str(FIXTURES / "lenet_k1_tf.h5"), device="cpu")
    assert net.num_params() == 431080
    test = MnistDataSetIterator(64, train=False, data_dir=str(MNIST))
    out = net.output(test.features)
    assert float((out.argmax(1) == test.label_ids).mean()) >= 0.90
    z = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    z.set_params(net.params())
    np.testing.assert_array_equal(z.output(test.features), out)
