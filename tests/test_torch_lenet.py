"""The port's LeNet path against the JAX package's, on the CPU: the zoo
configuration, the forward from JAX-initialised parameters, training
steps on real MNIST digits (``tests/fixtures/real_mnist``), the fused
loop against the per-batch loop, the BatchNormalization gate, and the
MNIST iterator.

Tolerances, with their reasons:
- outputs (probabilities) and activations: 1e-5 of each array's max abs
  (the same formulas in f32; summation order only);
- training: parameters and updater state within 1e-5 of each leaf's max
  abs after every step, scores 1e-5 relative, as ``test_torch_mln.py``
  holds its fits;
- the port's fused loop against its per-batch loop: bitwise (the same CPU
  ops on the same rows);
- the iterator: the reference's arrays bitwise, except the features
  against the reference's iterator where its native decoder scales by
  1/255 in place of dividing: there within one float32 step (6e-8).
"""

import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import (
    DataSet as JDataSet, ListDataSetIterator as JListIterator)
from deeplearning4j_tpu.datasets.fetchers import (
    MnistDataSetIterator as JMnist, read_idx as jread_idx)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models._device_state import (
    fuse_allowed as jfuse_allowed)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.fetchers import (MnistDataSetIterator,
                                                        read_idx)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "real_mnist")
REL = 1e-5


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.array(tree)


def _assert_close(got, want, what="", rel=REL):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}.{k}", rel)
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def narrow_lenet(bn=False, seed=12345):
    """LeNet's shape at 12x12: conv 3x3x4, max-pool 2, conv 3x3x6, max-pool
    2, dense 16, softmax 10, built by the JAX package's builder. With
    ``bn`` a BatchNormalization follows each conv, which then has no bias
    (BN's beta takes its place) and a relu: with the identity, the first
    BN's beta would shift the second BN's input by a constant per
    channel, which it removes, so neither a conv bias nor that beta would
    get more than rounding noise as its gradient."""
    b = (JBuilder.Builder().seed(seed).learning_rate(0.01)
         .updater("nesterovs").momentum(0.9).weight_init("xavier")
         .activation("identity").list())
    for n in (4, 6):
        b = b.layer(jlayers.ConvolutionLayer(n_out=n, kernel_size=(3, 3),
                                             activation="relu" if bn
                                             else "identity",
                                             has_bias=not bn))
        if bn:
            b = b.layer(jlayers.BatchNormalization())
        b = b.layer(jlayers.SubsamplingLayer(pooling_type="max",
                                             kernel_size=(2, 2),
                                             stride=(2, 2)))
    return (b.layer(jlayers.DenseLayer(n_out=16, activation="relu"))
            .layer(jlayers.OutputLayer(n_out=10, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(JInputType.convolutional(12, 12, 1)).build())


def _pair(jconf):
    """A JAX net and the port's net from its JSON, with its parameters."""
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    return jnet, pnet


def _digits(n, size=28, train=True):
    """``n`` real digits and their one-hot labels, center-cropped to
    ``size``."""
    it = MnistDataSetIterator(n, train=train, data_dir=FIXTURE)
    lo = (28 - size) // 2
    return (np.ascontiguousarray(it.features[:n, lo:lo + size,
                                             lo:lo + size]),
            it.labels[:n])


CONFS = {"narrow": (narrow_lenet, 12), "full": (jzoo.lenet_mnist, 28)}


def test_lenet_json_equals_jax():
    jconf, pconf = jzoo.lenet_mnist(), zoo.lenet_mnist()
    assert pconf.to_json() == jconf.to_json()
    again = MultiLayerConfiguration.from_json(jconf.to_json())
    assert again.to_json() == jconf.to_json()
    assert [type(p).__name__ for _, p in sorted(
        pconf.input_preprocessors.items())] == \
        ["CnnToFeedForwardPreProcessor"]
    net = MultiLayerNetwork(pconf, device="cpu").init()
    assert net.num_params() == 431080
    assert [tuple(p["W"].shape) for p in net.params_list if p] == \
        [(5, 5, 1, 20), (5, 5, 20, 50), (800, 500), (500, 10)]


@pytest.mark.parametrize("name", sorted(CONFS))
def test_forward_matches_jax_from_jax_parameters(name):
    build, size = CONFS[name]
    jnet, pnet = _pair(build())
    x, _ = _digits(16, size)
    # JAX's feed_forward runs op by op; one jitted program compiles faster
    acts = jax.jit(lambda p, s, a: jnet._forward_layers(
        p, s, a, train=False, rngs=None, fmask=None)[0])
    want = [np.asarray(a) for a in acts(jnet.params_list, jnet.states_list,
                                        jnp.asarray(x))]
    got = pnet.feed_forward(x)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, f"activation {i}")
    _assert_close(pnet.output(x), np.asarray(jnet.output(x)), "output")


@pytest.mark.parametrize("name", sorted(CONFS))
def test_three_fit_steps_match_jax(name):
    build, size = CONFS[name]
    jnet, pnet = _pair(build())
    x, y = _digits(48, size)
    for step in range(3):
        xs, ys = x[16 * step:16 * (step + 1)], y[16 * step:16 * (step + 1)]
        js = float(jnet.fit_batch(xs, ys))
        ps = float(pnet.fit_batch(xs, ys))
        assert abs(ps - js) <= REL * abs(js), (step, ps, js)
        for i, (pp, jp) in enumerate(zip(pnet.params_list, jnet.params_list)):
            _assert_close(pp, jp, f"step {step} layer {i}")
        for i, (pu, ju) in enumerate(zip(pnet.updater_states,
                                         jnet.updater_states)):
            _assert_close(pu, ju, f"step {step} updater {i}")
    assert pnet.iteration == jnet.iteration == 3


def test_evaluate_on_held_out_digits_matches_jax():
    """``evaluate`` of an NHWC image iterator: the same confusion matrix
    as the JAX net's from the same parameters."""
    jnet, pnet = _pair(jzoo.lenet_mnist())
    want = jnet.evaluate(JMnist(16, train=False, data_dir=FIXTURE))
    got = pnet.evaluate(MnistDataSetIterator(16, train=False,
                                             data_dir=FIXTURE))
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
    assert got.accuracy() == want.accuracy()


def _batches(n, rows=8, ragged=3, size=12):
    x, y = _digits(n * rows + ragged, size)
    out = [(x[i * rows:(i + 1) * rows], y[i * rows:(i + 1) * rows])
           for i in range(n)]
    return out + [(x[n * rows:], y[n * rows:])]


def _fit_port(jconf, batches, monkeypatch, k, epochs=1):
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
    _, net = _pair(jconf)
    net.fit(ListDataSetIterator([DataSet(a, b) for a, b in batches]),
            epochs=epochs)
    return net


def test_fused_fit_equals_per_batch_bitwise(monkeypatch):
    """Five full batches and a ragged one, K 4: a group of 4, then a group
    of the last full batch and the row-padded ragged one (padding step
    and rows weigh 0), against K 1."""
    batches = _batches(5)
    fused = _fit_port(narrow_lenet(), batches, monkeypatch, 4, epochs=2)
    plain = _fit_port(narrow_lenet(), batches, monkeypatch, 1, epochs=2)
    assert fused._last_fuse_stats["fused_groups"] >= 2
    assert plain._fused is None
    assert fused.iteration == plain.iteration == 12
    np.testing.assert_array_equal(fused.params(), plain.params())
    for a, b in zip(fused.updater_states, plain.updater_states):
        for key in a:
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name])


def test_fused_fit_matches_jax_fused_fit(monkeypatch):
    batches = _batches(5, ragged=0)[:-1]
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", "4")
    jnet, _ = _pair(narrow_lenet())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet.fit(JListIterator([JDataSet(a, b) for a, b in batches]))
    pnet = _fit_port(narrow_lenet(), batches, monkeypatch, 4)
    assert pnet._last_fuse_stats["fused_groups"] == 2
    for i, (pp, jp) in enumerate(zip(pnet.params_list, jnet.params_list)):
        _assert_close(pp, jp, f"layer {i}")
    _assert_close(pnet.params(), np.asarray(jnet.params()), "vector")


def test_batch_norm_model_is_declined_and_trains_as_jax(monkeypatch):
    """Both packages' gates decline a BatchNormalization model; it trains
    per batch through ``fit`` and matches the JAX net, running moments
    included."""
    jconf = narrow_lenet(bn=True)
    jnet, pnet = _pair(jconf)
    assert not jfuse_allowed(jconf, jconf.layers)
    assert not fuse_allowed(pnet.conf, pnet.layers)
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "4")
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", "4")
    batches = _batches(3)
    pnet.fit(ListDataSetIterator([DataSet(a, b) for a, b in batches]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet.fit(JListIterator([JDataSet(a, b) for a, b in batches]))
    assert pnet._fused is None
    assert pnet._last_fuse_stats["fused_groups"] == 0
    assert pnet.iteration == jnet.iteration == 4
    for i, (pp, jp) in enumerate(zip(pnet.params_list, jnet.params_list)):
        _assert_close(pp, jp, f"layer {i}")
    for i, (ps, js) in enumerate(zip(pnet.states_list, jnet.states_list)):
        _assert_close(ps, js, f"state {i}")
    x, _ = _digits(8, 12, train=False)
    _assert_close(pnet.output(x), np.asarray(jnet.output(x)), "output")


ITER_CASES = {
    "fixture": dict(),
    "shuffled": dict(shuffle=True, seed=5),
    "first_100_binarized": dict(num_examples=100, binarize=True),
    "test_split_flat": dict(train=False, flatten=True),
}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_mnist_iterator_yields_the_reference_arrays(case):
    kw = ITER_CASES[case]
    want = JMnist(64, data_dir=FIXTURE, **kw)
    got = MnistDataSetIterator(64, data_dir=FIXTURE, **kw)
    assert not got.synthetic
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.label_ids, want.label_ids)
    np.testing.assert_allclose(got.features, want.features, rtol=0,
                               atol=6e-8)
    # the reference's documented arithmetic, bitwise
    prefix = "t10k" if kw.get("train") is False else "train"
    raw = jread_idx(os.path.join(FIXTURE, f"{prefix}-images-idx3-ubyte"))
    np.testing.assert_array_equal(read_idx(os.path.join(
        FIXTURE, f"{prefix}-images-idx3-ubyte")), raw)
    ref = raw.astype(np.float32) / 255.0
    if kw.get("num_examples"):
        ref = ref[:kw["num_examples"]]
    if kw.get("binarize"):
        ref = (ref > 0.5).astype(np.float32)
    if kw.get("shuffle"):
        ref = ref[np.random.RandomState(kw["seed"]).permutation(len(ref))]
    np.testing.assert_array_equal(got.features.reshape(ref.shape), ref)
    batches = list(got)
    assert [len(b.features) for b in batches] == \
        [min(64, len(ref) - i) for i in range(0, len(ref), 64)]


def test_mnist_iterator_searches_the_data_dir_knob(monkeypatch, tmp_path):
    shutil.copytree(FIXTURE, tmp_path / "mnist")
    monkeypatch.setenv("DL4J_TORCH_DATA_DIR", str(tmp_path))
    it = MnistDataSetIterator(32, num_examples=50)
    assert not it.synthetic
    np.testing.assert_array_equal(
        it.labels, MnistDataSetIterator(32, num_examples=50,
                                        data_dir=FIXTURE).labels)
    with pytest.raises(FileNotFoundError, match="idx files"):
        MnistDataSetIterator(32, data_dir=str(tmp_path))


def test_synthetic_stand_in_is_the_reference_s(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TORCH_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = MnistDataSetIterator(16, num_examples=40, shuffle=True, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JMnist(16, num_examples=40, shuffle=True, seed=3)
    if not want.synthetic:
        pytest.skip("the JAX package found an installed MNIST")
    assert got.synthetic
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
