"""The port's helper seam (``nn/helpers.py``) against the reference's
contracts (``deeplearning4j_tpu/nn/helpers.py``, ``tests/test_helpers_seam.py``,
``tests/test_pallas.py::TestHelperSeam``), with the port's one
difference: a helper that raises propagates its error (the reference's
``test_failing_helper_falls_back`` and ``test_broken_helper_falls_back``
fall back instead); only a ``supports()`` decline takes the built-in
path, and it is counted.

Tolerances: the im2col route is held bitwise to the patch-gather GEMM the
port's ConvolutionLayer ran before the seam (the same ops in the same
order), and to ``F.conv2d`` and the JAX layer within 1e-5 of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.layers import LSTM as JLSTM
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.layers import (LSTM, ConvolutionLayer,
                                                GravesBidirectionalLSTM,
                                                GravesLSTM,
                                                SelfAttentionLayer,
                                                layer_from_dict)

LAYERS = {"SelfAttentionLayer": helpers.FlashAttentionHelper,
          "ConvolutionLayer": helpers.Im2ColConvolutionHelper,
          "LSTM": helpers.AcceleratedLSTMHelper,
          "GravesLSTM": helpers.AcceleratedLSTMHelper,
          "GravesBidirectionalLSTM": helpers.AcceleratedLSTMHelper}


@pytest.fixture
def restore_registry():
    saved = dict(helpers._REGISTRY)
    yield
    helpers._REGISTRY.clear()
    helpers._REGISTRY.update(saved)


def _instance(name):
    return {"SelfAttentionLayer": SelfAttentionLayer(n_in=4, n_out=4),
            "ConvolutionLayer": ConvolutionLayer(n_in=1, n_out=2),
            "LSTM": LSTM(n_in=2, n_out=2),
            "GravesLSTM": GravesLSTM(n_in=2, n_out=2),
            "GravesBidirectionalLSTM": GravesBidirectionalLSTM(n_in=2,
                                                               n_out=2)}[name]


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_registry_answers_as_the_reference(name, monkeypatch):
    """``get_helper`` gives each layer class the same kind of helper as
    the reference's registry, and none under DL4J_TPU_DISABLE_HELPERS."""
    layer = _instance(name)
    assert type(jhelpers._REGISTRY[name]).__name__ == LAYERS[name].__name__
    assert isinstance(helpers.get_helper(layer), LAYERS[name])
    monkeypatch.setenv("DL4J_TPU_DISABLE_HELPERS", "1")
    assert helpers.get_helper(layer) is None


def test_register_and_unregister(restore_registry):
    layer = SelfAttentionLayer(n_in=4, n_out=4)
    spy = helpers.LayerHelper()
    assert helpers.register_helper("SelfAttentionLayer", spy) is spy
    assert helpers.get_helper(layer) is spy
    helpers.unregister_helper("SelfAttentionLayer")
    assert helpers.get_helper(layer) is None
    helpers.unregister_helper("SelfAttentionLayer")      # idempotent


def test_flash_helper_declines_a_mask_and_cpu_tensors():
    layer = SelfAttentionLayer(n_in=4, n_out=4)
    h = helpers.FlashAttentionHelper()
    meta = torch.zeros(1, 1, 4, 4, device="meta")
    assert not h.supports(layer, mask=torch.ones(1, 4), q=meta)
    assert not h.supports(layer, mask=None, q=torch.zeros(1, 1, 4, 4))
    assert not h.supports(layer, mask=None)
    # the reference declines a mask too
    jl = jhelpers.FlashAttentionHelper()
    assert not jl.supports(None, mask=jnp.ones((1, 4)))


def _lenet_conv_params(seed=0):
    r = np.random.RandomState(seed)
    return {"W": torch.tensor(0.2 * r.randn(5, 5, 1, 20), dtype=torch.float32),
            "b": torch.tensor(0.1 * r.randn(20), dtype=torch.float32)}


def _patch_gemm(params, x):
    """The port's ConvolutionLayer im2col route as it stood before the
    seam (5x5, stride 1, no padding)."""
    patches = x.unfold(1, 5, 1).unfold(2, 5, 1)
    b, oh, ow, c = patches.shape[:4]
    cols = patches.reshape(b * oh * ow, c * 25)
    wmat = params["W"].permute(2, 0, 1, 3).reshape(c * 25, 20)
    return (cols @ wmat).reshape(b, oh, ow, 20) + params["b"]


def test_im2col_route_unchanged_for_lenet(restore_registry, monkeypatch):
    """LeNet's first conv takes the helper (bitwise the pre-seam route),
    its second is declined and counted; DL4J_TPU_DISABLE_HELPERS sends
    the first to ``F.conv2d``, within 1e-5 of the scale."""
    conf = zoo.lenet_mnist()
    first, second = conf.layers[0], conf.layers[2]
    assert first.uses_im2col() and not second.uses_im2col()

    class Spy(helpers.Im2ColConvolutionHelper):
        calls = 0

        def pre_output(self, *a, **kw):
            Spy.calls += 1
            return super().pre_output(*a, **kw)

    helpers.register_helper("ConvolutionLayer", Spy())
    params = _lenet_conv_params()
    x = torch.rand(3, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    got = first.pre_output(params, x)
    assert Spy.calls == 1
    assert torch.equal(got, _patch_gemm(params, x))
    before = helpers.declines("ConvolutionLayer")
    p2 = {"W": torch.zeros(5, 5, 20, 50), "b": torch.zeros(50)}
    second.pre_output(p2, torch.zeros(1, 12, 12, 20))
    assert Spy.calls == 1
    assert helpers.declines("ConvolutionLayer") == before + 1
    monkeypatch.setenv("DL4J_TPU_DISABLE_HELPERS", "1")
    direct = first.pre_output(params, x)
    assert Spy.calls == 1
    scale = got.abs().max()
    assert (direct - got).abs().max() <= 1e-5 * scale


def test_im2col_helper_matches_jax_helper():
    """The port's helper against the reference's on a bias-free 'same'
    conv over 3 channels (padding on both sides)."""
    from deeplearning4j_tpu.nn.layers.conv import ConvolutionLayer as JConv
    r = np.random.RandomState(2)
    jl = JConv(n_in=3, n_out=4, kernel_size=(3, 3), stride=(2, 2),
               convolution_mode="same", has_bias=False)
    pl = layer_from_dict(jl.to_dict())
    w = r.randn(3, 3, 3, 4).astype(np.float32)
    x = r.randn(2, 7, 8, 3).astype(np.float32)
    want = np.asarray(jhelpers.Im2ColConvolutionHelper().pre_output(
        jl, {"W": jnp.asarray(w)}, jnp.asarray(x)))
    got = helpers.Im2ColConvolutionHelper().pre_output(
        pl, {"W": torch.tensor(w)}, torch.tensor(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_lenet_fit_takes_the_helper_once_per_forward(restore_registry):
    """An unchanged LeNet run (fused fit on the CPU) goes through the im2col
    helper for its first conv, as PR 8's route did."""
    calls = []

    class Spy(helpers.Im2ColConvolutionHelper):
        def pre_output(self, layer, *a, **kw):
            calls.append(layer.n_in)
            return super().pre_output(layer, *a, **kw)

    helpers.register_helper("ConvolutionLayer", Spy())
    net = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    r = np.random.RandomState(0)
    x = r.rand(4, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 4)]
    net.fit(ListDataSetIterator([DataSet(x, y)] * 2))
    net.output(x)
    assert calls == [1, 1, 1]


class _Raising(helpers.LayerHelper):
    def supports(self, layer, **ctx):
        return True

    def attention(self, *a, **kw):
        raise RuntimeError("helper exploded")

    pre_output = scan = attention


def test_broken_helper_falls_back(restore_registry):
    """The reference's test of the same name asserts a fallback; in the
    port the attention helper's error propagates."""
    helpers.register_helper("SelfAttentionLayer", _Raising())
    layer = SelfAttentionLayer(n_in=4, n_out=4).apply_global_defaults({})
    params = {k: torch.zeros(s) for k, s in layer.param_shapes().items()}
    with pytest.raises(RuntimeError, match="helper exploded"):
        layer.forward(params, torch.zeros(1, 8, 4), {})


def test_failing_helper_falls_back(restore_registry):
    """The reference's test of the same name asserts a fallback; in the
    port the conv helper's error propagates."""
    helpers.register_helper("ConvolutionLayer", _Raising())
    layer = ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 3))
    params = {"W": torch.zeros(3, 3, 3, 4), "b": torch.zeros(4)}
    with pytest.raises(RuntimeError, match="helper exploded"):
        layer.pre_output(params, torch.zeros(2, 8, 8, 3))


def test_failing_lstm_helper_raises(restore_registry):
    helpers.register_helper("LSTM", _Raising())
    layer = LSTM(n_in=2, n_out=3, gate_activation="hardsigmoid")
    params = {k: torch.zeros(s) for k, s in layer.param_shapes().items()}
    with pytest.raises(RuntimeError, match="helper exploded"):
        layer.forward(params, torch.zeros(1, 9, 2), {})


def _lstm_case(seq_len, seed=0):
    r = np.random.RandomState(seed)
    jl = JLSTM(n_in=4, n_out=6, gate_activation="hardsigmoid",
               activation="tanh")
    pl = layer_from_dict(jl.to_dict())
    shapes = pl.param_shapes()
    params = {k: (0.5 * r.randn(*s)).astype(np.float32)
              for k, s in shapes.items()}
    x = r.randn(2, seq_len, 4).astype(np.float32)
    return jl, pl, params, x


@pytest.mark.parametrize("seq_len", [12, 4])
def test_lstm_helper_scan_matches_jax_helper(seq_len):
    """A hard-sigmoid LSTM (no kernel route) goes through the LSTM helper
    when the sequence is at least its unroll long, and is declined and
    counted when shorter; either way it equals the reference's helper
    scan within 1e-5."""
    jl, pl, params, x = _lstm_case(seq_len)
    h0 = np.zeros((2, 6), np.float32)
    want, _ = jhelpers.AcceleratedLSTMHelper().scan(
        jl, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(h0), jnp.asarray(h0), None)
    before = helpers.declines("LSTM")
    got, _ = pl.forward({k: torch.tensor(v) for k, v in params.items()},
                        torch.tensor(x), {})
    assert helpers.declines("LSTM") == before + (seq_len < 8)
    assert helpers.AcceleratedLSTMHelper().supports(
        pl, seq_len=seq_len) == (seq_len >= 8)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_lstm_kernel_route_keeps_priority(restore_registry):
    """A sigmoid-gated LSTM takes the kernel route (``ops.lstm_sequence``),
    never the helper, as the reference's DL4J_TPU_LSTM_KERNEL branch
    comes before its helper."""
    helpers.register_helper("GravesLSTM", _Raising())
    layer = GravesLSTM(n_in=2, n_out=3)
    params = {k: torch.zeros(s) for k, s in layer.param_shapes().items()}
    out, _ = layer.forward(params, torch.zeros(1, 9, 2), {})
    assert out.shape == (1, 9, 3)


def test_declines_count_only_when_metrics_are_on(monkeypatch):
    layer = SelfAttentionLayer(n_in=4, n_out=4).apply_global_defaults({})
    params = {k: torch.zeros(s) for k, s in layer.param_shapes().items()}
    monkeypatch.setenv("DL4J_TORCH_METRICS", "0")
    before = helpers.declines("SelfAttentionLayer")
    layer.forward(params, torch.zeros(1, 4, 4), {})
    assert helpers.declines("SelfAttentionLayer") == before
    monkeypatch.setenv("DL4J_TORCH_METRICS", "1")
    layer.forward(params, torch.zeros(1, 4, 4), {})
    assert helpers.declines("SelfAttentionLayer") == before + 1
