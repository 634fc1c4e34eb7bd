"""The port's convolution, pooling and normalization layers and the CNN
preprocessors against the JAX package's, on the CPU.

Each JAX layer is built and shaped by ``set_input_type``; the port's is
built from its ``to_dict`` (so the two dataclasses must agree field for
field). Both take the same numpy-seeded parameters and input; the forward
output and the gradients of ``sum(out * g)`` for a seeded cotangent ``g``
(input and every parameter) are compared.

Tolerance: f32 throughout, each result within 1e-5 of its own max abs
(the same formulas; summation order only). Max-pool ties are compared
exactly: both must route the gradient to the same element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.input_type import (
    Convolutional as JConv, ConvolutionalFlat as JConvFlat,
    FeedForward as JFF, Recurrent as JRnn)
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import norm as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu_torch.nn.conf import preprocessors as ppre
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import layer_from_dict

REL = 1e-5


def _port_layer(jlayer):
    return layer_from_dict(jlayer.to_dict())


def _params(jlayer, rng):
    return {k: (0.5 * rng.randn(*s)).astype(np.float32)
            for k, s in jlayer.param_shapes().items()}


def _assert_close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (what, err, scale)


def _jax_run(jlayer, params, x, state, train, mask, rng):
    """JAX's forward and gradients for a cotangent ``g`` drawn from
    ``rng`` at the output's shape: (output, g, d input, d params, the new
    layer state), as one jitted program (many small eager ops compile
    more slowly than one program)."""
    def fwd(p, xx, st, m):
        return jlayer.forward(p, xx, st, train=train, mask=m)

    @jax.jit
    def run(p, xx, st, m, g):
        out, vjp, new_state = jax.vjp(lambda a, b: fwd(a, b, st, m), p, xx,
                                      has_aux=True)
        return out, vjp(g), new_state

    args = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            state, None if mask is None else jnp.asarray(mask))
    out_shape = jax.eval_shape(lambda *a: fwd(*a)[0], *args).shape
    g = rng.randn(*out_shape).astype(np.float32)
    out, (dp, dx), new_state = run(*args, jnp.asarray(g))
    return (np.asarray(out), g, np.asarray(dx),
            {k: np.asarray(v) for k, v in dp.items()}, new_state)


def _port_fwd_grads(player, params, x, state, g, train, mask=None):
    """The port's forward and gradients: (output, d input, d params, the
    new layer state)."""
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    st = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    mt = None if mask is None else torch.tensor(mask)
    out, new_state = player.forward(pt, xt, st, train=train, mask=mt)
    grads = torch.autograd.grad((out * torch.tensor(g)).sum(),
                                [xt] + list(pt.values()))
    return out, grads[0], dict(zip(pt, grads[1:])), new_state


def _compare(jlayer, player, params, x, state, rng, train=False, mask=None,
             what=""):
    """Output, input and parameter gradients for a seeded cotangent;
    returns both new layer states."""
    wo, g, wdx, wdp, jstate = _jax_run(jlayer, params, x, state, train, mask,
                                       rng)
    go, gdx, gdp, pstate = _port_fwd_grads(player, params, x, state, g,
                                           train, mask)
    _assert_close(go, wo, f"out {what}")
    _assert_close(gdx, wdx, f"d input {what}")
    for k in wdp:
        _assert_close(gdp[k], wdp[k], f"d {k} {what}")
    return jstate, pstate


def _check_layer(jlayer, x, *, mask=None, seed=0):
    rng = np.random.RandomState(seed)
    player = _port_layer(jlayer)
    assert player.param_shapes() == jlayer.param_shapes()
    assert list(player.param_order) == list(jlayer.param_order)
    params = _params(jlayer, rng)
    _compare(jlayer, player, params, x, {}, rng, mask=mask)
    return player


def _image(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (kernel, stride, padding, mode, has_bias, input N, H, W)
CONV_CASES = {
    "truncate": ((3, 3), (1, 1), (0, 0), "truncate", True, (2, 7, 6)),
    "padded_stride2": ((3, 3), (2, 2), (1, 1), "truncate", True, (2, 9, 8)),
    "rect_kernel": ((2, 4), (1, 2), (1, 0), "truncate", True, (2, 6, 9)),
    "same": ((3, 3), (1, 1), (0, 0), "same", True, (2, 6, 5)),
    # asymmetric same padding: the larger half after
    "same_stride2_even": ((4, 4), (2, 2), (0, 0), "same", True, (2, 8, 7)),
    "no_bias_5x5": ((5, 5), (1, 1), (0, 0), "truncate", False, (2, 9, 9)),
}


@pytest.mark.parametrize("helper", ["im2col", "direct"])
@pytest.mark.parametrize("channels", [1, 3, 7])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(monkeypatch, case, channels, helper):
    """Against both of JAX's routes, its im2col helper (the default for
    kernels up to 25 elements and up to 4 input channels) and its direct
    convolution (helpers disabled); the port takes its own im2col route
    under the same gate (1 and 3 channels) and ``F.conv2d`` above it
    (7)."""
    if helper == "direct":
        monkeypatch.setenv("DL4J_TPU_DISABLE_HELPERS", "1")
    kernel, stride, pad, mode, bias, (n, h, w) = CONV_CASES[case]
    jl = jconv.ConvolutionLayer(n_out=5, kernel_size=kernel, stride=stride,
                                padding=pad, convolution_mode=mode,
                                has_bias=bias, activation="tanh")
    out_t = jl.set_input_type(JConv(h, w, channels))
    player = _check_layer(jl, _image((n, h, w, channels)))
    assert player.uses_im2col() == (channels <= 4)
    assert player.output_type(InputType.convolutional(h, w, channels)) \
        .to_dict() == out_t.to_dict()


POOL_GEOMETRY = {
    "k2s2": ((2, 2), (2, 2), (0, 0), "truncate", (2, 8, 6, 3)),
    "k3s2_pad1": ((3, 3), (2, 2), (1, 1), "truncate", (2, 7, 7, 2)),
    # padding above half the kernel, which F.max_pool2d refuses itself
    "k3s1_pad2": ((3, 3), (1, 1), (2, 2), "truncate", (2, 5, 4, 2)),
    "same_k3s2": ((3, 3), (2, 2), (0, 0), "same", (2, 8, 7, 2)),
    "same_k2s1": ((2, 2), (1, 1), (0, 0), "same", (2, 5, 5, 3)),
}


@pytest.mark.parametrize("geometry", sorted(POOL_GEOMETRY))
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_subsampling_matches_jax(kind, geometry):
    kernel, stride, pad, mode, shape = POOL_GEOMETRY[geometry]
    jl = jconv.SubsamplingLayer(pooling_type=kind, kernel_size=kernel,
                                stride=stride, padding=pad,
                                convolution_mode=mode, pnorm=3)
    out_t = jl.set_input_type(JConv(*shape[1:]))
    x = _image(shape)
    if kind == "pnorm":
        x = x + np.sign(x) * 0.1    # keep |x| off 0, where |x|^p bends
    player = _check_layer(jl, x)
    assert player.output_type(InputType.convolutional(*shape[1:])).to_dict() \
        == out_t.to_dict()


@pytest.mark.parametrize("shape", [(1, 4, 4, 1), (2, 6, 6, 3)])
def test_max_pool_ties_route_the_gradient_to_the_same_element(shape):
    """Blank image regions tie in every window: the gradient goes to the
    first element of each window in both."""
    jl = jconv.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                stride=(2, 2))
    jl.set_input_type(JConv(*shape[1:]))
    x = np.zeros(shape, np.float32)
    x[:, 1, 1] = 0.5            # one window not tied
    rng = np.random.RandomState(0)
    _, g, wdx, _, _ = _jax_run(jl, {}, x, {}, False, None, rng)
    _, gdx, _, _ = _port_fwd_grads(_port_layer(jl), {}, x, {}, g, False)
    np.testing.assert_array_equal(gdx.numpy(), wdx)
    # one element a window takes the gradient: the first, where tied
    assert np.count_nonzero(wdx) == g.size
    assert (wdx[:, 1, 1] != 0).all() and (wdx[:, 0, 0] == 0).all()
    assert (wdx[:, 0, 2] != 0).all() and (wdx[:, 2, 2] != 0).all()


@pytest.mark.parametrize("padding", [(1, 2), ((0, 2), (3, 1))])
def test_zero_padding_matches_jax(padding):
    jl = jconv.ZeroPaddingLayer(padding=padding)
    out_t = jl.set_input_type(JConv(4, 5, 2))
    player = _check_layer(jl, _image((2, 4, 5, 2)))
    assert player.output_type(InputType.convolutional(4, 5, 2)).to_dict() == \
        out_t.to_dict()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_over_time_matches_jax(kind, masked):
    jl = jpool.GlobalPoolingLayer(pooling_type=kind, pnorm=3)
    x = _image((3, 6, 4)) + 0.05
    mask = None
    if masked:
        mask = np.ones((3, 6), np.float32)
        mask[0, 4:] = 0
        mask[2, 1:] = 0
    player = _check_layer(jl, x, mask=mask)
    assert player.feed_forward_mask(mask) is None


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_over_space_matches_jax(kind):
    jl = jpool.GlobalPoolingLayer(pooling_type=kind)
    player = _check_layer(jl, _image((2, 5, 4, 3)) + 0.05)
    assert player.output_type(InputType.convolutional(5, 4, 3)).to_dict() \
        == jl.output_type(JConv(5, 4, 3)).to_dict()


# (input shape, input type, input scale, input offset)
BN_CASES = {
    "cnn": ((4, 5, 5, 3), JConv(5, 5, 3), 1.0, 0.0),
    "ff": ((8, 6), JFF(6), 1.0, 0.0),
    "rnn": ((3, 4, 5), JRnn(5), 1.0, 0.0),
    # mean² far above the spread: the shifted one-pass moments must hold
    "large_mean": ((6, 3, 3, 2), JConv(3, 3, 2), 0.01, 1000.0),
}


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_train_then_eval_matches_jax(case, lock):
    """Three train steps carrying the running moments, each step's output
    and gradients compared, then an eval forward from the final state."""
    shape, itype, scale, offset = BN_CASES[case]
    jl = jnorm.BatchNormalization(lock_gamma_beta=lock, decay=0.8,
                                  gamma_init=1.2, beta_init=-0.3)
    jl.set_input_type(itype)
    player = _port_layer(jl)
    rng = np.random.RandomState(3)
    params = _params(jl, rng)
    jstate = jl.init_state()
    pstate = player.init_state()
    for k in jstate:
        np.testing.assert_array_equal(pstate[k].numpy(), np.asarray(jstate[k]))
    for step in range(3):
        x = (offset + scale * rng.randn(*shape)).astype(np.float32)
        state = {k: np.asarray(v) for k, v in jstate.items()}
        jstate, pstate = _compare(jl, player, params, x, state, rng,
                                  train=True, what=f"step {step}")
        for k in jstate:
            _assert_close(pstate[k], jstate[k], f"state {k} {step}")
    x = (offset + scale * rng.randn(*shape)).astype(np.float32)
    want, _ = jl.forward({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), jstate, train=False)
    got, same = player.forward({k: torch.tensor(v) for k, v in params.items()},
                               torch.tensor(x), pstate, train=False)
    _assert_close(got, want, "eval out")
    assert same is pstate


@pytest.mark.parametrize("n", [3, 5])
def test_lrn_matches_jax(n):
    jl = jnorm.LocalResponseNormalization(n=n, k=1.5, alpha=0.3, beta=0.75)
    _check_layer(jl, _image((2, 4, 3, 7)))


# ---------------------------------------------------------------------------
# preprocessors
# ---------------------------------------------------------------------------
PRE_CASES = {
    "cnn_to_ff": (lambda m: m.CnnToFeedForwardPreProcessor(4, 3, 2),
                  (5, 4, 3, 2), "cnn"),
    "ff_to_cnn": (lambda m: m.FeedForwardToCnnPreProcessor(4, 3, 2),
                  (5, 24), "ff"),
    "cnn_to_rnn": (lambda m: m.CnnToRnnPreProcessor(4, 3, 2,
                                                    timeseries_length=3),
                   (6, 4, 3, 2), "cnn"),
    "rnn_to_cnn": (lambda m: m.RnnToCnnPreProcessor(4, 3, 2),
                   (2, 3, 24), "rnn"),
    "composable": (lambda m: m.ComposableInputPreProcessor(
        [m.FeedForwardToCnnPreProcessor(4, 3, 2),
         m.CnnToFeedForwardPreProcessor(4, 3, 2)]), (5, 24), "ff"),
}
_IN_TYPES = {"cnn": (JConv(4, 3, 2), InputType.convolutional(4, 3, 2)),
             "ff": (JFF(24), InputType.feed_forward(24)),
             "rnn": (JRnn(24, 3), InputType.recurrent(24, 3))}


@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_preprocessor_matches_jax(case):
    build, shape, kind = PRE_CASES[case]
    jp, pp = build(jpre), build(ppre)
    assert pp.to_dict() == jp.to_dict()
    again = ppre.preprocessor_from_dict(jp.to_dict())
    assert again.to_dict() == jp.to_dict()
    jt, pt = _IN_TYPES[kind]
    assert pp.output_type(pt).to_dict() == jp.output_type(jt).to_dict()
    x = _image(shape)
    want = np.asarray(jp.pre_process(jnp.asarray(x)))
    g = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jp.pre_process(a), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = pp.pre_process(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (dx,) = torch.autograd.grad((got * torch.tensor(g)).sum(), xt)
    np.testing.assert_array_equal(dx.numpy(), np.asarray(vjp(g)[0]))


def test_cnnflat_input_gets_the_reference_preprocessors():
    """A flat image input in front of a conv gets FeedForwardToCnn, and a
    conv in front of a dense layer CnnToFeedForward, as in the JAX
    package; the JSON of both configurations is the same."""
    from deeplearning4j_tpu.nn.conf.multi_layer import (
        NeuralNetConfiguration as JB)
    from deeplearning4j_tpu.nn.layers import (
        ConvolutionLayer as JC, DenseLayer as JD, OutputLayer as JO)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration as PB)
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    DenseLayer, OutputLayer)

    def build(b, conv, dense, out, flat):
        return (b.seed(1).list()
                .layer(conv(n_out=3, kernel_size=(3, 3)))
                .layer(dense(n_out=4))
                .layer(out(n_out=2, loss="mcxent", activation="softmax"))
                .set_input_type(flat(6, 6, 1)).build())
    j = build(JB.Builder(), JC, JD, JO, JConvFlat)
    p = build(PB.Builder(), ConvolutionLayer, DenseLayer, OutputLayer,
              InputType.convolutional_flat)
    assert p.to_json() == j.to_json()
    assert [type(v).__name__ for _, v in sorted(
        p.input_preprocessors.items())] == ["FeedForwardToCnnPreProcessor",
                                            "CnnToFeedForwardPreProcessor"]
