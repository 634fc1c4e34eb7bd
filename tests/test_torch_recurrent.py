"""The port's recurrent layers against the JAX package's.

Each layer gets the same parameters and inputs (numpy, seeded). The JAX
side runs its layer with ``DL4J_TPU_LSTM_KERNEL=pallas`` (the fused Pallas
cell in interpret mode) or ``builtin`` (its plain scan); the port runs its
default route (``ops.lstm_sequence``, whose CPU path is the kernels'
plain twins behind the autograd Function) or ``DL4J_TORCH_LSTM_KERNEL=builtin``
(its plain recurrence under autograd). Every pairing must agree.

Tolerances: outputs and final carries 1e-6 abs (activations in (-1, 1)
and cells below ~3; summation order only); gradients of the inputs and of
every parameter 1e-5 of each gradient's max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
from deeplearning4j_tpu_torch.ops import lstm_cell as plc

B, T, N_IN, H = 3, 7, 5, 6
KINDS = {
    "LSTM": ("LSTM", {}),
    "GravesLSTM": ("GravesLSTM", {}),
    "Bidirectional_add": ("GravesBidirectionalLSTM", {"mode": "add"}),
    "Bidirectional_concat": ("GravesBidirectionalLSTM", {"mode": "concat"}),
}


def _layers(kind, activation="tanh"):
    name, kw = KINDS[kind]
    args = dict(n_in=N_IN, n_out=H, activation=activation, **kw)
    return getattr(jrec, name)(**args), getattr(prec, name)(**args)


def _params(layer, seed):
    r = np.random.RandomState(seed)
    return {k: (0.5 * r.randn(*s)).astype(np.float32)
            for k, s in layer.param_shapes().items()}


def _mask(kind):
    if kind is None:
        return None
    m = np.ones((B, T), np.float32)
    m[0, -3:] = 0.0          # padded tail: hold, emit 0
    m[1, 2] = 0.0            # a hole inside the sequence
    return m


@pytest.fixture
def routes(monkeypatch, request):
    jax_route, port_route = request.param
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DL4J_TPU_LSTM_KERNEL", jax_route)
    if port_route == "builtin":
        monkeypatch.setenv("DL4J_TORCH_LSTM_KERNEL", "builtin")
    else:
        monkeypatch.delenv("DL4J_TORCH_LSTM_KERNEL", raising=False)
    return request.param


ROUTES = [("pallas", "kernel"), ("builtin", "builtin"),
          ("pallas", "builtin")]


def _jax_forward(layer, params, x, mask, cot):
    def f(p, xx):
        out, _ = layer.forward(p, xx, {}, train=False, mask=mask)
        return jnp.sum(out * cot), out
    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


def _port_forward(layer, params, x, mask, cot):
    p = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in params.items()}
    xx = torch.from_numpy(x.copy()).requires_grad_()
    out, _ = layer.forward(p, xx, {}, train=False,
                           mask=None if mask is None
                           else torch.from_numpy(mask))
    loss = (out * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, [*p.values(), xx])
    return out.detach().numpy(), \
        {k: g.numpy() for k, g in zip(p, grads[:-1])}, grads[-1].numpy()


def _close_grad(got, want, name):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("routes", ROUTES, indirect=True,
                         ids=["pallas-kernel", "builtin-builtin",
                              "pallas-builtin"])
@pytest.mark.parametrize("mask", [None, "holes"], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_layer_forward_and_gradients_match_jax(routes, kind, mask):
    jl, pl = _layers(kind)
    params = _params(jl, seed=list(KINDS).index(kind))
    r = np.random.RandomState(1)
    x = r.randn(B, T, N_IN).astype(np.float32)
    m = _mask(mask)
    width = 2 * H if kind.endswith("concat") else H
    cot = r.randn(B, T, width).astype(np.float32)
    want_out, want_gp, want_gx = _jax_forward(jl, params, x, m, cot)
    got_out, got_gp, got_gx = _port_forward(pl, params, x, m, cot)
    assert got_out.shape == want_out.shape == (B, T, width)
    assert np.abs(got_out - want_out).max() <= 1e-6
    if m is not None:   # masked steps emit exactly 0
        assert np.all(got_out[m == 0] == 0.0)
    _close_grad(got_gx, want_gx, "x")
    assert set(got_gp) == set(want_gp)
    for k in want_gp:
        _close_grad(got_gp[k], want_gp[k], k)


@pytest.mark.parametrize("routes", ROUTES[:2], indirect=True,
                         ids=["pallas-kernel", "builtin-builtin"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("mask", [None, "holes"], ids=["nomask", "mask"])
def test_scan_final_carries_match_jax(routes, reverse, mask):
    """``_scan`` from non-zero (h0, c0): outputs and the final (h, c), the
    carries tBPTT and ``rnn_time_step`` pass on."""
    jl, pl = _layers("GravesLSTM")
    params = _params(jl, seed=5)
    r = np.random.RandomState(2)
    x = r.randn(B, T, N_IN).astype(np.float32)
    h0, c0 = (r.randn(B, H).astype(np.float32) for _ in range(2))
    m = _mask(mask)
    jout, (jh, jc) = jl._scan({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                              None if m is None else jnp.asarray(m),
                              reverse=reverse)
    with torch.no_grad():
        pout, (ph, pc) = pl._scan(
            {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(c0),
            None if m is None else torch.from_numpy(m), reverse=reverse)
    for got, want in ((pout, jout), (ph, jh), (pc, jc)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


def test_exotic_activation_takes_the_builtin_recurrence(monkeypatch):
    """A cell activation outside the kernels' sigmoid/tanh contract routes
    to the plain recurrence on any device, by configuration: no sequence
    call, and the JAX layer's output."""
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DL4J_TPU_LSTM_KERNEL", "pallas")
    calls = []
    real = prec.lstm_sequence
    monkeypatch.setattr(prec, "lstm_sequence",
                        lambda *a: calls.append(1) or real(*a))
    jl, pl = _layers("LSTM", activation="softsign")
    assert not plc.lstm_cell_supported(pl.gate_activation, pl.activation)
    params = _params(jl, seed=9)
    r = np.random.RandomState(3)
    x = r.randn(B, T, N_IN).astype(np.float32)
    cot = r.randn(B, T, H).astype(np.float32)
    want_out, want_gp, _ = _jax_forward(jl, params, x, None, cot)
    got_out, got_gp, _ = _port_forward(pl, params, x, None, cot)
    assert calls == []
    assert np.abs(got_out - want_out).max() <= 1e-6
    for k in want_gp:
        _close_grad(got_gp[k], want_gp[k], k)


def test_supported_layer_calls_the_cell_once_per_step(monkeypatch):
    """The kernel route runs a window as one ``lstm_sequence`` call per
    direction (the sequence Function steps through the cell inside)."""
    calls = []
    real = prec.lstm_sequence
    monkeypatch.setattr(prec, "lstm_sequence",
                        lambda *a: calls.append(a[6]) or real(*a))
    _, pl = _layers("Bidirectional_add")
    params = {k: torch.from_numpy(v)
              for k, v in _params(pl, seed=4).items()}
    pl.forward(params, torch.zeros(B, T, N_IN), {})
    assert calls == [False, True]   # forward, then reverse


@pytest.mark.parametrize("mask", [None, "holes", "pre_padded"])
def test_last_time_step_layer_matches_jax(mask):
    r = np.random.RandomState(6)
    x = r.randn(B, T, H).astype(np.float32)
    m = _mask(mask) if mask != "pre_padded" else \
        np.concatenate([np.zeros((B, 2), np.float32),
                        np.ones((B, T - 2), np.float32)], axis=1)
    jl, pl = jrec.LastTimeStepLayer(), prec.LastTimeStepLayer()
    want, _ = jl.forward({}, jnp.asarray(x), {},
                         mask=None if m is None else jnp.asarray(m))
    got, _ = pl.forward({}, torch.from_numpy(x), {},
                        mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pl.feed_forward_mask(m) is None


def test_layer_shapes_and_param_order_match_jax():
    for kind in KINDS:
        jl, pl = _layers(kind)
        assert pl.param_shapes() == jl.param_shapes(), kind
        assert pl.param_order == jl.param_order, kind
        assert pl.to_dict() == jl.to_dict(), kind
