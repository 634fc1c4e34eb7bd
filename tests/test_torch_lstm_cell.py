"""The port's LSTM cell against the JAX package's fused Pallas cell.

``pallas_kernels.lstm_cell`` runs in interpret mode
(``DL4J_TPU_PALLAS_INTERPRET=1``), as ``tests/test_pallas.py`` runs it.
The port's ``lstm_cell`` on CPU tensors takes the kernels' plain twins
through the same ``autograd.Function`` a CUDA tensor takes, so these
tests also hold the Function's backward wiring.

Tolerances, with their reasons:
- forward h and c, f32: 1e-6 abs (summation order of the h·RW product
  only; h in (-1, 1), |c| below ~3 here);
- gradients of every input (zx, h_prev, c_prev, RW, P), f32: 1e-5 of each
  gradient's max abs (summation order of the products);
- bf16: the port's result within one bf16 step of the reference's, 2^-7
  of the value's magnitude plus 1e-5 of the output's max abs, element by
  element (both round nearly equal f32 values once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.ops import lstm_cell as lc
from deeplearning4j_tpu_torch.ops.lstm_cell import (lstm_cell,
                                                    lstm_cell_bwd_plain,
                                                    lstm_cell_plain,
                                                    lstm_cell_supported)

BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _inputs(b, h, peep, seed=0):
    r = np.random.RandomState(seed)
    arrs = [r.randn(b, 4 * h), 0.5 * r.randn(b, h), r.randn(b, h),
            r.randn(h, 4 * h) / np.sqrt(h)]
    arrs.append(0.3 * r.randn(3, h) if peep else None)
    cots = [r.randn(b, h), r.randn(b, h)]
    f32 = [None if a is None else a.astype(np.float32) for a in arrs]
    return f32, [c.astype(np.float32) for c in cots]


def _jax_vjp(arrs, cots, dtype):
    """(h, c, grads of zx, h, c, RW[, P]) of the Pallas cell, as f32
    numpy."""
    peep = arrs[4] is not None
    xs = [jnp.asarray(a, dtype) for a in arrs if a is not None]
    (h, c), vjp = jax.vjp(lambda *a: jpk.lstm_cell(*a), *xs)
    grads = vjp(tuple(jnp.asarray(g, dtype) for g in cots))
    out = [h, c, *grads]
    assert len(grads) == (5 if peep else 4)
    return [np.asarray(jnp.asarray(o, jnp.float32)) for o in out]


def _port(arrs, cots, dtype):
    """The same through the port's autograd Function on CPU tensors."""
    ts = [None if a is None else
          torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]
    h, c = lstm_cell(*ts)
    grads = torch.autograd.grad(
        (h, c), [t for t in ts if t is not None],
        [torch.from_numpy(g).to(dtype) for g in cots])
    return [x.detach().float().numpy() for x in (h, c, *grads)]


NAMES = ["h", "c", "dzx", "dh_prev", "dc_prev", "dRW", "dP"]


@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("b", [1, 4, 32])
@pytest.mark.parametrize("h", [8, 37, 200])
def test_cell_and_gradients_match_pallas(b, h, peep):
    arrs, cots = _inputs(b, h, peep, seed=b * 1000 + h)
    want = _jax_vjp(arrs, cots, jnp.float32)
    got = _port(arrs, cots, torch.float32)
    assert len(got) == len(want)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        tol = 1e-6 if name in ("h", "c") else 1e-5 * np.abs(w).max()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("b,h", [(4, 8), (32, 200)])
def test_bf16_within_one_step_of_pallas(b, h, peep):
    arrs, cots = _inputs(b, h, peep, seed=7)
    # the same bf16-representable inputs on both sides
    arrs = [None if a is None else
            np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in arrs]
    cots = [np.array(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
            for c in cots]
    want = _jax_vjp(arrs, cots, jnp.bfloat16)
    got = _port(arrs, cots, torch.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        limit = 1e-5 * np.abs(w).max() + BF16_STEP * np.abs(w)
        assert (np.abs(g - w) <= limit).all(), \
            (name, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
def test_twins_called_directly_match_the_function(peep):
    """``lstm_cell_plain``/``lstm_cell_bwd_plain`` are what the Function
    runs on the CPU: the same values, dP None without peepholes, each
    output in its input's dtype."""
    arrs, cots = _inputs(5, 12, peep, seed=3)
    ts = [None if a is None else torch.from_numpy(a) for a in arrs]
    h, c = lstm_cell_plain(*ts)
    outs = lstm_cell_bwd_plain(*ts, *(torch.from_numpy(g) for g in cots))
    got = _port(arrs, cots, torch.float32)
    np.testing.assert_array_equal(h.numpy(), got[0])
    np.testing.assert_array_equal(c.numpy(), got[1])
    assert (outs[4] is None) == (not peep)
    for a, b_ in zip([o for o in outs if o is not None], got[2:]):
        np.testing.assert_array_equal(a.numpy(), b_)
        assert a.dtype == torch.float32


def test_supported_predicate_is_the_references():
    for gate, cell in [("sigmoid", "tanh"), ("sigmoid", None),
                       ("hardsigmoid", "tanh"), ("sigmoid", "relu"),
                       ("sigmoid", "softsign")]:
        assert lstm_cell_supported(gate, cell) == \
            jpk.lstm_cell_supported(gate, cell), (gate, cell)


def test_no_gradient_path_skips_the_function():
    """Under no_grad (inference, ``rnn_time_step``) the cell runs the
    forward route directly and records no graph."""
    arrs, _ = _inputs(2, 6, True)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    with torch.no_grad():
        h, c = lstm_cell(*ts)
    assert h.grad_fn is None and c.grad_fn is None
    h2, _ = lstm_cell(*ts)
    assert isinstance(h2.grad_fn, torch.autograd.function.BackwardCFunction)
    assert type(h2.grad_fn).__name__.startswith(lc._LstmCell.__name__)
