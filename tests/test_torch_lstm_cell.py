"""The port's LSTM cell and sequence against the JAX package's fused
Pallas cell.

``pallas_kernels.lstm_cell`` runs in interpret mode
(``DL4J_TPU_PALLAS_INTERPRET=1``), as ``tests/test_pallas.py`` runs it;
for a window it runs inside ``jax.lax.scan`` with the reference layer's
mask rule (``_scan_pallas``). The port's ``lstm_cell`` and
``lstm_sequence`` on CPU tensors take the kernels' plain twins through the
same ``autograd.Function``s a CUDA tensor takes, so these tests also hold
the Functions' backward wiring: the mask, the reverse walk and the sums
of dRW and dP over the steps.

Tolerances, with their reasons:
- forward h and c, f32: 1e-6 abs (summation order of the h·RW product
  only; h in (-1, 1), |c| below ~3 here);
- gradients of every input (zx, h_prev, c_prev, RW, P), f32: 1e-5 of each
  gradient's max abs (summation order of the products);
- bf16: the port's result within one bf16 step of the reference's, 2^-7
  of the value's magnitude plus 1e-5 of the output's max abs, element by
  element (both round nearly equal f32 values once).
The same bars hold for a window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.ops import lstm_cell as lc
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops.lstm_cell import (lstm_cell,
                                                    lstm_cell_bwd_plain,
                                                    lstm_cell_plain,
                                                    lstm_cell_supported,
                                                    BF16_WINDOW_BAR,
                                                    F32_WINDOW_TOL,
                                                    lstm_sequence,
                                                    lstm_sequence_plain)

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


# ---------------------------------------------------------------------------
# a window: lstm_sequence against lax.scan of the Pallas cell
# ---------------------------------------------------------------------------
def _keep(kind, t, b):
    """[T, B] keep masks: none, holes inside the window, and pre-padding
    (the first steps of some rows dropped)."""
    if kind is None:
        return None
    keep = np.ones((t, b), bool)
    if kind == "holes":
        keep[t // 2, 0] = False
        keep[0, b - 1] = False
        keep[t - 1, 1] = False
    else:
        keep[:max(1, t // 2), :2] = False
    return keep


def _seq_inputs(t, b, h, peep, seed):
    r = np.random.RandomState(seed)
    arrs = [r.randn(t, b, 4 * h), 0.5 * r.randn(b, h), r.randn(b, h),
            r.randn(h, 4 * h) / np.sqrt(h),
            0.3 * r.randn(3, h) if peep else None]
    cots = [r.randn(t, b, h), r.randn(b, h), r.randn(b, h)]
    return [None if a is None else a.astype(np.float32) for a in arrs], \
        [c.astype(np.float32) for c in cots]


def _jax_seq_vjp(arrs, keep, reverse, cots, dtype):
    """(out, h_T, c_T, grads of zx_t, h0, c0, RW[, P]) of a lax.scan of the
    Pallas cell with ``_scan_pallas``'s mask rule, as f32 numpy."""
    xs = [jnp.asarray(a, dtype) for a in arrs if a is not None]

    def run(zx_t, h0, c0, rw, *p):
        peep = p[0] if p else None

        def step(carry, inp):
            h_prev, c_prev = carry
            z_t, m_t = inp if keep is not None else (inp, None)
            h, c = jpk.lstm_cell(z_t, h_prev, c_prev, rw, peep)
            if m_t is None:
                return (h, c), h
            h = jnp.where(m_t, h, h_prev)
            c = jnp.where(m_t, c, c_prev)
            return (h, c), h * m_t
        seq = zx_t if keep is None else (zx_t, jnp.asarray(keep)[..., None])
        (h_t, c_t), out = jax.lax.scan(step, (h0, c0), seq, reverse=reverse)
        return out, h_t, c_t
    outs, vjp = jax.vjp(run, *xs)
    grads = vjp(tuple(jnp.asarray(c, dtype) for c in cots))
    return [np.asarray(jnp.asarray(o, jnp.float32)) for o in (*outs, *grads)]


def _port_seq(arrs, keep, reverse, cots, dtype):
    ts = [None if a is None else
          torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]
    out, (h_t, c_t) = lstm_sequence(
        *ts, keep=None if keep is None else torch.from_numpy(keep),
        reverse=reverse)
    grads = torch.autograd.grad(
        (out, h_t, c_t), [t for t in ts if t is not None],
        [torch.from_numpy(c).to(dtype) for c in cots])
    return [x.detach().float().numpy() for x in (out, h_t, c_t, *grads)]


SEQ_NAMES = ["out", "h_T", "c_T", "dzx", "dh0", "dc0", "dRW", "dP"]


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("mask", [None, "holes", "pre_padded"])
@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("t", [1, 7])
def test_sequence_and_gradients_match_pallas_scan(t, peep, mask, reverse):
    """Outputs, final carries and the gradients of zx_t, h0, c0, RW and P
    (nonzero cotangents on out, h_T and c_T) at ragged B 5, H 37."""
    b, h = 5, 37
    arrs, cots = _seq_inputs(t, b, h, peep, seed=100 * t + 10 * peep)
    keep = _keep(mask, t, b)
    want = _jax_seq_vjp(arrs, keep, reverse, cots, jnp.float32)
    got = _port_seq(arrs, keep, reverse, cots, torch.float32)
    assert len(got) == len(want) == (8 if peep else 7)
    for name, g, w in zip(SEQ_NAMES, got, want):
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        tol = 1e-6 if name in ("out", "h_T", "c_T") else \
            1e-5 * np.abs(w).max()
        assert err <= tol, (name, err, tol)
    if keep is not None:   # dropped steps emit exactly 0
        assert np.all(got[0][~keep] == 0.0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("mask", [None, "holes"])
def test_sequence_bf16_within_one_step_of_pallas_scan(mask, reverse):
    t, b, h = 7, 5, 37
    arrs, cots = _seq_inputs(t, b, h, True, seed=11)
    arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in arrs]
    cots = [np.array(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
            for c in cots]
    keep = _keep(mask, t, b)
    want = _jax_seq_vjp(arrs, keep, reverse, cots, jnp.bfloat16)
    got = _port_seq(arrs, keep, reverse, cots, torch.bfloat16)
    for name, g, w in zip(SEQ_NAMES, got, want):
        limit = 1e-5 * np.abs(w).max() + BF16_STEP * np.abs(w)
        assert (np.abs(g - w) <= limit).all(), \
            (name, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("mask", [None, "holes"])
def test_sequence_twin_is_the_cell_twin_step_by_step(mask, reverse):
    """``lstm_sequence_plain`` is ``lstm_cell_plain`` over the window with
    the mask rule, bit for bit; ``lstm_sequence`` without gradients
    returns the same; the states it keeps for the backward are the walk's
    (h, c), slot 0 the initial state."""
    t, b, h = 6, 4, 9
    arrs, _ = _seq_inputs(t, b, h, True, seed=5)
    zx_t, h0, c0, rw, p = (torch.from_numpy(a) for a in arrs)
    keep = _keep(mask, t, b)
    kp = None if keep is None else torch.from_numpy(keep)
    out, h_all, c_all = lstm_sequence_plain(zx_t, h0, c0, rw, p, kp,
                                            reverse, with_states=True)
    hh, cc = h0, c0
    for k, s in enumerate(range(t - 1, -1, -1) if reverse else range(t)):
        assert torch.equal(h_all[k], hh) and torch.equal(c_all[k], cc)
        hn, cn = lstm_cell_plain(zx_t[s], hh, cc, rw, p)
        if keep is not None and not keep[s].all():
            m = kp[s][:, None]
            hn, cn = torch.where(m, hn, hh), torch.where(m, cn, cc)
            assert torch.equal(out[s], hn * m)
        else:
            assert torch.equal(out[s], hn)
        hh, cc = hn, cn
    assert torch.equal(h_all[t], hh) and torch.equal(c_all[t], cc)
    got_out, (got_h, got_c) = lstm_sequence(zx_t, h0, c0, rw, p, kp, reverse)
    assert torch.equal(got_out, out) and torch.equal(got_h, hh) and \
        torch.equal(got_c, cc)


SEQ_REFUSALS = ["zx_rank", "zx_width", "h0_shape", "rw_shape", "peep_shape",
                "mixed", "dtype", "keep_shape", "keep_dtype", "zx_strided"]


@pytest.mark.parametrize("case", SEQ_REFUSALS)
def test_sequence_device_call_reaches_the_checks_not_the_twin(monkeypatch,
                                                              case):
    """A tensor off the CPU (``meta`` stands in for the card) takes the
    kernel route: the sequence's input checks refuse what the kernel
    cannot take before any library is loaded, and the twin never runs."""
    def no_twin(*a, **kw):
        raise AssertionError("a device tensor reached the plain twin")

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a refused call")
    monkeypatch.setattr(lc, "lstm_sequence_plain", no_twin)
    monkeypatch.setattr(lc, "lstm_cell_plain", no_twin)
    monkeypatch.setattr(_build, "load", no_kernel)
    t, b, h = 3, 4, 6

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    zx_t, h0, c0, rw, p = z(t, b, 4 * h), z(b, h), z(b, h), z(h, 4 * h), \
        z(3, h)
    keep = z(t, b, dtype=torch.bool)
    err = ValueError
    if case == "zx_rank":
        zx_t = z(b, 4 * h)
    elif case == "zx_width":
        zx_t = z(t, b, 4 * h + 1)
    elif case == "h0_shape":
        h0 = z(b + 1, h)
    elif case == "rw_shape":
        rw = z(4 * h, h)
    elif case == "peep_shape":
        p = z(4, h)
    elif case == "mixed":
        rw, err = z(h, 4 * h, dtype=torch.bfloat16), TypeError
    elif case == "dtype":
        zx_t, h0, c0, rw, p = (x.half() for x in (zx_t, h0, c0, rw, p))
        err = TypeError
    elif case == "keep_shape":
        keep = z(b, t, dtype=torch.bool)
    elif case == "keep_dtype":
        keep, err = z(t, b), TypeError
    else:
        zx_t = z(b, t, 4 * h).transpose(0, 1)
    before = lc.lstm_sequence.launches
    with pytest.raises(err):
        lstm_sequence(zx_t, h0, c0, rw, p, keep)
    with pytest.raises(err):   # the differentiable route checks the same
        lstm_sequence(zx_t, h0, c0, rw.requires_grad_(), p, keep)
    assert lc.lstm_sequence.launches == before


def test_sequence_device_call_with_good_inputs_reaches_the_device_check(
        monkeypatch):
    """Inputs the kernel takes, on a device that is neither CUDA nor the
    CPU: refused by name, still before any library is loaded."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a meta tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    t, b, h = 3, 4, 6
    zx_t = torch.zeros(t, b, 4 * h, device="meta")
    z = torch.zeros(b, h, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lstm_sequence(zx_t, z, z, torch.zeros(h, 4 * h, device="meta"))


# ---------------------------------------------------------------------------
# the bars of a window on the card, derived from the twin's own rounding
# ---------------------------------------------------------------------------
def _window_inputs(t, b, h, seed):
    """The card checks' input scales, numpy-seeded, in float64."""
    r = np.random.RandomState(seed)
    return [torch.from_numpy(a) for a in (
        r.randn(t, b, 4 * h), 0.5 * r.randn(b, h), r.randn(b, h),
        r.randn(h, 4 * h) / np.sqrt(h), 0.1 * r.randn(3, h))]


def _gates_f64(zx, h_prev, c_prev, rw, peep):
    """``lstm_cell._gates`` in float64: z exact, then the cell."""
    hp, cp = h_prev.double(), c_prev.double()
    z = zx.double() + hp @ rw.double()
    i, f, g, o = torch.chunk(z, 4, dim=1)
    if peep is not None:
        p = peep.double()
        i, f = i + cp * p[0:1], f + cp * p[1:2]
    i, f, g = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g)
    c = f * cp + i * g
    if peep is not None:
        o = o + c * p[2:3]
    o = torch.sigmoid(o)
    return i, f, g, o, c, torch.tanh(c)


@pytest.mark.parametrize("seed", range(12))
def test_f32_window_rounding_leaves_room_under_the_card_bar(monkeypatch,
                                                            seed):
    """``F32_WINDOW_TOL``: the card holds a window's f32 out, h and c to it
    against the twin at the char-RNN's window (B 32, H 200, T 50). Each
    step's rounding feeds the next, so the bar is held here first: the f32
    twin stays within half of it of the exact (float64) recurrence, so a
    kernel that rounds as finely in another order stays within it of the
    twin. (The one-step bar, 1e-6, would leave no room: the twin alone
    departs by up to 0.77 of it.)"""
    xs = _window_inputs(50, 32, 200, seed)
    got = lstm_sequence_plain(*(x.float() for x in xs), with_states=True)
    monkeypatch.setattr(lc, "_gates", _gates_f64)
    want = lstm_sequence_plain(*(x.double() for x in xs), with_states=True)
    for name, g, w in zip(("out", "h", "c"), got, want):
        err = (g.double() - w).abs().max().item()
        assert err <= 0.5 * F32_WINDOW_TOL, (name, err)


def test_bf16_window_rounding_stays_within_the_window_bar(monkeypatch):
    """``BF16_WINDOW_BAR``: two bf16 twins over the char-RNN's window that
    differ only in the f32 rounding of each step's z (the twin's, and z
    taken exactly, then rounded to f32) part by steps of bf16 that the
    recurrence carries on (the element-wise one-step bar breaks by two
    orders of magnitude), but stay within 0.5 of the window bar at the
    outputs' scale."""
    worst_step, worst_bar = 0.0, 0.0
    real = lc._gates

    def gates_exact_z(zx, h_prev, c_prev, rw, peep):
        z = (zx.double() + h_prev.double() @ rw.double()).float()
        return real(z, h_prev, c_prev, torch.zeros_like(rw), peep)
    for seed in range(3):
        xs = [x.bfloat16() for x in _window_inputs(50, 32, 200, seed)]
        monkeypatch.setattr(lc, "_gates", real)
        a = lstm_sequence_plain(*xs, with_states=True)
        monkeypatch.setattr(lc, "_gates", gates_exact_z)
        b = lstm_sequence_plain(*xs, with_states=True)
        for x, y in zip(a, b):
            err = (x.float() - y.float()).abs()
            worst_step = max(worst_step, (err / (1e-5 + BF16_STEP *
                                                 y.float().abs())).max()
                             .item())
            worst_bar = max(worst_bar, err.max().item() /
                            (BF16_WINDOW_BAR * y.float().abs().max().item()))
    assert worst_step > 10.0, worst_step
    assert worst_bar <= 0.5, worst_bar
