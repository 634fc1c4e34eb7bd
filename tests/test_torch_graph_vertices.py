"""The port's graph vertices against the JAX package's, on the CPU.

Each of the 13 vertices is built from the JAX vertex's dict form, runs
on the same inputs (made from a numpy seed), and is held against it:
the forward, the gradient of a seeded projection of the output with
respect to every input, the output mask where the vertex takes masks,
and the inferred output type. Then every vertex's dict form round-trips
and equals the reference's.

Tolerances, with their reasons: outputs and gradients within 1e-6 of
each array's max abs (the same f32 formulas; only the reductions of L2
and L2Normalize can sum in another order); masks and output types
exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

REL = 1e-6
B, T, F = 4, 6, 5


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(seed, pre_padded=False):
    """A [B, T] 0/1 mask with a different length per row (and, with
    ``pre_padded``, leading zeros as well)."""
    m = np.zeros((B, T), np.float32)
    lengths = np.random.RandomState(seed).randint(1, T + 1, B)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
        if pre_padded and n < T:
            m[i] = np.roll(m[i], T - n)
    return m


# name -> (JAX vertex, input arrays, masks (None or a list), input types)
def _cases():
    cnn = [JInputType.convolutional(3, 3, c) for c in (2, 3, 4)]
    rnn = JInputType.recurrent(F, T)
    ff = JInputType.feed_forward(F)
    return {
        "merge_cnn": (jgraph.MergeVertex(),
                      [_r(1, B, 3, 3, 2), _r(2, B, 3, 3, 3),
                       _r(3, B, 3, 3, 4)], None, cnn),
        "merge_rnn_masked": (jgraph.MergeVertex(),
                             [_r(4, B, T, F), _r(5, B, T, 2)],
                             [_mask(6), None],
                             [rnn, JInputType.recurrent(2, T)]),
        **{f"elementwise_{op}": (jgraph.ElementWiseVertex(op=op),
                                 [_r(10 + i, B, F) for i in
                                  range(2 if op == "subtract" else 3)],
                                 None, [ff] * 3)
           for op in ("add", "subtract", "product", "average", "max")},
        "subset": (jgraph.SubsetVertex(from_index=1, to_index=3),
                   [_r(20, B, T, F)], [_mask(21)], [rnn]),
        "stack_masked": (jgraph.StackVertex(),
                         [_r(22, B, T, F), _r(23, B, T, F)],
                         [_mask(24), _mask(25)], [rnn, rnn]),
        "unstack_masked": (jgraph.UnstackVertex(from_index=1, stack_size=2),
                           [_r(26, B, T, F)], [_mask(27)], [rnn]),
        "scale": (jgraph.ScaleVertex(scale_factor=-2.5), [_r(28, B, F)],
                  None, [ff]),
        "shift": (jgraph.ShiftVertex(shift_factor=0.75), [_r(29, B, F)],
                  None, [ff]),
        "l2": (jgraph.L2Vertex(), [_r(30, B, 3, 3, 2), _r(31, B, 3, 3, 2)],
               None, cnn[:1] * 2),
        "l2_normalize": (jgraph.L2NormalizeVertex(), [_r(32, B, T, F)],
                         None, [rnn]),
        "preprocessor_cnn_to_ff": (
            jgraph.PreprocessorVertex(
                jpre.CnnToFeedForwardPreProcessor(3, 3, 2)),
            [_r(33, B, 3, 3, 2)], None, cnn[:1]),
        "preprocessor_rnn_to_ff_masked": (
            jgraph.PreprocessorVertex(jpre.RnnToFeedForwardPreProcessor()),
            [_r(34, B, T, F)], [_mask(35)], [rnn]),
        "last_time_step": (jgraph.LastTimeStepVertex(), [_r(36, B, T, F)],
                           None, [rnn]),
        "last_time_step_masked": (jgraph.LastTimeStepVertex("in"),
                                  [_r(37, B, T, F)], [_mask(38)], [rnn]),
        "last_time_step_pre_padded": (
            jgraph.LastTimeStepVertex("in"), [_r(39, B, T, F)],
            [_mask(40, pre_padded=True)], [rnn]),
        "duplicate_to_time_series": (
            jgraph.DuplicateToTimeSeriesVertex("seq"),
            [_r(41, B, 3), _r(42, B, T, F)], [None, _mask(43)],
            [JInputType.feed_forward(3), rnn]),
        "reshape": (jgraph.ReshapeVertex(shape=(3, 4)), [_r(44, B, 12)],
                    None, [JInputType.feed_forward(12)]),
    }


CASES = _cases()


def _port(jv):
    """The port's vertex from the JAX vertex's dict form (through JSON)."""
    return pgraph.vertex_from_dict(json.loads(json.dumps(jv.to_dict())))


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vertex_forward_gradient_and_mask_match_jax(case):
    jv, xs, masks, _ = CASES[case]
    pv = _port(jv)
    assert type(pv).__name__ == type(jv).__name__
    jmasks = None if masks is None else \
        [None if m is None else jnp.asarray(m) for m in masks]
    pmasks = None if masks is None else \
        [None if m is None else torch.tensor(m) for m in masks]
    want = jv.forward([jnp.asarray(x) for x in xs], jmasks)
    g = _r(99, *want.shape)

    def jloss(*args):
        return jnp.sum(jv.forward(list(args), jmasks) * g)
    want_grads = jax.grad(jloss, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    pxs = [torch.tensor(x, requires_grad=True) for x in xs]
    got = pv.forward(pxs, pmasks)
    _close(got, want, f"{case} forward")
    got_grads = torch.autograd.grad((got * torch.tensor(g)).sum(), pxs,
                                    allow_unused=True)
    for i, (gg, wg) in enumerate(zip(got_grads, want_grads)):
        gg = torch.zeros(xs[i].shape) if gg is None else gg
        _close(gg, wg, f"{case} d input {i}")
    want_mask = jv.feed_forward_mask(jmasks)
    got_mask = pv.feed_forward_mask(pmasks)
    assert (want_mask is None) == (got_mask is None), case
    if want_mask is not None:
        np.testing.assert_array_equal(got_mask.numpy(),
                                      np.asarray(want_mask))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vertex_output_type_matches_jax(case):
    jv, xs, _, its = CASES[case]
    its = its[:len(xs)]
    pits = [InputType.from_dict(t.to_dict()) for t in its]
    assert _port(jv).output_type(*pits).to_dict() == \
        jv.output_type(*its).to_dict()


def test_every_vertex_is_covered_and_round_trips():
    """The registry holds the reference's 13 vertices; each one's dict
    form equals the reference's and builds the same vertex back."""
    assert sorted(pgraph.VERTEX_REGISTRY) == sorted(jgraph.VERTEX_REGISTRY)
    assert len(pgraph.VERTEX_REGISTRY) == 13
    covered = {type(jv).__name__ for jv, _, _, _ in CASES.values()}
    assert covered == set(pgraph.VERTEX_REGISTRY)
    for jv, _, _, _ in CASES.values():
        pv = _port(jv)
        assert json.dumps(pv.to_dict(), sort_keys=True) == \
            json.dumps(jv.to_dict(), sort_keys=True)
        again = pgraph.vertex_from_dict(pv.to_dict())
        assert again.to_dict() == pv.to_dict()
    with pytest.raises(ValueError, match="Unknown vertex type"):
        pgraph.vertex_from_dict({"type": "NoSuchVertex"})


def test_elementwise_refuses_what_the_reference_refuses():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="exactly 2"):
        pgraph.ElementWiseVertex(op="subtract").forward([x, x, x])
    with pytest.raises(ValueError, match="Unknown"):
        pgraph.ElementWiseVertex(op="median").forward([x, x])
