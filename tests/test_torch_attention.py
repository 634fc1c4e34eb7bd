"""The port's SelfAttentionLayer against the JAX package's.

The same numpy-seeded parameters, inputs and output gradient go through
the reference layer (``deeplearning4j_tpu.nn.layers.SelfAttentionLayer``)
and the port's, by each built-in route (dense, and blockwise when
``block_size`` is set), causal or not, masked or not, residual or not,
with 1 and 2 heads. On the CPU the port's flash helper declines (it
takes CUDA tensors only), so the layer runs its built-in route; the
reference's flash helper would take the unmasked calls, so the JAX side
runs with ``DL4J_TPU_DISABLE_HELPERS=1`` (its built-in route) and the
helper itself is held separately: the port's ``FlashAttentionHelper``
on CPU tensors (the kernels' plain twin) against the reference's in
Pallas interpret mode.

Tolerances: 1e-5 of each tensor's max abs (f32; summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import (RnnOutputLayer as JRnnOut,
                                          SelfAttentionLayer as JAttn)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer, \
    layer_from_dict

TOL = 1e-5
B, T, D = 3, 12, 8


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture
def jax_builtin(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DISABLE_HELPERS", "1")


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _layers(**kw):
    jl = JAttn(n_in=D, n_out=D, **kw).apply_global_defaults({})
    pl = layer_from_dict(jl.to_dict())
    return jl, pl


def _data(seed, masked):
    r = np.random.RandomState(seed)
    params = {"Wq": r.randn(D, D), "Wk": r.randn(D, D), "Wv": r.randn(D, D),
              "Wo": r.randn(D, D), "b": r.randn(D)}
    params = {k: (0.4 * v).astype(np.float32) for k, v in params.items()}
    x = r.randn(B, T, D).astype(np.float32)
    g = r.randn(B, T, D).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 9:] = 0.0
        mask[1, :3] = 0.0
        mask[2, 5] = 0.0
    return params, x, g, mask


def _jax_run(layer, params, x, g, mask):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        out, _ = layer.forward(p, xx, {}, mask=jm)
        return jnp.sum(out * g), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(jp, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


def _port_run(layer, params, x, g, mask):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tm = None if mask is None else torch.tensor(mask)
    out, _ = layer.forward(tp, tx, {}, mask=tm)
    gp = torch.autograd.grad((out * torch.tensor(g)).sum(),
                             list(tp.values()) + [tx])
    return out.detach().numpy(), \
        {k: v.numpy() for k, v in zip(tp, gp[:-1])}, gp[-1].numpy()


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("route", ["dense", "blockwise"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_layer_forward_and_gradients_match_jax(jax_builtin, heads, causal,
                                               route, masked, residual):
    kw = dict(n_heads=heads, causal=causal, residual=residual)
    if route == "blockwise":
        kw["block_size"] = 5          # ragged last block (T 12)
    jl, pl = _layers(**kw)
    params, x, g, mask = _data(heads * 7 + causal, masked)
    j_out, j_gp, j_gx = _jax_run(jl, params, x, g, mask)
    p_out, p_gp, p_gx = _port_run(pl, params, x, g, mask)
    _close(p_out, j_out, what="output")
    _close(p_gx, j_gx, what="dx")
    for k in j_gp:
        _close(p_gp[k], j_gp[k], what=f"d{k}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_helper_twin_matches_jax_helper(interpret_pallas, causal):
    """The port's helper on CPU tensors (the kernels' plain twin) against
    the reference's helper (its Pallas kernel in interpret mode), forward
    and gradients, at the layer's [batch, heads, T, d] layout."""
    r = np.random.RandomState(5)
    q, k, v, g = (r.randn(2, 2, 16, 4).astype(np.float32) for _ in range(4))
    jh, ph = jhelpers.FlashAttentionHelper(), helpers.FlashAttentionHelper()

    def f(a, b, c):
        out = jh.attention(a, b, c, causal=causal, block_size=8)
        return jnp.sum(out * g), out

    (_, j_out), j_grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    p_out = ph.attention(tq, tk, tv, causal=causal, block_size=8)
    p_grads = torch.autograd.grad((p_out * torch.tensor(g)).sum(),
                                  (tq, tk, tv))
    _close(p_out.detach().numpy(), j_out, what="O")
    for name, pg, jg in zip("qkv", p_grads, j_grads):
        _close(pg.numpy(), jg, what=f"d{name}")


def test_helper_declines_cpu_and_mask_and_counts():
    layer = SelfAttentionLayer(n_in=4, n_out=4).apply_global_defaults({})
    helper = helpers.get_helper(layer)
    assert isinstance(helper, helpers.FlashAttentionHelper)
    q = torch.zeros(1, 1, 4, 4)
    assert not helper.supports(layer, mask=None, q=q)           # CPU
    meta = torch.zeros(1, 1, 4, 4, device="meta")
    assert not helper.supports(layer, mask=torch.ones(1, 4), q=meta)
    params = {k: torch.zeros(s) for k, s in layer.param_shapes().items()}
    before = helpers.declines("SelfAttentionLayer")
    layer.forward(params, torch.zeros(1, 4, 4), {})
    assert helpers.declines("SelfAttentionLayer") == before + 1


def _net_confs(**kw):
    def conf(b):
        return (b.seed(3).learning_rate(0.05).updater("adam").list()
                .layer(JAttn(n_in=6, n_out=6, n_heads=2, **kw))
                .layer(JAttn(n_in=6, n_out=6, n_heads=3, residual=True))
                .layer(JRnnOut(n_in=6, n_out=4, activation="softmax",
                               loss="mcxent"))
                .build())
    jconf = conf(JBuilder.Builder())
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _np_tree(tree):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


def test_json_round_trip_and_flat_params_order():
    """A JSON config naming the layer builds in both packages and writes
    the same JSON back; the flat ``params()`` vector is the reference's
    (Wq, Wk, Wv, Wo, b per layer) once the port holds the JAX net's
    parameters."""
    jconf, pconf = _net_confs(causal=True, block_size=4)
    assert pconf.to_json() == jconf.to_json()
    assert isinstance(pconf.layers[0], SelfAttentionLayer)
    assert pconf.layers[0].param_order == ["Wq", "Wk", "Wv", "Wo", "b"]
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    assert pnet.num_params() == jnet.num_params()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    np.testing.assert_array_equal(pnet.params(), np.asarray(jnet.params()))
    again = MultiLayerNetwork(pconf, device="cpu").init()
    again.set_params(np.asarray(jnet.params()))
    for a, b in zip(again.params_list, pnet.params_list):
        for k in a:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("masked", [False, True])
def test_net_output_and_fit_steps_match_jax(jax_builtin, masked):
    """The slice as a whole: two attention layers and an RnnOutputLayer,
    output and three adam steps from the same parameters, masked or not."""
    jconf, pconf = _net_confs(causal=True)
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    r = np.random.RandomState(1)
    x = r.randn(4, 10, 6).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.randint(0, 4, (4, 10))]
    m = None
    if masked:
        m = np.ones((4, 10), np.float32)
        m[1, 7:] = 0.0
    _close(pnet.output(x, fmask=m), np.asarray(jnet.output(x, fmask=m)),
           what="output")
    for step in range(3):
        js = float(jnet.fit_batch(x, y, m, m))
        ps = float(pnet.fit_batch(x, y, m, m))
        assert abs(ps - js) <= 1e-5 * abs(js), step
    for jp, pp in zip(jnet.params_list, pnet.params_list):
        for k in jp:
            _close(pp[k].detach().numpy(), np.asarray(jp[k]), what=k)


def test_sequence_axis_raises_naming_the_roadmap():
    """The ring branch is ported (tests/test_torch_sequence_parallel.py
    holds it on ranks): outside a grid with the layer's axis it raises,
    naming how to make one; on a one-rank grid it is the dense branch."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
    layer = SelfAttentionLayer(n_in=4, n_out=4, sequence_axis="sp") \
        .apply_global_defaults({})
    dense = SelfAttentionLayer(n_in=4, n_out=4).apply_global_defaults({})
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s, generator=g)
              for k, s in layer.param_shapes().items()}
    x = torch.randn(1, 4, 4, generator=g)
    with pytest.raises(ValueError, match="tp_mesh"):
        layer.forward(params, x, {})
    with TPMesh(1, 1, 0, 0, axis_names=("data", "sp")):
        out, _ = layer.forward(params, x, {})
    torch.testing.assert_close(out, dense.forward(params, x, {})[0],
                               rtol=0, atol=1e-6)
