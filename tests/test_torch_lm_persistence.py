"""TransformerLM archives and training checkpoints of the port, against
the JAX package's and against the port's own uninterrupted runs, on the
CPU.

- An LM archive the JAX package writes restores in the port, and one the
  port writes restores in the JAX package: parameters and optimizer
  state arrive bitwise, and ``output()`` agrees within 1e-6 of the
  logits' max abs (f32; the two frameworks sum the matmuls in another
  order).
- The flat vectors follow the reference's leaf order
  (``jax.tree.leaves``: keys sorted as strings at every level): checked
  at 12 layers (``b0, b1, b10, b11, b2, ...``) with rope (no ``wpe``),
  GQA (a narrower ``qkv``) and an EMA (``ema``, then ``m``, then ``v``).
- A run resumed from a checkpoint (the port's own archive, applied in
  place) equals the uninterrupted run bitwise, with dropout 0 and 0.1
  (the dropout generator's state rides in the archive).
- A JAX archive with its threefry ``rng`` loads; the port starts its
  dropout stream afresh, as ``init`` seeds it.
- ``MoETransformerLM`` and ``ViT`` archives cross both ways the same
  way (parameters and optimizer state bitwise, outputs within 1e-6 of
  their max abs), and the port's own round trip, by archive and by
  training checkpoint in place, gives the same output and the same next
  step, bitwise; every not-ported error of the package names an item
  that ``ROADMAP.md`` queue 1 still has.
"""

import ast
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.moe_transformer import (
    MoETransformerConfig as JaxMoEConfig, MoETransformerLM as JaxMoE)
from deeplearning4j_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from deeplearning4j_tpu.models.vit import ViT as JaxViT, ViTConfig as \
    JaxViTConfig
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu_torch.models.moe_transformer import (
    MoETransformerConfig, MoETransformerLM)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, _flatten, leaf_paths,
    opt_state_from_numpy, params_from_numpy)
from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
from deeplearning4j_tpu_torch.serving import ContinuousLM
from deeplearning4j_tpu_torch.utils import (model_serializer,
                                            training_checkpoint)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=64, max_len=32, d_model=32, n_heads=4, n_layers=2,
             d_ff=64, learning_rate=1e-3)
VARIANTS = {"learned": {}, "rope_gqa": dict(pos_embed="rope", n_kv_heads=2)}
OUT_REL = 1e-6


def _tokens(seed, rows=2, t=17):
    return np.random.RandomState(seed).randint(0, 64, (rows, t)).astype(
        np.int32)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _torch_np(tree):
    return {k: v.detach().numpy() for k, v in _flatten(tree).items()}


def _jax_flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(port_tree, jax_tree):
    got, want = _torch_np(port_tree), _jax_flat(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_out_close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= OUT_REL * scale


def _jax_lm(variant, steps=1, **extra):
    jlm = JaxLM(JaxConfig(**dict(SMALL, **VARIANTS[variant], **extra))).init()
    for s in range(steps):
        jlm.fit_batch(_tokens(10 + s))
    return jlm


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_archive_restores_in_the_port(tmp_path, variant):
    jlm = _jax_lm(variant)
    path = str(tmp_path / "lm.zip")
    jser.write_model(jlm, path)
    lm = model_serializer.restore_model(path, device="cpu")
    assert isinstance(lm, TransformerLM) and lm.iteration == 1
    _assert_trees_equal(lm.params, jlm.params)
    _assert_trees_equal(lm.opt_state, jlm.opt_state)
    x = _tokens(3, t=16)
    _assert_out_close(lm.output(x), np.asarray(jlm.output(x)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_archive_restores_in_the_reference(tmp_path, variant):
    lm = TransformerLM(TransformerConfig(**dict(SMALL, **VARIANTS[variant])),
                       device="cpu").init()
    lm.fit_batch(_tokens(10))
    path = str(tmp_path / "lm.zip")
    model_serializer.write_model(lm, path)
    assert jser.model_type(path) == "TransformerLM"
    jlm = jser.restore_model(path)
    assert int(jlm.iteration) == 1 and getattr(jlm, "_rng", None) is None
    _assert_trees_equal(lm.params, jlm.params)
    _assert_trees_equal(lm.opt_state, jlm.opt_state)
    x = _tokens(3, t=16)
    _assert_out_close(lm.output(x), np.asarray(jlm.output(x)))


def test_leaf_order_is_the_reference_s():
    """12 layers, rope, GQA and an EMA: the flat parameter and updater
    vectors are the reference's ``_tree_vec`` of the same trees, element
    for element."""
    kw = dict(SMALL, n_layers=12, pos_embed="rope", n_kv_heads=2,
              ema_decay=0.9)
    jlm = JaxLM(JaxConfig(**kw)).init()
    jlm.fit_batch(_tokens(10))
    lm = TransformerLM(TransformerConfig(**kw), device="cpu")
    lm.params = params_from_numpy(_np(jlm.params), "cpu")
    lm.opt_state, lm.iteration = opt_state_from_numpy(
        {**_np(jlm.opt_state), "iteration": 1}, "cpu")
    paths = leaf_paths(lm.params)
    assert [p.split(".")[0] for p in paths[::12][:4]] == \
        ["b0", "b1", "b10", "b11"]
    assert paths[:3] == ["b0.fc", "b0.fc_b", "b0.ln1_b"]
    assert paths[-3:] == ["lnf_b", "lnf_g", "wte"]        # no wpe (rope)
    assert [p.split(".")[0] for p in leaf_paths(lm.opt_state)][
        ::len(paths)] == ["ema", "m", "v"]
    assert lm.params["b0"]["qkv"].shape == (32, 32 + 2 * 2 * 8)
    for port_tree, jax_tree in ((lm.params, jlm.params),
                                (lm.opt_state, jlm.opt_state)):
        np.testing.assert_array_equal(model_serializer._tree_vec(port_tree),
                                      jser._tree_vec(jax_tree))


def _run(kw, steps, seed=10):
    lm = TransformerLM(TransformerConfig(**kw), device="cpu").init()
    for s in range(steps):
        lm.fit_batch(_tokens(seed + s))
    return lm


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_resume_equals_the_uninterrupted_run(tmp_path, dropout):
    kw = dict(SMALL, dropout=dropout)
    full = _run(kw, 6)
    part = _run(kw, 3)
    path = training_checkpoint.save_training_checkpoint(part, str(tmp_path))
    fresh = TransformerLM(TransformerConfig(**kw), device="cpu").init()
    before = {k: v.data_ptr() for k, v in _flatten(fresh.params).items()}
    assert training_checkpoint.apply_training_checkpoint(fresh, path) == {}
    assert fresh.iteration == 3
    # loaded in place: the model keeps its tensors
    assert {k: v.data_ptr() for k, v in _flatten(fresh.params).items()} \
        == before
    for s in range(3, 6):
        fresh.fit_batch(_tokens(10 + s))
    for tree in ("params", "opt_state"):
        got = _torch_np(getattr(fresh, tree))
        for k, want in _torch_np(getattr(full, tree)).items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    # the archive alone (write_model / restore_model) carries the stream too
    model_serializer.write_model(part, str(tmp_path / "lm.zip"))
    again = model_serializer.restore_model(str(tmp_path / "lm.zip"),
                                           device="cpu")
    for s in range(3, 6):
        again.fit_batch(_tokens(10 + s))
    np.testing.assert_array_equal(model_serializer._tree_vec(again.params),
                                  model_serializer._tree_vec(full.params))


def test_jax_archive_with_its_rng_loads_and_reseeds(tmp_path):
    """The reference's threefry key cannot be continued here: the port
    starts its dropout stream as ``init`` does (``conf.seed + 1``), so the
    next step equals a fresh port model's from the same parameters."""
    jlm = _jax_lm("learned", dropout=0.1)
    path = str(tmp_path / "lm.zip")
    jser.write_model(jlm, path)
    import json
    import zipfile
    with zipfile.ZipFile(path) as z:
        assert "rng" in json.loads(z.read("metadata.json"))
    lm = model_serializer.restore_model(path, device="cpu")
    assert lm._rng is None
    twin = TransformerLM(TransformerConfig(**dict(SMALL, dropout=0.1)),
                         device="cpu")
    twin.params = params_from_numpy(_np(jlm.params), "cpu")
    twin.opt_state, twin.iteration = opt_state_from_numpy(
        {**_np(jlm.opt_state), "iteration": 1}, "cpu")
    for m in (lm, twin):
        m.fit_batch(_tokens(20))
    np.testing.assert_array_equal(model_serializer._tree_vec(lm.params),
                                  model_serializer._tree_vec(twin.params))


def test_restored_weights_serve_through_an_existing_continuous_lm(tmp_path):
    """An LM behind a ContinuousLM takes another LM's checkpoint in place:
    the server answers with the saved LM's greedy tokens, and its pool
    keeps the model's own tensors."""
    kw = dict(SMALL, max_len=48)
    saved = _run(kw, 2)
    path = str(tmp_path / "lm.zip")
    model_serializer.write_model(saved, path)
    other = TransformerLM(TransformerConfig(**dict(kw, seed=5)),
                          device="cpu").init()
    srv = ContinuousLM(other, slots=2, chunk=4, device="cpu")
    prompts = [np.arange(1, 1 + n, dtype=np.int32) for n in (5, 9, 3)]
    try:
        before = [srv.submit(p, 6).result(120) for p in prompts]
        params = other.params
        training_checkpoint.apply_training_checkpoint(other, path)
        assert other.params is params
        after = [srv.submit(p, 6).result(120) for p in prompts]
    finally:
        srv.stop()
    want = [saved.generate(p[None, :], 6, temperature=0.0)[0]
            for p in prompts]
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)
    assert any(not np.array_equal(b, w) for b, w in zip(before, want))


def test_a_failed_load_leaves_the_model_as_it_was(tmp_path):
    path = str(tmp_path / "lm.zip")
    model_serializer.write_model(_run(dict(SMALL, d_ff=32), 1), path)
    lm = _run(SMALL, 1)
    before = model_serializer._tree_vec(lm.params)
    with pytest.raises(ValueError, match="other shapes"):
        training_checkpoint.apply_training_checkpoint(lm, path)
    np.testing.assert_array_equal(model_serializer._tree_vec(lm.params),
                                  before)
    assert lm.iteration == 1


# the pytree family's other two kinds, at small sizes: (JAX class, JAX
# config, port class, port config, configuration, input of output(),
# training batch)
MOE_KW = dict(SMALL, n_experts=4, router_top_k=2, d_expert=48)
VIT_KW = dict(image_size=8, n_channels=3, patch_size=2, n_classes=5,
              d_model=32, n_heads=4, n_layers=2, d_ff=64,
              learning_rate=1e-3)
_IMAGES = np.random.RandomState(30).rand(4, 8, 8, 3).astype(np.float32)
_LABELS = np.random.RandomState(31).randint(0, 5, 4)
KINDS = {
    "MoETransformerLM": (JaxMoE, JaxMoEConfig, MoETransformerLM,
                         MoETransformerConfig, MOE_KW, _tokens(3, t=16),
                         (_tokens(10),)),
    "ViT": (JaxViT, JaxViTConfig, ViT, ViTConfig, VIT_KW, _IMAGES,
            (_IMAGES, _LABELS)),
}


def _port_model(kind, steps=1, **extra):
    _, _, cls, conf_cls, kw, _, batch = KINDS[kind]
    net = cls(conf_cls(**dict(kw, **extra)), device="cpu").init()
    for _ in range(steps):
        net.fit_batch(*batch)
    return net


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_moe_and_vit_archives_raise_naming_the_roadmap(tmp_path, kind):
    """These archives were refused, naming ROADMAP.md, until the two
    models were ported: now an archive the port writes restores as its
    kind (``restore_model``) with the same output bits, and a training
    checkpoint applied in place to a fresh model continues the run: the
    next step equals the uninterrupted one bitwise (dropout on, so the
    generator's state rides along)."""
    full = _port_model(kind, steps=2, dropout=0.1)
    part = _port_model(kind, steps=1, dropout=0.1)
    path = str(tmp_path / "m.zip")
    model_serializer.write_model(part, path)
    assert model_serializer.model_type(path) == kind
    back = model_serializer.restore_model(path, device="cpu")
    assert type(back) is type(part) and back.iteration == 1
    x, batch = KINDS[kind][5], KINDS[kind][6]
    np.testing.assert_array_equal(back.output(x), part.output(x))
    ck = training_checkpoint.save_training_checkpoint(part, str(tmp_path))
    fresh = _port_model(kind, steps=0, dropout=0.1)
    before = {k: v.data_ptr() for k, v in _flatten(fresh.params).items()}
    training_checkpoint.apply_training_checkpoint(fresh, ck)
    assert {k: v.data_ptr() for k, v in _flatten(fresh.params).items()} \
        == before
    for m in (fresh, back):
        m.fit_batch(*batch)
        for tree in ("params", "opt_state"):
            np.testing.assert_array_equal(
                model_serializer._tree_vec(getattr(m, tree)),
                model_serializer._tree_vec(getattr(full, tree)))
    with pytest.raises(ValueError, match="other shapes"):
        other = _port_model(kind, steps=0, d_ff=32)
        training_checkpoint.apply_training_checkpoint(other, ck)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_moe_and_vit_archives_cross_both_ways(tmp_path, kind):
    jcls, jconf, cls, _, kw, x, batch = KINDS[kind]
    jnet = jcls(jconf(**kw)).init()
    jnet.fit_batch(*batch)
    path = str(tmp_path / "jax.zip")
    jser.write_model(jnet, path)
    net = model_serializer.restore_model(path, device="cpu")
    assert type(net) is cls and net.iteration == 1
    _assert_trees_equal(net.params, jnet.params)
    _assert_trees_equal(net.opt_state, jnet.opt_state)
    _assert_out_close(net.output(x), np.asarray(jnet.output(x)))

    net = _port_model(kind)
    path = str(tmp_path / "port.zip")
    model_serializer.write_model(net, path)
    assert jser.model_type(path) == kind
    back = jser.restore_model(path)
    assert type(back).__name__ == kind and int(back.iteration) == 1
    _assert_trees_equal(net.params, back.params)
    _assert_trees_equal(net.opt_state, back.opt_state)
    _assert_out_close(net.output(x), np.asarray(back.output(x)))


def _queue1_titles():
    text = (REPO / "ROADMAP.md").read_text()
    queue1 = text[text.index("### 1."):text.index("### 2.")]
    return re.findall(r"^\s*\d+\.\s+\*\*([^*]+?)\.?\*\*", queue1, re.M)


def _named_items(path):
    """Every queue 1 item a not-ported message of the file names: the
    literal ones, and the ``item`` arguments of its ``_not_ported``
    helpers (string constants or module-level names)."""
    tree = ast.parse(path.read_text())
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value,
                                                          ast.Constant)
              for t in n.targets if isinstance(t, ast.Name)}
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            found.update(re.findall(r'queue 1, "([^"{]+)"', node.value))
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "_not_ported" \
                and len(node.args) > 1:
            arg = node.args[1]
            if isinstance(arg, ast.Constant):
                found.add(arg.value)
            elif isinstance(arg, ast.Name) and arg.id in consts:
                found.add(consts[arg.id])
    return found


def test_not_ported_messages_name_roadmap_items():
    """The port is whole: ROADMAP.md's queue 1 holds no numbered title
    left to port, and no message of the package names queue 1 (a
    not-ported refusal would name the item it waits for)."""
    assert _queue1_titles() == []
    for path in sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py")):
        assert not _named_items(path), str(path.relative_to(REPO))
        assert "queue 1" not in path.read_text(), \
            str(path.relative_to(REPO))
