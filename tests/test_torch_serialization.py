"""Model archives and training checkpoints of the port, against the JAX
package's and against the port's own uninterrupted runs, on the CPU.

- An archive the JAX package writes restores in the port, and one the
  port writes restores in the JAX package (its manifest passes the
  reference's check, its configuration JSON is read by the reference):
  parameters, updater state and layer state arrive bitwise, outputs
  within 1e-5 of their max abs, and one more training step on each side
  agrees within 1e-5 of each leaf's max abs (the updater-state vector is
  in the reference's leaf order: Adam, Nesterov momentum, RMSProp);
- the two committed archives of the reference (``convbn_r3``, a
  conv→BN→pool→output net with an NHWC flatten, and ``lstm_r3``, a
  GravesLSTM) reproduce their recorded outputs within 1e-5, as the
  reference's own test holds them;
- a torn or bit-flipped archive raises ``CheckpointCorruptError``
  (through the ported ``corrupt-ckpt`` fault site), and a kill between
  the temporary write and the rename leaves the previous archive;
- a run resumed from a checkpoint equals the uninterrupted run bitwise,
  on the fused loop and on the per-batch loop;
- the guard's patience raises ``TrainingDivergedError`` and leaves the
  model's archive.
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.utils import atomic_io as jatomic
from deeplearning4j_tpu.utils import flat_params as jflat
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.errors import (CheckpointCorruptError,
                                             TrainingDivergedError)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.utils import (flat_params, model_serializer,
                                            training_checkpoint)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "checkpoints")
REL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.array(tree)


def _assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (what, err, scale)


def _assert_trees_equal(got, want, what=""):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_array_equal(got, want, err_msg=what)


def _convbn(updater="adam"):
    """conv (no bias) → BN → max-pool → softmax output over an NHWC
    flatten, as the committed ``convbn_r3`` archive."""
    return (JBuilder.Builder().seed(3).learning_rate(0.05).updater(updater)
            .list()
            .layer(jlayers.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                            padding=(1, 1), has_bias=False,
                                            activation="identity"))
            .layer(jlayers.BatchNormalization())
            .layer(jlayers.SubsamplingLayer(pooling_type="max",
                                            kernel_size=(2, 2),
                                            stride=(2, 2)))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())


def _small_cnn(updater="nesterovs"):
    return (JBuilder.Builder().seed(7).learning_rate(0.02).updater(updater)
            .momentum(0.9).list()
            .layer(jlayers.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                            activation="relu"))
            .layer(jlayers.SubsamplingLayer(pooling_type="max",
                                            kernel_size=(2, 2),
                                            stride=(2, 2)))
            .layer(jlayers.DenseLayer(n_out=8, activation="relu"))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())


def _charrnn():
    return jzoo.char_rnn(vocab_size=6, hidden=8, tbptt_length=5,
                         learning_rate=0.01)


def _cnn_batch(seed, rows=6):
    r = np.random.RandomState(seed)
    return (r.rand(rows, 8, 8, 1).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, rows)])


def _char_batch(seed, rows=3, t=10):
    ids = np.random.RandomState(seed).randint(0, 6, (rows, t + 1))
    eye = np.eye(6, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


# name -> (configuration, batch maker)
MODELS = {"convbn_adam": (_convbn, _cnn_batch),
          "cnn_nesterovs": (_small_cnn, _cnn_batch),
          "charrnn_rmsprop": (_charrnn, _char_batch)}


def _trained_jax(name, steps=2):
    build, batch = MODELS[name]
    net = JNet(build()).init()
    for s in range(steps):
        net.fit_batch(*batch(s))
    return net


def _trained_port(name, steps=2):
    build, batch = MODELS[name]
    jnet = JNet(build()).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        build().to_json()), device="cpu").init()
    net.params_list = params_from_numpy(
        net.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    for s in range(steps):
        net.fit_batch(*batch(s))
    return net


def _same_state(pnet, jnet):
    """The two nets hold the same parameters, updater and layer state,
    bit for bit, and the same counters."""
    np.testing.assert_array_equal(pnet.params(), np.asarray(jnet.params()))
    for i, (pu, ju) in enumerate(zip(pnet.updater_states,
                                     jnet.updater_states)):
        _assert_trees_equal(pu, ju, f"updater {i}")
    for i, (ps, js) in enumerate(zip(pnet.states_list, jnet.states_list)):
        _assert_trees_equal(ps, js, f"state {i}")
    assert pnet.iteration == jnet.iteration
    assert pnet.epoch_count == jnet.epoch_count


def _one_more_step_agrees(pnet, jnet, name):
    batch = MODELS[name][1](99)
    pnet.fit_batch(*batch)
    jnet.fit_batch(*batch)
    for i, (pp, jp) in enumerate(zip(pnet.params_list, jnet.params_list)):
        for k in jp:
            _assert_close(_np_tree(pp[k]), np.asarray(jp[k]), f"{i}.{k}")
    _assert_close(pnet.output(batch[0]), np.asarray(jnet.output(batch[0])),
                  "output")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_archive_restores_in_the_port(tmp_path, name):
    jnet = _trained_jax(name)
    path = str(tmp_path / "jax.zip")
    jser.write_model(jnet, path)
    assert model_serializer.model_type(path) == "MultiLayerNetwork"
    pnet = model_serializer.restore_model(path, device="cpu")
    _same_state(pnet, jnet)
    x = MODELS[name][1](50)[0]
    _assert_close(pnet.output(x), np.asarray(jnet.output(x)), "output")
    _one_more_step_agrees(pnet, jnet, name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_archive_restores_in_jax(tmp_path, name):
    pnet = _trained_port(name)
    path = str(tmp_path / "port.zip")
    model_serializer.write_model(pnet, path)
    jatomic.open_zip_verified(path).close()      # the reference's check
    entries = jatomic.read_zip_entries(path)
    meta = json.loads(entries["metadata.json"])
    assert meta == {"model_type": "MultiLayerNetwork",
                    "iteration": pnet.iteration, "epoch": 0,
                    "framework": "deeplearning4j_tpu_torch",
                    "dropout_draws": pnet.dropout_draws}
    assert entries["configuration.json"].decode() == pnet.conf.to_json()
    jnet = jser.restore_multi_layer_network(path)
    _same_state(pnet, jnet)
    np.testing.assert_array_equal(
        flat_params.updater_state_to_vector_np(pnet.layers,
                                               pnet.updater_states),
        jflat.updater_state_to_vector_np(jnet.layers, jnet.updater_states))
    _one_more_step_agrees(pnet, jnet, name)


@pytest.mark.parametrize("name", ["convbn_r3", "lstm_r3"])
def test_committed_archives_reproduce_their_outputs(name):
    path = os.path.join(FIXTURES, f"{name}.zip")
    net = model_serializer.restore_model(path, device="cpu")
    with np.load(os.path.join(FIXTURES, f"{name}_expected.npz")) as z:
        probe, want = z["probe"], z["out"]
    np.testing.assert_allclose(net.output(probe), want, atol=1e-5)
    assert net.iteration == 5
    # the updater state restores: training goes on
    if name == "convbn_r3":
        rng = np.random.RandomState(0)
        net.fit(DataSet(rng.rand(8, 8, 8, 1).astype(np.float32),
                        np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]))
        assert np.isfinite(net.score_)
        # its preprocessor.bin reads as the reference reads it
        norm = model_serializer.restore_normalizer_from_file(path)
        want = jser.restore_normalizer_from_file(path)
        assert type(norm).__name__ == type(want).__name__
        for k, v in vars(want).items():
            np.testing.assert_array_equal(getattr(norm, k), v)


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_damaged_archive_raises_the_typed_error(tmp_path, mode):
    pnet = _trained_port("cnn_nesterovs", steps=1)
    path = str(tmp_path / "m.zip")
    with faults.inject(f"corrupt-ckpt[{mode}]@0"):
        model_serializer.write_model(pnet, path)
    with pytest.raises(CheckpointCorruptError):
        model_serializer.restore_multi_layer_network(path, device="cpu")
    with pytest.raises(Exception):
        jser.restore_multi_layer_network(path)   # the reference agrees


def test_kill_during_commit_leaves_the_previous_archive(tmp_path):
    pnet = _trained_port("cnn_nesterovs", steps=1)
    path = str(tmp_path / "m.zip")
    model_serializer.write_model(pnet, path)
    before = pnet.params()
    pnet.fit_batch(*_cnn_batch(5))
    with faults.inject("kill-during-ckpt@0"):
        with pytest.raises(RuntimeError, match="kill-during-ckpt"):
            model_serializer.write_model(pnet, path)
    assert os.path.exists(path + ".tmp")
    again = model_serializer.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(again.params(), before)


# ---------------------------------------------------------------------------
# training checkpoints: resume equals the uninterrupted run
# ---------------------------------------------------------------------------
def _stream(n=10, rows=6):
    return [DataSet(*_cnn_batch(100 + i, rows)) for i in range(n)]


def _fresh_cnn():
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _small_cnn().to_json()), device="cpu").init()


@pytest.mark.parametrize("at", ["first_group", "second_epoch"])
@pytest.mark.parametrize("path", ["fused", "per_batch"])
def test_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch, path, at):
    """Ten batches a epoch, two epochs, a checkpoint every 4 updates (K 4
    on the fused path: one a group). A fresh net resumed from the
    checkpoint after the first group, or from one in the second epoch,
    ends where the uninterrupted run ended, bit for bit."""
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "4" if path == "fused"
                       else "1")
    monkeypatch.setenv("DL4J_TORCH_CKPT_KEEP", "100")
    data = _stream()
    full_dir = str(tmp_path / "full")
    full = _fresh_cnn()
    full.fit(ListDataSetIterator(data), epochs=2, checkpoint_every=4,
             checkpoint_dir=full_dir)
    if path == "fused":
        assert full._last_fuse_stats["fused_groups"] == 6   # 4, 4, 2 twice
    files = training_checkpoint.checkpoint_files(full_dir)
    # fused: groups of 4, 4 and 2 a epoch, a checkpoint at the first group
    # boundary 4 or more updates after the last
    assert [it for it, _ in files] == ([4, 8, 14, 18] if path == "fused"
                                       else [4, 8, 12, 16, 20])
    pick = files[0] if at == "first_group" else files[2]
    resume_dir = tmp_path / "resume"
    resume_dir.mkdir()
    shutil.copy(os.path.join(full_dir, pick[1]), resume_dir / pick[1])
    net = _fresh_cnn()
    net.fit(ListDataSetIterator(data), epochs=2, checkpoint_every=4,
            resume_from=str(resume_dir))
    assert net.iteration == full.iteration == 20
    assert net.epoch_count == full.epoch_count
    np.testing.assert_array_equal(net.params(), full.params())
    for a, b in zip(net.updater_states, full.updater_states):
        _assert_trees_equal(a, b)
    assert net.dropout_draws == full.dropout_draws
    # the resumed run committed the later checkpoints itself
    assert training_checkpoint.checkpoint_files(str(resume_dir))[-1] == \
        files[-1]


def test_resume_falls_back_past_a_corrupt_newest_checkpoint(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "1")
    d = str(tmp_path / "ck")
    net = _fresh_cnn()
    net.fit(ListDataSetIterator(_stream(4)), checkpoint_every=2,
            checkpoint_dir=d)
    newest = os.path.join(d, "ckpt_4.zip")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert training_checkpoint.latest_checkpoint(d).endswith(
            "ckpt_2.zip")
    again = _fresh_cnn()
    with pytest.warns(RuntimeWarning, match="falling back"):
        cursor = training_checkpoint.resume_latest(again, d)
    assert cursor == {"epoch": 0, "batch": 2} and again.iteration == 2


def test_kinds_not_ported_raise_and_name_the_roadmap(tmp_path):
    """A model that is no MultiLayerNetwork, ComputationGraph or
    pytree-family model raises ``NotImplementedError`` naming ROADMAP.md;
    every archive kind is ported now (MoETransformerLM and ViT too), so
    a ComputationGraph, TransformerLM, MoETransformerLM or ViT archive
    goes to its restore (these, which have no configuration, fail there
    as corrupt archives)."""
    from deeplearning4j_tpu_torch.errors import CheckpointCorruptError
    from deeplearning4j_tpu_torch.utils import atomic_io
    for kind in ("ComputationGraph", "TransformerLM", "MoETransformerLM",
                 "ViT"):
        path = str(tmp_path / f"{kind}.zip")
        atomic_io.write_zip_atomic(path, {"metadata.json": json.dumps(
            {"model_type": kind, "iteration": 0})})
        assert model_serializer.model_type(path) == kind
        with pytest.raises(CheckpointCorruptError,
                           match="configuration.json"):
            model_serializer.restore_model(path, device="cpu")

    class Unported:
        pass
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_serializer.write_model(Unported(), str(tmp_path / "x.zip"))


def test_checkpoint_arguments_need_an_iterator_and_a_directory(tmp_path):
    net = _fresh_cnn()
    ds = DataSet(*_cnn_batch(0))
    with pytest.raises(ValueError, match="iterator"):
        net.fit(ds, checkpoint_every=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        net.fit(ListDataSetIterator([ds]), checkpoint_every=1)


# ---------------------------------------------------------------------------
# the guard's divergence policy
# ---------------------------------------------------------------------------
def _poisoned(stream, bad):
    out = []
    for i, ds in enumerate(stream):
        x = ds.features.copy()
        if i in bad:
            x[:] = np.nan
        out.append(DataSet(x, ds.labels))
    return out


def test_patience_raises_and_leaves_the_model_archive(tmp_path,
                                                      monkeypatch):
    """Batches 2-4 are NaN: three consecutive dispatches with a reverted
    step. The guard reads each counter one dispatch late, so the policy
    trips at batch 5's dispatch, writes the model (no bad step touched
    its parameters) and raises."""
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "1")
    ckpt = str(tmp_path / "diverged.zip")
    monkeypatch.setenv("DL4J_TORCH_NANGUARD_CKPT", ckpt)
    net = _fresh_cnn()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(TrainingDivergedError, match="diverged.zip"):
            net.fit(ListDataSetIterator(_poisoned(_stream(8), {2, 3, 4})))
    # batch 5's update was dispatched before the read that tripped
    assert net.nan_skipped_steps == 3 and net.iteration == 5
    saved = model_serializer.restore_multi_layer_network(ckpt, device="cpu")
    np.testing.assert_array_equal(saved.params(), net.params())
    assert np.isfinite(saved.params()).all()


def test_fewer_bad_dispatches_than_patience_only_warn(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "1")
    net = _fresh_cnn()
    stream = _poisoned(_stream(8), {1, 2, 4, 5})
    with pytest.warns(RuntimeWarning, match="reverted"):
        net.fit(ListDataSetIterator(stream))
    assert net.nan_skipped_steps == 4 and net._nan_bad_consec == 0
    clean = _fresh_cnn()
    clean.fit(ListDataSetIterator([d for i, d in enumerate(_stream(8))
                                   if i not in {1, 2, 4, 5}]))
    np.testing.assert_array_equal(net.params(), clean.params())


def test_directory_commit_round_trips_and_detects_damage(tmp_path):
    """The directory form of the atomic commit: the manifest passes both
    packages' checks, a kill before the rename keeps the previous
    directory, a damaged payload raises, and a directory parked at
    ``.old`` by a crash inside the swap is rolled back."""
    from deeplearning4j_tpu_torch.utils import atomic_io

    def stage(name, payload):
        d = tmp_path / name
        (d / "sub").mkdir(parents=True)
        atomic_io.write_file(d / "a.bin", payload)
        atomic_io.write_file(d / "sub" / "b.txt", "text")
        return str(d)
    final = str(tmp_path / "ckpt")
    atomic_io.commit_dir_atomic(stage("t1", b"first"), final)
    assert set(atomic_io.verify_dir_manifest(final)) == {"a.bin", "sub/b.txt"}
    assert set(jatomic.verify_dir_manifest(final)) == {"a.bin", "sub/b.txt"}
    with faults.inject("kill-during-ckpt@0"):
        with pytest.raises(RuntimeError, match="kill-during-ckpt"):
            atomic_io.commit_dir_atomic(stage("t2", b"second"), final)
    assert (tmp_path / "ckpt" / "a.bin").read_bytes() == b"first"
    with open(os.path.join(final, "a.bin"), "r+b") as f:
        f.write(b"F")
    with pytest.raises(CheckpointCorruptError, match="CRC"):
        atomic_io.verify_dir_manifest(final)
    os.replace(final, final + ".old")
    atomic_io.recover_dir(final)
    assert os.path.isdir(final) and not os.path.exists(final + ".old")
