"""The port's Keras RPC server (``modelimport/keras_server.py``) against the
reference's (``tests/test_keras_server.py``): POST /fit on ``.h5`` and
``.npz`` minibatch directories trains the imported net (here on the CPU:
``device="cpu"``), GET /status reports the last fit, the saved archive
restores, and errors come back as status 400 with the server still up.

The same model file and minibatches go through the JAX package's server;
the final scores agree within 1e-5 (f32, summation order only), and the
saved archives hold parameters within 1e-5 of each other's scale.
"""

import json
import os
import urllib.error
import urllib.request

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.modelimport.keras_server import (
    KerasRPCServer as JServer)
from deeplearning4j_tpu.parallel.training_master import save_dataset
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.modelimport.keras_server import (
    KerasRPCServer, load_dataset)
from deeplearning4j_tpu_torch.utils.model_serializer import restore_model
from tests.test_keras_import import seq_config, write_keras_file


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture
def model_file(tmp_path):
    r = np.random.RandomState(0)
    cfg = seq_config([
        {"class_name": "Dense", "config": {
            "name": "dense_1", "output_dim": 10,
            "batch_input_shape": [None, 6], "activation": "relu"}},
        {"class_name": "Dense", "config": {
            "name": "dense_2", "output_dim": 3, "activation": "softmax"}}])
    p = str(tmp_path / "model.h5")
    write_keras_file(p, cfg, {
        "dense_1": [("dense_1_W", 0.3 * r.randn(6, 10)),
                    ("dense_1_b", np.zeros(10))],
        "dense_2": [("dense_2_W", 0.3 * r.randn(10, 3)),
                    ("dense_2_b", np.zeros(3))]},
        training_config={"loss": "categorical_crossentropy"})
    return p


def _batches(n, rows, seed):
    r = np.random.RandomState(seed)
    return [(r.randn(rows, 6).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.randint(0, 3, rows)])
            for _ in range(n)]


@pytest.fixture
def port_server():
    srv = KerasRPCServer(device="cpu").start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_fit_matches_the_reference_server(tmp_path, model_file, port_server,
                                          fmt):
    data = tmp_path / "mb"
    data.mkdir()
    for i, (x, y) in enumerate(_batches(3, 16, 1)):
        if fmt == "h5":
            with h5py.File(str(data / f"batch_{i}.h5"), "w") as f:
                f.create_dataset("features", data=x)
                f.create_dataset("labels", data=y)
        else:
            save_dataset(JDataSet(x, y), str(data / f"b{i}.npz"))
    req = {"model_path": model_file, "data_dir": str(data), "epochs": 2}
    got = _post(port_server.port, "/fit",
                dict(req, save_path=str(tmp_path / "port.zip")))
    with JServer() as jsrv:
        want = _post(jsrv.port, "/fit",
                     dict(req, save_path=str(tmp_path / "jax.zip")))
    assert got["status"] == want["status"] == "ok"
    assert (got["batches"], got["epochs"]) == (want["batches"],
                                               want["epochs"]) == (3, 2)
    assert got["model_type"] == want["model_type"] == "MultiLayerNetwork"
    assert abs(got["final_score"] - want["final_score"]) <= \
        1e-5 * abs(want["final_score"])
    assert np.isfinite(got["first_score"]) and got["seconds"] >= 0
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port_server.port}/status",
            timeout=10) as resp:
        assert json.loads(resp.read())["last_fit"] == got
    net = restore_model(str(tmp_path / "port.zip"), device="cpu")
    from deeplearning4j_tpu.utils.model_serializer import (
        restore_model as jrestore)
    jnet = jrestore(str(tmp_path / "jax.zip"))
    want_p = np.asarray(jnet.params())
    assert np.abs(net.params() - want_p).max() <= \
        1e-5 * np.abs(want_p).max()


def test_load_dataset_reads_the_export_format(tmp_path):
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    r = np.random.RandomState(2)
    x, y = r.randn(4, 6).astype(np.float32), r.rand(4, 3).astype(np.float32)
    m = np.ones((4, 6), np.float32)
    save_dataset(JDataSet(x, y, features_mask=m), str(tmp_path / "a.npz"))
    ds = load_dataset(str(tmp_path / "a.npz"))
    assert isinstance(ds, DataSet) and ds.labels_mask is None
    for got, want in ((ds.features, x), (ds.labels, y),
                      (ds.features_mask, m)):
        np.testing.assert_array_equal(got, want)
    save_dataset(JMDS([x, x], [y]), str(tmp_path / "b.npz"))
    mds = load_dataset(str(tmp_path / "b.npz"))
    assert isinstance(mds, MultiDataSet)
    assert len(mds.features) == 2 and len(mds.labels) == 1
    assert mds.features_masks is None


def test_errors_reported_not_fatal(tmp_path, model_file, port_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port_server.port, "/fit", {"model_path": "/nope.h5",
                                         "data_dir": "/nowhere"})
    assert e.value.code == 400
    assert "not found" in json.loads(e.value.read())["error"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(urllib.error.HTTPError) as e2:
        _post(port_server.port, "/fit", {"model_path": model_file,
                                         "data_dir": str(tmp_path / "empty")})
    assert e2.value.code == 400
    assert "minibatch" in json.loads(e2.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e3:
        _post(port_server.port, "/nothing", {})
    assert e3.value.code == 404
    # the server still answers, and a good fit still runs
    data = tmp_path / "mb"
    data.mkdir()
    x, y = _batches(1, 8, 3)[0]
    save_dataset(JDataSet(x, y), str(data / "b0.npz"))
    r = _post(port_server.port, "/fit", {"model_path": model_file,
                                         "data_dir": str(data)})
    assert r["status"] == "ok" and r["batches"] == 1
    assert port_server.last_result == r
    assert os.path.exists(model_file)


def test_lenet_fixture_fine_tunes_through_fit(tmp_path, port_server):
    """The committed Keras LeNet fine-tuned for 2 epochs through POST /fit
    on ``.npz`` minibatches of the fixture's 320 training digits (the
    ``keras`` phase of ``chip_smoke.py``, on the CPU): the held-out
    accuracy stays at or above 0.90."""
    from pathlib import Path

    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    here = Path(__file__).resolve().parent / "fixtures"
    train = MnistDataSetIterator(64, data_dir=str(here / "real_mnist"))
    test = MnistDataSetIterator(64, train=False,
                                data_dir=str(here / "real_mnist"))
    data = tmp_path / "mb"
    data.mkdir()
    for i in range(0, len(train.features), 64):
        save_dataset(JDataSet(train.features[i:i + 64],
                              train.labels[i:i + 64]),
                     str(data / f"b{i // 64:03d}.npz"))
    r = _post(port_server.port, "/fit", {
        "model_path": str(here / "keras" / "lenet_k1_tf.h5"),
        "data_dir": str(data), "epochs": 2,
        "save_path": str(tmp_path / "tuned.zip")})
    assert r["status"] == "ok" and r["batches"] == 5
    assert np.isfinite(r["first_score"]) and np.isfinite(r["final_score"])
    net = restore_model(str(tmp_path / "tuned.zip"), device="cpu")
    acc = float((net.output(test.features).argmax(1)
                 == test.label_ids).mean())
    assert acc >= 0.90
