"""The port's streaming routes (``deeplearning4j_tpu_torch/streaming``)
against the JAX package's: the DLSA/DLSD serde, the topic broker, the
serve route and the HTTP inference server.

The models carry the JAX model's weights (``params_from_numpy``): a tiny
MultiLayerNetwork from one JSON, and a tiny TransformerLM whose weights
are drawn with numpy from a seed.

Tolerances, with their reasons:
- serde frames, broker payloads: exact, and each package decodes the
  other's bytes;
- predictions through the route and ``/predict``: 1e-5 of the JAX
  model's output (the same math, another summation order);
- ``/generate`` at temperature 0: the JAX model's greedy tokens exactly
  (the test's weights leave no near-tie).
"""

import json
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu import streaming as jstreaming
from deeplearning4j_tpu_torch import streaming
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import multi_layer_network as pmln
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.streaming import (
    DL4JServeRoute, InferenceHTTPServer, MessageBroker, TopicConsumer,
    TopicPublisher, deserialize_array, deserialize_dataset, serialize_array,
    serialize_dataset)

RTOL = 1e-5
LM = dict(vocab_size=50, max_len=64, d_model=16, n_heads=2, n_layers=2,
          d_ff=32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= rtol * scale


def _mln_pair():
    jconf = (JBuilder.Builder().seed(5).list()
             .layer(JDense(n_in=4, n_out=8))
             .layer(JOut(n_in=8, n_out=3, activation="softmax",
                         loss="mcxent"))
             .build())
    jnet = JNet(jconf).init()
    pnet = pmln.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = pmln.params_from_numpy(
        pnet.layers, [{k: np.asarray(v) for k, v in p.items()}
                      for p in jnet.params_list], "cpu")
    return jnet, pnet


def _lm_pair(seed=0):
    jlm = JaxLM(JaxConfig(**LM)).init()
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key.endswith("_g"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(draw, jlm.params)
    jlm.params = jax.tree.map(jnp.asarray, tree)
    plm = TransformerLM(TransformerConfig(**LM), device="cpu")
    plm.params = params_from_numpy(tree, "cpu")
    return jlm, plm


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------
_ARRAYS = {"f32": np.arange(60, dtype=np.float32).reshape(3, 4, 5) / 7,
           "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
           "f64_scalar": np.array(2.5), "bool": np.array([True, False]),
           "empty": np.zeros((0, 4), np.float32)}


@pytest.mark.parametrize("name", sorted(_ARRAYS))
def test_array_frames_cross(name):
    a = _ARRAYS[name]
    got, want = serialize_array(a), jstreaming.serialize_array(a)
    assert got[:4] == want[:4] == b"DLSA"
    for data in (got, want):
        for dec in (deserialize_array, jstreaming.deserialize_array):
            back = dec(data)
            assert back.dtype == a.dtype and back.shape == a.shape
            np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("masks", [False, True], ids=["bare", "masks"])
def test_dataset_frames_cross(masks):
    r = np.random.RandomState(1)
    parts = [r.normal(size=(4, 6, 3)).astype(np.float32),
             r.normal(size=(4, 6, 2)).astype(np.float32)]
    if masks:
        parts += [np.ones((4, 6), np.float32),
                  (r.rand(4, 6) > 0.5).astype(np.float32)]
    for data in (serialize_dataset(DataSet(*parts)),
                 jstreaming.serialize_dataset(JDataSet(*parts))):
        assert data[:4] == b"DLSD"
        for dec in (deserialize_dataset, jstreaming.deserialize_dataset):
            back = dec(data)
            for name, want in zip(("features", "labels", "features_mask",
                                   "labels_mask"), parts + [None] * 2):
                got = getattr(back, name)
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dec", ["array", "dataset"])
def test_bad_magic_raises_as_reference(dec):
    for mod in (streaming, jstreaming):
        with pytest.raises(ValueError, match="magic"):
            getattr(mod, f"deserialize_{dec}")(b"XXXXgarbage")


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("broker_pkg", ["port", "reference"])
def test_broker_fanout_across_packages(broker_pkg):
    """Topic fan-out and isolation, with the clients of both packages on
    a broker of either: the wire is the same."""
    Broker = MessageBroker if broker_pkg == "port" else \
        jstreaming.MessageBroker
    with Broker() as broker:
        c1 = TopicConsumer("127.0.0.1", broker.port, "t", timeout=10)
        c2 = jstreaming.TopicConsumer("127.0.0.1", broker.port, "t",
                                      timeout=10)
        other = TopicConsumer("127.0.0.1", broker.port, "other", timeout=0.3)
        with TopicPublisher("127.0.0.1", broker.port, "t") as pub:
            pub.publish(b"hello")
        with jstreaming.TopicPublisher("127.0.0.1", broker.port, "t") as pub:
            pub.publish(b"world")
        for c in (c1, c2):
            assert {c.poll(), c.poll()} == {b"hello", b"world"}
        with pytest.raises(socket.timeout):
            other.poll()
        for c in (c1, c2, other):
            c.close()


# ---------------------------------------------------------------------------
# serve route and HTTP server
# ---------------------------------------------------------------------------
def test_route_predicts_the_reference_output_and_keeps_the_poison():
    jnet, pnet = _mln_pair()
    x = np.random.RandomState(2).normal(size=(5, 4)).astype(np.float32)
    want = np.asarray(jnet.output(x))
    with MessageBroker() as broker:
        with DL4JServeRoute(pnet, "127.0.0.1", broker.port) as route:
            out_c = TopicConsumer("127.0.0.1", broker.port, "dl4j-out",
                                  timeout=20)
            with TopicPublisher("127.0.0.1", broker.port, "dl4j-in") as pub:
                pub.publish(serialize_array(x))
                pub.publish(jstreaming.serialize_dataset(JDataSet(x, None)))
                pub.publish(b"poison!")
                pub.publish(serialize_array(x[:2, :3]))   # wrong width
                pub.publish(jstreaming.serialize_array(x))
            preds = [jstreaming.deserialize_array(out_c.poll())
                     for _ in range(3)]
            out_c.close()
            deadline = time.time() + 10
            while route.errors < 2 and time.time() < deadline:
                time.sleep(0.02)
    for p in preds:
        assert p.shape == (5, 3)
        _close(p, want)
    assert route.served == 3 and route.errors == 2
    # the last failure is the model's own (the wrong width), kept as raised
    assert isinstance(route.last_error, RuntimeError), route.last_error
    assert "magic" not in str(route.last_error)


def test_route_keeps_each_poison_as_last_error():
    _, pnet = _mln_pair()
    with MessageBroker() as broker:
        with DL4JServeRoute(pnet, "127.0.0.1", broker.port) as route:
            with TopicPublisher("127.0.0.1", broker.port, "dl4j-in") as pub:
                pub.publish(b"poison!")
                deadline = time.time() + 10
                while route.errors < 1 and time.time() < deadline:
                    time.sleep(0.02)
    assert route.errors == 1 and route.served == 0
    assert isinstance(route.last_error, ValueError)
    assert "magic" in str(route.last_error)


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("body", ["array", "dataset"])
def test_http_predict_matches_reference(body):
    jnet, pnet = _mln_pair()
    x = np.random.RandomState(3).normal(size=(7, 4)).astype(np.float32)
    data = serialize_array(x) if body == "array" else \
        jstreaming.serialize_dataset(JDataSet(x, None))
    with InferenceHTTPServer(pnet) as srv:
        status, out = _post(srv.port, "/predict", data)
    assert status == 200
    _close(jstreaming.deserialize_array(out), np.asarray(jnet.output(x)))


@pytest.mark.parametrize("path,data", [
    ("/predict", b"garbage"), ("/generate", b"notjson"),
    ("/generate", json.dumps({"prompt": [[1]], "n_new": 2}).encode())],
    ids=["predict_garbage", "generate_garbage", "generate_on_mln"])
def test_http_errors_are_400_naming_the_exception(path, data):
    _, pnet = _mln_pair()
    with InferenceHTTPServer(pnet) as srv, \
            jstreaming.InferenceHTTPServer(pnet) as ref:
        status, body = _post(srv.port, path, data)
        ref_status, _ = _post(ref.port, path, data)
    assert status == ref_status == 400
    assert srv.errors == 1
    assert body.decode().startswith(type(srv.last_error).__name__ + ": ")
    assert str(srv.last_error) in body.decode()


def test_http_unknown_path_is_404():
    _, pnet = _mln_pair()
    with InferenceHTTPServer(pnet) as srv:
        assert _post(srv.port, "/nowhere", b"")[0] == 404


def test_http_generate_equals_reference_greedy_tokens():
    jlm, plm = _lm_pair()
    prompt = np.random.default_rng(0).integers(
        1, LM["vocab_size"], (2, 7)).astype(np.int32)
    want = np.asarray(jlm.generate(prompt, 12, temperature=0.0))
    with InferenceHTTPServer(plm) as srv:
        status, body = _post(srv.port, "/generate", json.dumps(
            {"prompt": prompt.tolist(), "n_new": 12,
             "temperature": 0.0}).encode())
    assert status == 200
    got = np.asarray(json.loads(body)["tokens"])
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 7:].ravel().tolist())) > 2


def test_route_serves_lm_logits_of_the_reference():
    """The serve route over a TransformerLM: each message's logits equal
    the JAX model's output to 1e-5 of their scale."""
    jlm, plm = _lm_pair(seed=1)
    rows = np.random.RandomState(5).randint(0, LM["vocab_size"],
                                            (3, 1, 12)).astype(np.int32)
    with MessageBroker() as broker:
        with DL4JServeRoute(plm, "127.0.0.1", broker.port) as route:
            out_c = TopicConsumer("127.0.0.1", broker.port, "dl4j-out",
                                  timeout=30)
            with TopicPublisher("127.0.0.1", broker.port, "dl4j-in") as pub:
                for r in rows:
                    pub.publish(serialize_array(r))
            preds = [deserialize_array(out_c.poll()) for _ in rows]
            out_c.close()
    assert route.errors == 0 and route.last_error is None
    for r, p in zip(rows, preds):
        _close(p, np.asarray(jlm.output(r)))
