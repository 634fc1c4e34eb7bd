"""The port's ServingIngress held to the reference's HTTP contracts.

After ``tests/test_serving_resilience.py``'s ingress class, on the CPU,
with the listener bound to port 0 on loopback: ``/healthz``, ``/readyz``
and ``/metrics``, ``/v1/infer`` over an ``InferenceServer``,
``/v1/generate`` plain and streamed over a ``ContinuousLM`` (the rows
equal to a direct ``submit``), every ``ServingError`` mapped to its
declared status on the wire, ``/readyz`` answering 503 while the
listener is still open, and the ingress over a two-replica router end to
end. No test waits on a clock: a drain is held open by an event the test
sets.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.errors import (ServeReplicaDeadError,
                                             ServeStoppedError)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.serving import (ContinuousLM, InferenceServer,
                                              ReplicaRouter, ServingIngress)
from deeplearning4j_tpu_torch.testing import faults

WAIT = 120


def small_mln(seed=1, n_in=12, n_out=4):
    conf = (NeuralNetConfiguration.Builder().seed(seed).list()
            .layer(DenseLayer(n_in=n_in, n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.fixture(scope="module")
def lm():
    return TransformerLM(TransformerConfig(
        vocab_size=50, max_len=64, d_model=16, n_heads=2, n_layers=2,
        d_ff=32, seed=3), device="cpu").init()


def prompt(n):
    return np.arange(1, 1 + n, dtype=np.int32) % 49 + 1


def decoder(lm):
    return ContinuousLM(lm, slots=2, chunk=4, device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    obs.reset_metrics()
    faults.clear()
    yield
    faults.clear()


def http(url, body=None, headers=None, timeout=30):
    """(status, parsed JSON or text, response headers), 4xx/5xx too."""
    req = urllib.request.Request(url, headers=dict(headers or ()),
                                 data=None if body is None
                                 else json.dumps(body).encode())
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        raw, status, hdrs = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, e.headers
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw.decode(), hdrs


def test_health_metrics_and_infer():
    net = small_mln()
    srv = InferenceServer(net, buckets=(4,), device="cpu")
    ing = ServingIngress(srv).start()
    url = f"http://127.0.0.1:{ing.port}"
    try:
        assert ing.port != 0
        assert http(url + "/healthz")[:2] == (200, {"status": "ok"})
        assert http(url + "/readyz")[:2] == (200, {"status": "ready"})
        x = np.random.RandomState(0).rand(12).astype(np.float32)
        status, body, _ = http(url + "/v1/infer", {"x": x.tolist()})
        assert status == 200
        np.testing.assert_allclose(body["y"], net.output(x[None])[0],
                                   rtol=1e-5)
        status, text, hdrs = http(url + "/metrics")
        assert status == 200 and hdrs["Content-Type"].startswith("text/plain")
        assert "# TYPE dl4j_torch_serve_requests_total counter" in text
        assert "dl4j_torch_serve_requests_total 1" in text
        assert 'dl4j_torch_serve_request_seconds_bucket{le="+Inf"} 1' in text
        assert http(url + "/nope")[0] == 404
        assert http(url + "/v1/nope", {})[0] == 404
        assert http(url + "/v1/infer", {})[0] == 400
    finally:
        ing.stop()
        srv.stop()


def test_metrics_summary_timer_and_text_follow_the_reference():
    """``timer``, ``metrics_summary`` and ``prometheus_text`` of the port's
    registry against the reference's on the same records (names under
    each package's own prefix)."""
    from deeplearning4j_tpu import obs as jax_obs
    out = []
    for mod, prefix in ((jax_obs, "dl4j_tpu_"), (obs, "dl4j_torch_")):
        mod.reset_metrics()
        h = mod.histogram("test.ingress_seconds", "a test histogram")
        for v in (0.001, 0.02, 0.3):
            h.record(v)
        mod.counter("test.ingress_total", "a test counter").inc(3)
        with mod.timer("test.ingress_timer_seconds"):
            pass
        summ = mod.metrics_summary()
        text = mod.prometheus_text()
        lines = sorted(ln.replace(prefix, "") for ln in text.splitlines()
                       if ln.startswith(prefix + "test_")
                       or ln.startswith(("# HELP " + prefix + "test_",
                                         "# TYPE " + prefix + "test_")))
        lines = [ln for ln in lines if "timer" not in ln]
        summ = {k: v for k, v in summ.items() if k.startswith("test.")}
        timer = summ.pop("test.ingress_timer_seconds")
        out.append((summ, lines, timer["count"]))
        mod.reset_metrics()
    assert out[0] == out[1]
    assert out[1][0]["test.ingress_total"] == 3 and out[1][2] == 1


def test_generate_plain_and_streamed_equal_a_direct_submit(lm):
    srv = decoder(lm)
    ing = ServingIngress(srv).start()
    url = f"http://127.0.0.1:{ing.port}"
    try:
        direct = srv.submit(prompt(4), 4).result(WAIT)
        status, body, _ = http(url + "/v1/generate",
                               {"prompt": prompt(4).tolist(), "n_new": 4},
                               timeout=WAIT)
        assert status == 200 and body["tokens"] == direct.tolist()
        # streamed: NDJSON lines of tokens, then the done line with the
        # whole row
        r = urllib.request.urlopen(urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": prompt(4).tolist(), "n_new": 4,
                             "stream": True}).encode()), timeout=WAIT)
        assert r.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(ln) for ln in r.read().splitlines()]
        assert lines[-1]["done"] is True and lines[-1]["streamed"] == 4
        assert [t for ln in lines[:-1] for t in ln["tokens"]] == \
            direct.tolist()[4:]
        assert lines[-1]["tokens"] == direct.tolist()
    finally:
        ing.stop()
        srv.stop()


class _Failing:
    """A backend whose every request fails with ``error``."""

    def __init__(self, error):
        self.error = error

    def submit(self, *a, **k):
        f = Future()
        f.set_exception(self.error)
        return f


def test_status_mapping_on_the_wire(lm):
    srv = decoder(lm)
    ing = ServingIngress(srv).start()
    url = f"http://127.0.0.1:{ing.port}"
    gen = {"prompt": prompt(4).tolist(), "n_new": 3}
    try:
        # 429 with Retry-After: backpressure tells the client to back off
        with faults.inject("queue-overflow@0"):
            status, body, hdrs = http(url + "/v1/generate", gen)
        assert status == 429 and body["retryable"] is True
        assert hdrs.get("Retry-After") == "1"
        assert body["error"] == "ServeQueueFullError"
        # 504: the deadline header arms the sweep, which fails the request
        # before any dispatch
        with faults.inject("expire-deadline@0"):
            status, body, _ = http(url + "/v1/generate", gen,
                                   headers={"X-Deadline-Ms": "60000"},
                                   timeout=WAIT)
        assert status == 504 and body["error"] == "ServeDeadlineError"
        assert body["retryable"] is False
        # 400: a malformed deadline, body or field
        assert http(url + "/v1/generate", gen,
                    headers={"X-Deadline-Ms": "soon"})[0] == 400
        assert http(url + "/v1/generate", gen,
                    headers={"X-Deadline-Ms": "-5"})[0] == 400
        assert http(url + "/v1/generate", {"n_new": 3})[0] == 400
        assert http(url + "/v1/generate",
                    {"prompt": [1, 2], "n_new": 0})[0] == 400
        req = urllib.request.Request(url + "/v1/generate", data=b"[1, 2")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        # 503 once the backend stops
        srv.stop()
        status, body, _ = http(url + "/v1/generate", gen)
        assert status == 503 and body["retryable"] is True
        assert body["error"] == "ServeStoppedError"
    finally:
        ing.stop()
        srv.stop()
    # 502: a replica died with the request admitted; streamed, the typed
    # failure is the last NDJSON line
    ing = ServingIngress(_Failing(ServeReplicaDeadError("replica 0 died")))
    ing.start()
    url = f"http://127.0.0.1:{ing.port}"
    try:
        status, body, _ = http(url + "/v1/generate", gen)
        assert (status, body["error"], body["retryable"]) == \
            (502, "ServeReplicaDeadError", True)
        r = urllib.request.urlopen(urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps(dict(gen, stream=True)).encode()), timeout=30)
        last = json.loads(r.read().splitlines()[-1])
        assert last == {"done": False, "error": "ServeReplicaDeadError",
                        "message": "replica 0 died", "retryable": True,
                        "status": 502}
    finally:
        ing.stop()


def test_readyz_flips_before_the_listener_closes():
    """A backend whose drain blocks until the test releases it: /readyz
    must answer 503 while the listener is still up."""
    release, draining = threading.Event(), threading.Event()

    class Gate:
        def submit(self, *a, **k):
            raise ServeStoppedError("the gate takes no work")

        def healthy(self):
            return True

        def drain(self, timeout=30.0):
            draining.set()
            return release.wait(timeout)

    ing = ServingIngress(Gate()).start()
    url = f"http://127.0.0.1:{ing.port}"
    try:
        assert http(url + "/readyz")[0] == 200
        out = []
        t = threading.Thread(target=lambda: out.append(ing.drain(WAIT)),
                             daemon=True)
        t.start()
        assert draining.wait(WAIT)   # the ready flag fell before drain ran
        assert http(url + "/readyz")[:2] == (503, {"status": "draining"})
        assert http(url + "/healthz")[0] == 200
        release.set()
        t.join(WAIT)
        assert out == [True]
        # only after the drain completed does the listener close
        with pytest.raises(urllib.error.URLError):
            http(url + "/readyz", timeout=2)
    finally:
        release.set()
        ing.stop()


def test_readyz_follows_the_backend_health(lm):
    reps = [decoder(lm) for _ in range(2)]
    router = ReplicaRouter(reps, heartbeat_s=3600.0, slo_ms=0.0)
    ing = ServingIngress(router).start()
    url = f"http://127.0.0.1:{ing.port}"
    try:
        assert http(url + "/readyz")[0] == 200
        for r in reps:
            r.stop()
        router.check()
        assert http(url + "/readyz")[0] == 503
    finally:
        ing.stop()
        router.stop()


def test_ingress_over_router_end_to_end(lm):
    reps = [decoder(lm) for _ in range(2)]
    router = ReplicaRouter(reps, heartbeat_s=3600.0, slo_ms=0.0)
    ing = ServingIngress(router).start()
    url = f"http://127.0.0.1:{ing.port}"
    direct = decoder(lm)
    try:
        want = direct.submit(prompt(5), 3).result(WAIT).tolist()
        for _ in range(3):
            status, body, _ = http(url + "/v1/generate",
                                   {"prompt": prompt(5).tolist(),
                                    "n_new": 3}, timeout=WAIT)
            assert status == 200 and body["tokens"] == want
        r = urllib.request.urlopen(urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": prompt(5).tolist(), "n_new": 3,
                             "stream": True}).encode()), timeout=WAIT)
        assert json.loads(r.read().splitlines()[-1])["tokens"] == want
        assert http(url + "/readyz")[0] == 200
        assert ing.drain(timeout=WAIT) is True
        with pytest.raises(urllib.error.URLError):
            http(url + "/healthz", timeout=2)
        assert not any(t.name == "dl4j-torch-serve-ingress"
                       for t in threading.enumerate())
    finally:
        ing.stop()
        router.stop()
        direct.stop()
