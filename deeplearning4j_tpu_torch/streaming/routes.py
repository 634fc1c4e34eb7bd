"""Model-serving routes: the port of ``deeplearning4j_tpu/streaming/routes.py``
(``streaming/routes/DL4jServeRouteBuilder.java``).

``DL4JServeRoute`` consumes serialized DataSets or arrays from an input
topic, runs ``model.output`` and publishes the serialized predictions to
an output topic. ``InferenceHTTPServer`` is the direct-request variant
(the Camel HTTP endpoint role): POST a serialized array to ``/predict``
and get the prediction back, or JSON to ``/generate`` for a
TransformerLM's tokens.

A message or request that fails is counted and skipped, as in the
reference, so a poison message cannot stop the route. The port also
keeps the last exception (``last_error``; the 400 body names it), so a
failure on a good message, a kernel's among them, can be seen and failed
on rather than only counted.
"""

from __future__ import annotations

import json
import socket
import threading

import numpy as np

from deeplearning4j_tpu_torch.streaming.broker import (TopicConsumer,
                                                       TopicPublisher)
from deeplearning4j_tpu_torch.streaming.serde import (deserialize_array,
                                                      deserialize_dataset,
                                                      serialize_array)
from deeplearning4j_tpu_torch.utils.http_base import (BackgroundHTTPServer,
                                                      QuietJSONHandler)


def _predict(model, features):
    """The model's host-numpy ``output()`` (the first output of a graph)."""
    out = model.output(features)
    return np.asarray(out[0] if isinstance(out, list) else out)


def _error_text(e):
    return f"{type(e).__name__}: {e}"


class DL4JServeRoute:
    """Consume → predict → publish loop (DL4jServeRouteBuilder role).

    Runs on a background thread; every message on ``input_topic`` (a
    serialized DataSet or bare array) produces one serialized prediction
    array on ``output_topic``. A message that fails is counted in
    ``errors`` and skipped, and its exception kept in ``last_error``."""

    def __init__(self, model, broker_host, broker_port, *,
                 input_topic="dl4j-in", output_topic="dl4j-out"):
        self.model = model
        self.errors = 0
        self.served = 0
        self.last_error = None
        self._consumer = TopicConsumer(broker_host, broker_port, input_topic,
                                       timeout=0.5)
        self._publisher = TopicPublisher(broker_host, broker_port,
                                         output_topic)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                msg = self._consumer.poll()
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                return
            try:
                if msg[:4] == b"DLSD":
                    features = deserialize_dataset(msg).features
                else:
                    features = deserialize_array(msg)
                pred = _predict(self.model, features)
                self._publisher.publish(serialize_array(pred))
                self.served += 1
            except Exception as e:
                self.errors += 1
                self.last_error = e

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._consumer.close()
        self._publisher.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class InferenceHTTPServer(BackgroundHTTPServer):
    """POST /predict with a serialized array/DataSet body → serialized
    prediction array (the Camel HTTP serve endpoint role). Binds loopback by
    default, like the UI server. A request that fails gets a 400 whose
    body names the exception; it is counted in ``errors`` and kept in
    ``last_error``."""

    def __init__(self, model, port=0, host="127.0.0.1"):
        self.model = model
        self.errors = 0
        self.last_error = None
        self._err_lock = threading.Lock()
        server = self

        def failed(handler, e):
            with server._err_lock:
                server.errors += 1
                server.last_error = e
            handler._bytes(_error_text(e).encode(), "text/plain", status=400)

        class Handler(QuietJSONHandler):
            def do_POST(self):
                path = self.path.rstrip("/")
                if path == "/predict":
                    try:
                        body = self._read_body()
                        if body[:4] == b"DLSD":
                            features = deserialize_dataset(body).features
                        else:
                            features = deserialize_array(body)
                        out = serialize_array(_predict(server.model, features))
                    except Exception as e:
                        failed(self, e)
                        return
                    self._bytes(out)
                    return
                if path == "/generate":
                    # LM sampling endpoint: JSON {"prompt": [[ids]],
                    # "n_new": K, "temperature": t, "seed": s} → {"tokens"}
                    try:
                        req = json.loads(self._read_body())
                        if not hasattr(server.model, "generate"):
                            raise TypeError(
                                f"{type(server.model).__name__} has no "
                                "generate(); serve a TransformerLM here")
                        out = server.model.generate(
                            np.asarray(req["prompt"], np.int32),
                            int(req["n_new"]),
                            temperature=float(req.get("temperature", 1.0)),
                            seed=int(req.get("seed", 0)))
                        payload = json.dumps(
                            {"tokens": np.asarray(out).tolist()}).encode()
                    except Exception as e:
                        failed(self, e)
                        return
                    self._bytes(payload, "application/json")
                    return
                self.send_error(404)

        super().__init__(Handler, port=port, host=host,
                         name="dl4j-torch-inference-http")
