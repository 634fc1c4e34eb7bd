"""Keras-as-frontend RPC server: the port of
``deeplearning4j_tpu/modelimport/keras_server.py`` (the
``deeplearning4j-keras`` role: ``Server.java:18`` and
``DeepLearning4jEntryPoint.fit():21-24``). A Keras user points the
server at a saved Keras model file and a directory of minibatch files,
and training runs in this package, on the server's device (the card
unless it is built with ``device="cpu"``).

Plain HTTP JSON-RPC over ``utils/http_base.py``: POST /fit with
``{"model_path", "data_dir", "epochs"?, "save_path"?}``. Minibatch files
are ``.npz`` (the reference's export format, read by
:func:`load_dataset`) or ``.h5`` with ``features``/``labels`` datasets
(read by ``utils/h5.py``). GET /status reports the last fit. A failed
fit is answered with status 400 and its error; the server stays up.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError, import_keras_model_and_weights,
    import_keras_sequential_model_and_weights)
# the export format's reader, exported from here too
from deeplearning4j_tpu_torch.parallel.training_master import load_dataset
from deeplearning4j_tpu_torch.utils.h5 import H5File
from deeplearning4j_tpu_torch.utils.http_base import (BackgroundHTTPServer,
                                                      QuietJSONHandler)

__all__ = ["KerasRPCServer", "load_dataset"]


def _load_batches(data_dir):
    """Minibatch files, sorted: .npz (the export format) or .h5."""
    batches = []
    for p in sorted(glob.glob(os.path.join(data_dir, "*"))):
        if p.endswith(".npz"):
            batches.append(load_dataset(p))
        elif p.endswith(".h5"):
            with H5File(p) as f:
                feats = np.asarray(f["features"])
                labels = np.asarray(f["labels"]) if "labels" in f else None
            batches.append(DataSet(feats, labels))
    if not batches:
        raise ValueError(f"no .npz/.h5 minibatch files under {data_dir!r}")
    return batches


def _fit_entry_point(req, device=None):
    """DeepLearning4jEntryPoint.fit() role. The reply adds, beside the
    reference's keys, the score of the first batch and the fit's
    seconds."""
    model_path = req["model_path"]
    data_dir = req["data_dir"]
    epochs = int(req.get("epochs", 1))
    if not os.path.exists(model_path):
        raise ValueError(f"model file not found: {model_path!r}")
    try:
        net = import_keras_sequential_model_and_weights(model_path,
                                                        device=device)
    except KerasImportError:
        net = import_keras_model_and_weights(model_path, device=device)
    batches = _load_batches(data_dir)
    is_graph = hasattr(net, "params_map")
    t0 = time.perf_counter()
    score = first = None
    for _ in range(epochs):
        for ds in batches:
            if is_graph:
                score = net.fit_batch(MultiDataSet([ds.features],
                                                   [ds.labels]))
            else:
                score = net.fit_batch(ds.features, ds.labels)
            if first is None:
                first = float(score)
    final = float(score) if score is not None else None
    seconds = time.perf_counter() - t0
    save_path = req.get("save_path")
    if save_path:
        from deeplearning4j_tpu_torch.utils.model_serializer import \
            write_model
        write_model(net, save_path)
    return {"status": "ok", "epochs": epochs, "batches": len(batches),
            "final_score": final, "first_score": first, "seconds": seconds,
            "model_type": type(net).__name__, "saved_to": save_path}


class KerasRPCServer(BackgroundHTTPServer):
    """HTTP JSON-RPC server for the Keras frontend (Server.java:18 role),
    bound to loopback by default. ``device`` is where the imported nets
    train (the card unless ``"cpu"``)."""

    def __init__(self, port=0, host="127.0.0.1", device=None):
        self.last_result = None
        server = self

        class Handler(QuietJSONHandler):
            def do_GET(self):
                if self.path.rstrip("/") == "/status":
                    self._json({"last_fit": server.last_result})
                else:
                    self._json({"error": "not found"}, status=404)

            def do_POST(self):
                if self.path.rstrip("/") != "/fit":
                    self._json({"error": "not found"}, status=404)
                    return
                try:
                    req = json.loads(self._read_body())
                    result = _fit_entry_point(req, device)
                except Exception as e:
                    # reported to the caller, as the reference's gateway
                    # does, rather than ending the server
                    self._json({"status": "error",
                                "error": f"{type(e).__name__}: {e}"},
                               status=400)
                    return
                server.last_result = result
                self._json(result)

        super().__init__(Handler, port=port, host=host,
                         name="dl4j-torch-keras")


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    srv = KerasRPCServer(port=args.port, host=args.host,
                         device=args.device).start()
    print(f"Keras RPC server listening on {args.host}:{srv.port}")
    threading.Event().wait()


if __name__ == "__main__":
    main()
