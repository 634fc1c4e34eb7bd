"""Training UI: embedded HTTP server and remote stats ingestion: the port
of ``deeplearning4j_tpu/ui/server.py`` (``ui/play/PlayUIServer.java``,
the singleton ``UIServer.getInstance()`` of ``ui/api/UIServer.java:24``,
the TrainModule JSON endpoints of ``module/train/TrainModule.java:93-107``
and the ``RemoteReceiverModule`` ``/remoteReceive`` endpoint that
``RemoteUIStatsStorageRouter`` posts to).

A ``ThreadingHTTPServer`` serves one self-contained HTML page with inline
SVG charts polling the JSON endpoints (no external assets), every data
endpoint of the reference with the same JSON, and the port's metric
registry: ``GET /metrics`` in Prometheus text (``obs.prometheus_text``),
``GET /train/metrics/data`` as JSON.
"""

from __future__ import annotations

import json
import math
import queue
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch import nativelib, obs
from deeplearning4j_tpu_torch.ui.conv_listener import TYPE_ID as CONV_TYPE
from deeplearning4j_tpu_torch.ui.stats import TYPE_ID
from deeplearning4j_tpu_torch.ui.storage import Persistable, StatsStorageRouter

_INSTANCE = None
_INSTANCE_LOCK = threading.Lock()


def _series(updates, path):
    """[(iteration, value)] for a dotted path into update contents."""
    out = []
    for p in updates:
        c = p.content
        v = c
        for part in path.split("."):
            if not isinstance(v, dict) or part not in v:
                v = None
                break
            v = v[part]
        if isinstance(v, (int, float)):
            out.append([c.get("iteration", 0), float(v)])
    return out


class UIServer:
    """Embedded stats UI server (PlayUIServer role). ``attach(storage)`` makes
    its sessions browsable; ``enable_remote_listener()`` is implicit — POST
    /remoteReceive always ingests into the first attached storage."""

    def __init__(self, port=9000, host="127.0.0.1"):
        # loopback by default: /remoteReceive ingests unauthenticated, so
        # exposing it beyond the host is an explicit opt-in (host="0.0.0.0")
        self.port = port
        self.host = host
        # guards _storages and the _httpd lifecycle: attach()/detach() may
        # be called from training code while handler threads iterate the
        # storage list; writers hold it, readers snapshot under it
        self._lock = threading.Lock()
        self._storages = []
        self._httpd = None
        self._thread = None
        self._tsne_uploads = {}      # name -> [[x, y, label], ...]
        self._tsne_lock = threading.Lock()

    @staticmethod
    def get_instance(port=9000):
        global _INSTANCE
        with _INSTANCE_LOCK:
            if _INSTANCE is None:
                _INSTANCE = UIServer(port)
                _INSTANCE.start()
            return _INSTANCE

    def attach(self, storage):
        with self._lock:
            if storage not in self._storages:
                self._storages.append(storage)

    def detach(self, storage):
        with self._lock:
            if storage in self._storages:
                self._storages.remove(storage)

    def _attached(self):
        """Snapshot of the attached storages: handler threads iterate the
        copy, so a concurrent attach/detach can never race the loop."""
        with self._lock:
            return list(self._storages)

    # --- lifecycle ---
    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, obj, status=200):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _html(self, text):
                data = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _text(self, text, content_type="text/plain; version=0.0.4"):
                data = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    server._handle_get(self)
                except BrokenPipeError:
                    pass

            def do_POST(self):
                try:
                    server._handle_post(self)
                except BrokenPipeError:
                    pass

        with self._lock:
            self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            # shutdown() makes serve_forever return; join so stop() hands
            # back a server whose thread is actually gone
            thread.join(timeout=5)
        global _INSTANCE
        with _INSTANCE_LOCK:
            if _INSTANCE is self:
                _INSTANCE = None

    # --- request handling ---
    def _find_session(self, session_id):
        for st in self._attached():
            if session_id in st.list_session_ids():
                return st
        return None

    def _handle_get(self, h):
        url = urlparse(h.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        path = url.path.rstrip("/") or "/"
        if path == "/" or path == "/train" or path == "/train/overview":
            h._html(_DASHBOARD_HTML)
        elif path == "/metrics":
            # Prometheus text exposition of the process-wide obs registry
            # (step times, queue depths, collective rounds, checkpoint
            # commits — docs/OBSERVABILITY.md)
            h._text(obs.prometheus_text())
        elif path == "/train/metrics/data":
            h._json(obs.metrics_snapshot())
        elif path == "/serve/data":
            # serving-tier dashboard slice: the serve.* family only
            # (queue depth, batch occupancy, request latency percentiles
            # — docs/SERVING.md metrics catalogue)
            snap = obs.metrics_snapshot()
            h._json({kind: {name: v for name, v in vals.items()
                            if name.startswith("serve.")
                            or name.startswith("infer.")}
                     for kind, vals in snap.items()
                     if isinstance(vals, dict)})
        elif path == "/train/sessions":
            out = []
            for st in self._attached():
                out.extend(st.list_session_ids())
            h._json(sorted(set(out)))
        elif path == "/train/overview/data":
            h._json(self._overview_data(q.get("sessionId")))
        elif path == "/train/model/data":
            h._json(self._model_data(q.get("sessionId"), q.get("layer")))
        elif path == "/train/system/data":
            h._json(self._system_data(q.get("sessionId")))
        elif path == "/train/histogram/data":
            h._json(self._histogram_data(q.get("sessionId"), q.get("layer")))
        elif path == "/train/flow/data":
            h._json(self._flow_data(q.get("sessionId")))
        elif path == "/train/tsne/data":
            h._json(self._tsne_data(q.get("name")))
        elif path == "/train/activations":
            self._serve_activation_png(h, q.get("sessionId"))
        else:
            h._json({"error": "not found", "path": path}, status=404)

    def _handle_post(self, h):
        url = urlparse(h.path)
        path = url.path.rstrip("/")
        if path == "/train/tsne/upload":
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                length = int(h.headers.get("Content-Length", 0))
                coords = json.loads(h.rfile.read(length))
                if not isinstance(coords, list):
                    raise ValueError("expected a JSON list of [x, y, label]")
                coords = [[float(c[0]), float(c[1]),
                           str(c[2]) if len(c) > 2 else ""] for c in coords]
                if not all(math.isfinite(c[0]) and math.isfinite(c[1])
                           for c in coords):
                    raise ValueError("coordinates must be finite")
            except (ValueError, TypeError, IndexError, KeyError) as e:
                h._json({"error": f"bad t-SNE payload: {e}"}, status=400)
                return
            name = q.get("name", "default")
            with self._tsne_lock:
                # re-insert so "newest upload" is well-defined for the
                # default dashboard view
                self._tsne_uploads.pop(name, None)
                self._tsne_uploads[name] = coords
            h._json({"status": "ok", "name": name, "points": len(coords)})
            return
        if path != "/remoteReceive":
            h._json({"error": "not found"}, status=404)
            return
        length = int(h.headers.get("Content-Length", 0))
        body = h.rfile.read(length)
        storages = self._attached()
        if not storages:
            h._json({"error": "no storage attached"}, status=503)
            return
        # native TLV validator rejects malformed payloads cheaply before the
        # Python decoder allocates anything (tlv.cpp; None = native unavailable)
        rc = nativelib.tlv_validate(body)
        if rc is not None and rc != 0:
            h._json({"error": f"malformed stats payload (code {rc})"}, status=400)
            return
        try:
            p = Persistable.decode(body)
        except ValueError as e:
            h._json({"error": str(e)}, status=400)
            return
        kind = h.headers.get("X-Stats-Kind", "update")
        if kind == "static":
            storages[0].put_static_info(p)
        else:
            storages[0].put_update(p)
        h._json({"status": "ok"})

    # --- data assembly (TrainModule.java:93-107 JSON endpoints) ---
    def _session_updates(self, session_id):
        st = self._find_session(session_id)
        if st is None:
            return None, []
        updates = []
        for worker in st.list_worker_ids(session_id, TYPE_ID):
            updates.extend(st.get_all_updates_after(session_id, TYPE_ID, worker, -1))
        updates.sort(key=lambda p: (p.content.get("iteration", 0), p.timestamp))
        return st, updates

    def _overview_data(self, session_id):
        st, updates = self._session_updates(session_id)
        if st is None:
            return {"error": f"unknown session {session_id}"}
        info = {}
        for worker in st.list_worker_ids(session_id, TYPE_ID):
            p = st.get_static_info(session_id, TYPE_ID, worker)
            if p is not None:
                info = {k: v for k, v in p.content.items() if k != "model"} | {
                    "model": {k: v for k, v in p.content.get("model", {}).items()
                              if k != "config"}}
                break
        return {
            "sessionId": session_id,
            "scores": _series(updates, "score"),
            "examplesPerSec": _series(updates, "examples_per_sec"),
            "durationMs": _series(updates, "duration_ms"),
            "info": info,
            "lastIteration": updates[-1].content.get("iteration") if updates else None,
        }

    @staticmethod
    def _layer_list(updates, layer=None):
        """Sorted layer names seen in param stats + the default selection."""
        layers = set()
        for p in updates:
            layers.update(p.content.get("params", {}).keys())
        layers = sorted(layers)
        if layer is None and layers:
            layer = layers[0]
        return layers, layer

    def _model_data(self, session_id, layer=None):
        st, updates = self._session_updates(session_id)
        if st is None:
            return {"error": f"unknown session {session_id}"}
        layers, layer = self._layer_list(updates, layer)
        out = {"sessionId": session_id, "layers": layers, "layer": layer,
               "paramMeanMag": {}, "gradMeanMag": {}, "paramHistogram": None,
               "gradHistogram": None, "learningRates": _last_dict(updates, "learning_rates")}
        if layer:
            sample = None
            for p in updates:
                if layer in p.content.get("params", {}):
                    sample = p.content["params"][layer]
                    break
            pkeys = sorted(sample.keys()) if sample else []
            for k in pkeys:
                out["paramMeanMag"][k] = _series(updates, f"params.{layer}.{k}.meanmag")
                out["gradMeanMag"][k] = _series(updates, f"gradients.{layer}.{k}.meanmag")
            for p in reversed(updates):
                hp = p.content.get("params", {}).get(layer, {})
                for k in pkeys:
                    hist = hp.get(k, {}).get("histogram")
                    if hist is not None and out["paramHistogram"] is None:
                        out["paramHistogram"] = {
                            "param": k, "min": hist["min"], "max": hist["max"],
                            "counts": [float(c) for c in hist["counts"]]}
                hg = p.content.get("gradients", {}).get(layer, {})
                for k in pkeys:
                    hist = hg.get(k, {}).get("histogram")
                    if hist is not None and out["gradHistogram"] is None:
                        out["gradHistogram"] = {
                            "param": k, "min": hist["min"], "max": hist["max"],
                            "counts": [float(c) for c in hist["counts"]]}
                if out["paramHistogram"] is not None:
                    break
        return out

    def _system_data(self, session_id):
        st, updates = self._session_updates(session_id)
        if st is None:
            return {"error": f"unknown session {session_id}"}
        keys = set()
        for p in updates:
            keys.update(p.content.get("memory", {}).keys())
        return {"sessionId": session_id,
                "memory": {k: _series(updates, f"memory.{k}") for k in sorted(keys)}}

    # --- histogram module (ui/module/histogram/HistogramModule.java) ---
    @staticmethod
    def _latest_histograms(updates, group, layer):
        """Newest histogram per param key of ``layer`` in ``group``
        ('params' | 'gradients')."""
        out = {}
        for p in reversed(updates):
            for k, stats in p.content.get(group, {}).get(layer, {}).items():
                hist = stats.get("histogram")
                if hist is not None and k not in out:
                    out[k] = {"min": float(hist["min"]),
                              "max": float(hist["max"]),
                              "counts": [float(c) for c in hist["counts"]]}
        return out

    def _histogram_data(self, session_id, layer=None):
        st, updates = self._session_updates(session_id)
        if st is None:
            return {"error": f"unknown session {session_id}"}
        layers, layer = self._layer_list(updates, layer)
        out = {"sessionId": session_id, "layers": layers, "layer": layer,
               "score": _series(updates, "score"),
               "paramHistograms": {}, "gradientHistograms": {},
               "meanMag": {}}
        if layer:
            out["paramHistograms"] = self._latest_histograms(
                updates, "params", layer)
            out["gradientHistograms"] = self._latest_histograms(
                updates, "gradients", layer)
            for k in out["paramHistograms"]:
                out["meanMag"][f"param:{k}"] = _series(
                    updates, f"params.{layer}.{k}.meanmag")
                out["meanMag"][f"grad:{k}"] = _series(
                    updates, f"gradients.{layer}.{k}.meanmag")
        return out

    # --- flow module (ui/module/flow/FlowListenerModule.java) ---
    def _flow_data(self, session_id):
        """Network topology from the session's static model config: nodes +
        edges for the DAG (or the sequential chain)."""
        st, _ = self._session_updates(session_id)
        if st is None:
            return {"error": f"unknown session {session_id}"}
        config = None
        for worker in st.list_worker_ids(session_id, TYPE_ID):
            p = st.get_static_info(session_id, TYPE_ID, worker)
            if p is not None:
                config = p.content.get("model", {}).get("config")
                if config:
                    break
        if not config:
            return {"sessionId": session_id, "nodes": [], "edges": [],
                    "error": "no model config in static info"}
        try:
            conf = json.loads(config)
        except ValueError:
            return {"sessionId": session_id, "nodes": [], "edges": [],
                    "error": "unparseable model config"}
        nodes, edges = [], []
        if "vertices" in conf:        # ComputationGraph
            for n in conf.get("network_inputs", []):
                nodes.append({"id": n, "label": n, "kind": "input"})
            for name, v in conf["vertices"].items():
                layer = v.get("layer") or {}
                nodes.append({
                    "id": name,
                    "label": f"{name}\n{layer.get('type', v.get('type', '?'))}",
                    "kind": ("output"
                             if name in conf.get("network_outputs", [])
                             else "layer")})
            for name, ins in conf.get("vertex_inputs", {}).items():
                for src in ins:
                    edges.append([src, name])
        else:                          # MultiLayerNetwork chain
            nodes.append({"id": "input", "label": "input", "kind": "input"})
            prev = "input"
            for i, layer in enumerate(conf.get("layers", [])):
                nid = f"{i}_{layer.get('type', 'Layer')}"
                kind = ("output" if i == len(conf["layers"]) - 1 else "layer")
                nodes.append({"id": nid, "label": nid, "kind": kind})
                edges.append([prev, nid])
                prev = nid
        return {"sessionId": session_id, "nodes": nodes, "edges": edges}

    # --- tsne module (ui/module/tsne/TsneModule.java) ---
    def _tsne_data(self, name=None):
        with self._tsne_lock:
            if name is None:
                names = sorted(self._tsne_uploads)
                if not names:
                    return {"names": []}
                newest = next(reversed(self._tsne_uploads))  # insertion order
                return {"names": names, "name": newest,
                        "coords": self._tsne_uploads[newest]}
            coords = self._tsne_uploads.get(name)
        if coords is None:
            return {"error": f"unknown t-SNE upload {name!r}"}
        return {"name": name, "coords": coords}

    # --- convolutional module (ui/module/convolutional/...) ---
    def _serve_activation_png(self, h, session_id=None):
        latest = None
        for st in self._attached():
            for sid in st.list_session_ids():
                if session_id is not None and sid != session_id:
                    continue
                for worker in st.list_worker_ids(sid, CONV_TYPE):
                    p = st.get_latest_update(sid, CONV_TYPE, worker)
                    if (p is not None and "png" in p.content
                            and (latest is None
                                 or p.timestamp > latest.timestamp)):
                        latest = p
        if latest is None:
            h._json({"error": "no convolutional activations recorded"},
                    status=404)
            return
        data = latest.content["png"]
        h.send_response(200)
        h.send_header("Content-Type", "image/png")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)


def _last_dict(updates, key):
    for p in reversed(updates):
        v = p.content.get(key)
        if isinstance(v, dict) and v:
            return {k: float(x) for k, x in v.items()}
    return {}


# drain-thread shutdown sentinel: close() enqueues it so the blocking
# get() wakes without any idle polling
_ROUTER_CLOSE = object()


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """POST reports to a remote UI server's /remoteReceive
    (impl/RemoteUIStatsStorageRouter.java) — async with a bounded retry queue
    so a dead UI server never blocks training."""

    def __init__(self, url, queue_size=256, timeout=5.0):
        self.url = url.rstrip("/") + "/remoteReceive"
        self.timeout = timeout
        self._queue = queue.Queue(maxsize=queue_size)
        self.dropped = 0
        # the drain thread and every enqueuing thread bump `dropped`; a
        # bare += is a read-modify-write that loses updates under
        # contention
        self._drop_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _post(self, kind, p):
        req = urllib.request.Request(
            self.url, data=p.encode(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Stats-Kind": kind})
        urllib.request.urlopen(req, timeout=self.timeout).read()

    def _drain(self):
        # close() wakes the blocking get() with a sentinel (no idle
        # wakeups); the _stop Event is the queue-full backstop: a full
        # queue means items keep arriving here, so the loop-top check runs
        # after each one.
        while not self._stop.is_set():
            item = self._queue.get()
            if item is _ROUTER_CLOSE:
                return
            kind, p = item
            try:
                self._post(kind, p)
            except Exception:
                with self._drop_lock:
                    self.dropped += 1

    def close(self, timeout=5.0):
        """Stop the drain thread (the router owns a thread, so it owns a
        release). Reports
        still queued are best-effort and stay undelivered; ``flush()``
        first if they matter."""
        self._stop.set()
        try:
            self._queue.put_nowait(_ROUTER_CLOSE)
        except queue.Full:
            pass   # drain is mid-backlog: it re-checks _stop per item
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _enqueue(self, kind, p):
        try:
            self._queue.put_nowait((kind, p))
        except queue.Full:
            with self._drop_lock:
                self.dropped += 1

    def put_static_info(self, p):
        self._enqueue("static", p)

    def put_update(self, p):
        self._enqueue("update", p)

    def flush(self, timeout=10.0):
        import time
        deadline = time.time() + timeout
        while not self._queue.empty() and time.time() < deadline:
            time.sleep(0.05)


_DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>DL4J Training UI</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#f5f6fa;color:#222}
header{background:#1f2a44;color:#fff;padding:10px 20px;display:flex;gap:16px;align-items:center}
header h1{font-size:16px;margin:0}select{padding:4px}
.grid{display:grid;grid-template-columns:repeat(auto-fit,minmax(420px,1fr));gap:16px;padding:16px}
.card{background:#fff;border-radius:8px;box-shadow:0 1px 3px rgba(0,0,0,.12);padding:12px}
.card h2{font-size:13px;margin:0 0 8px;color:#555;text-transform:uppercase;letter-spacing:.05em}
svg{width:100%;height:220px}table{font-size:12px;border-collapse:collapse}
td{padding:2px 8px;border-bottom:1px solid #eee}
</style></head><body>
<header><h1>deeplearning4j_tpu_torch &mdash; Training UI</h1>
<select id="session"></select>
<select id="layer"></select>
<span id="status" style="font-size:12px;opacity:.7"></span></header>
<div class="grid">
<div class="card"><h2>Score vs iteration</h2><svg id="score"></svg></div>
<div class="card"><h2>Examples / sec</h2><svg id="perf"></svg></div>
<div class="card"><h2>Param mean magnitude</h2><svg id="pmm"></svg></div>
<div class="card"><h2>Gradient mean magnitude</h2><svg id="gmm"></svg></div>
<div class="card"><h2>Parameter histogram</h2><svg id="phist"></svg></div>
<div class="card"><h2>Gradient histogram</h2><svg id="ghist"></svg></div>
<div class="card"><h2>Network topology</h2><svg id="flow" style="height:300px"></svg></div>
<div class="card"><h2>t-SNE</h2><svg id="tsne" style="height:300px"></svg></div>
<div class="card"><h2>Conv activations</h2>
  <img id="convact" style="width:100%;image-rendering:pixelated" alt="no activations yet"/></div>
<div class="card"><h2>Memory</h2><svg id="mem"></svg></div>
<div class="card"><h2>Session info</h2><table id="info"></table></div>
</div>
<script>
const COLORS=['#2563eb','#dc2626','#059669','#d97706','#7c3aed','#0891b2'];
// series keys can originate from /remoteReceive-ingested payloads — escape
// anything interpolated into SVG markup
const esc=s=>String(s).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
function lineChart(svg, seriesMap){
  const el=document.getElementById(svg); el.innerHTML='';
  const W=el.clientWidth||420,H=el.clientHeight||220,P=36;
  let pts=[]; for(const k in seriesMap) pts=pts.concat(seriesMap[k]);
  if(!pts.length){return}
  const xs=pts.map(p=>p[0]),ys=pts.map(p=>p[1]);
  const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
  const sx=v=>P+(W-2*P)*(x1>x0?(v-x0)/(x1-x0):0.5);
  const sy=v=>H-P-(H-2*P)*(y1>y0?(v-y0)/(y1-y0):0.5);
  let g=`<line x1="${P}" y1="${H-P}" x2="${W-P}" y2="${H-P}" stroke="#ccc"/>`+
        `<line x1="${P}" y1="${P}" x2="${P}" y2="${H-P}" stroke="#ccc"/>`+
        `<text x="${P}" y="${H-6}" font-size="10">${x0}</text>`+
        `<text x="${W-P}" y="${H-6}" font-size="10" text-anchor="end">${x1}</text>`+
        `<text x="4" y="${H-P}" font-size="10">${y0.toPrecision(3)}</text>`+
        `<text x="4" y="${P+4}" font-size="10">${y1.toPrecision(3)}</text>`;
  let ci=0,leg=0;
  for(const k in seriesMap){
    const s=seriesMap[k]; if(!s.length){ci++;continue}
    const d=s.map((p,i)=>(i?'L':'M')+sx(p[0]).toFixed(1)+' '+sy(p[1]).toFixed(1)).join(' ');
    g+=`<path d="${d}" fill="none" stroke="${COLORS[ci%6]}" stroke-width="1.5"/>`;
    g+=`<text x="${P+6+leg*110}" y="${P-6}" font-size="10" fill="${COLORS[ci%6]}">${esc(k)}</text>`;
    ci++;leg++;
  }
  el.innerHTML=g;
}
function flowChart(svg,data){
  // layered left-to-right topology render (FlowListenerModule role)
  const el=document.getElementById(svg); el.replaceChildren();
  if(!data||!data.nodes||!data.nodes.length){return}
  const depth={};
  data.nodes.forEach(n=>{depth[n.id]=0});
  for(let pass=0;pass<data.nodes.length;pass++)
    data.edges.forEach(([a,b])=>{
      if(depth[a]!==undefined&&depth[b]!==undefined&&depth[b]<depth[a]+1)
        depth[b]=depth[a]+1;});
  const cols={};
  data.nodes.forEach(n=>{(cols[depth[n.id]]=cols[depth[n.id]]||[]).push(n)});
  const W=el.clientWidth||420,H=el.clientHeight||300,NC=Object.keys(cols).length;
  const pos={},BW=110,BH=30;
  Object.entries(cols).forEach(([d,ns])=>{
    ns.forEach((n,i)=>{
      pos[n.id]=[20+(+d)*(W-40-BW)/Math.max(NC-1,1),
                 20+(i+0.5)*(H-40)/ns.length-BH/2];});});
  const NS='http://www.w3.org/2000/svg';
  data.edges.forEach(([a,b])=>{
    if(!pos[a]||!pos[b])return;
    const l=document.createElementNS(NS,'line');
    l.setAttribute('x1',pos[a][0]+BW);l.setAttribute('y1',pos[a][1]+BH/2);
    l.setAttribute('x2',pos[b][0]);l.setAttribute('y2',pos[b][1]+BH/2);
    l.setAttribute('stroke','#94a3b8');el.appendChild(l);});
  data.nodes.forEach(n=>{
    const [x,y]=pos[n.id];
    const r=document.createElementNS(NS,'rect');
    r.setAttribute('x',x);r.setAttribute('y',y);
    r.setAttribute('width',BW);r.setAttribute('height',BH);
    r.setAttribute('rx',5);
    r.setAttribute('fill',n.kind==='input'?'#dbeafe':n.kind==='output'?'#dcfce7':'#f1f5f9');
    r.setAttribute('stroke','#64748b');el.appendChild(r);
    const t=document.createElementNS(NS,'text');
    t.setAttribute('x',x+BW/2);t.setAttribute('y',y+BH/2+3);
    t.setAttribute('text-anchor','middle');t.setAttribute('font-size','9');
    t.textContent=n.label.split('\\n')[0];   // textContent: remote-safe
    el.appendChild(t);});
}
function scatterChart(svg,coords){
  const el=document.getElementById(svg); el.replaceChildren();
  if(!coords||!coords.length){return}
  const W=el.clientWidth||420,H=el.clientHeight||300,P=20;
  const xs=coords.map(c=>c[0]),ys=coords.map(c=>c[1]);
  const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
  const labels=[...new Set(coords.map(c=>c[2]))];
  const NS='http://www.w3.org/2000/svg';
  coords.forEach(c=>{
    const p=document.createElementNS(NS,'circle');
    p.setAttribute('cx',P+(W-2*P)*(x1>x0?(c[0]-x0)/(x1-x0):0.5));
    p.setAttribute('cy',H-P-(H-2*P)*(y1>y0?(c[1]-y0)/(y1-y0):0.5));
    p.setAttribute('r',2.5);
    p.setAttribute('fill',COLORS[labels.indexOf(c[2])%6]);
    const t=document.createElementNS(NS,'title');
    t.textContent=c[2];p.appendChild(t);   // tooltip via textContent
    el.appendChild(p);});
}
function barChart(svg,hist){
  const el=document.getElementById(svg); el.innerHTML='';
  if(!hist){return}
  const W=el.clientWidth||420,H=el.clientHeight||220,P=30;
  const n=hist.counts.length,max=Math.max(...hist.counts,1);
  let g='';
  for(let i=0;i<n;i++){
    const h=(H-2*P)*hist.counts[i]/max;
    g+=`<rect x="${P+(W-2*P)*i/n}" y="${H-P-h}" width="${(W-2*P)/n-1}" height="${h}" fill="#2563eb"/>`;
  }
  g+=`<text x="${P}" y="${H-8}" font-size="10">${hist.min.toPrecision(3)}</text>`;
  g+=`<text x="${W-P}" y="${H-8}" font-size="10" text-anchor="end">${hist.max.toPrecision(3)}</text>`;
  el.innerHTML=g;
}
// session ids / layer names / info fields are remote-supplied data: they are
// placed into the DOM with textContent/option values only, never innerHTML
function setOptions(el,items,selected){
  el.replaceChildren(...items.map(v=>{
    const o=document.createElement('option');
    o.textContent=v; o.selected=(v===selected); return o;}));
}
async function refresh(){
  const sEl=document.getElementById('session');
  const sessions=await (await fetch('/train/sessions')).json();
  setOptions(sEl,sessions,sEl.value);
  const sid=sEl.value||sessions[0];
  if(!sid){return}
  const ov=await (await fetch('/train/overview/data?sessionId='+encodeURIComponent(sid))).json();
  lineChart('score',{score:ov.scores});
  lineChart('perf',{'examples/sec':ov.examplesPerSec});
  const lEl=document.getElementById('layer');
  const md=await (await fetch('/train/model/data?sessionId='+encodeURIComponent(sid)+(lEl.value?'&layer='+encodeURIComponent(lEl.value):''))).json();
  setOptions(lEl,md.layers,md.layer);
  lineChart('pmm',md.paramMeanMag); lineChart('gmm',md.gradMeanMag);
  barChart('phist',md.paramHistogram);
  barChart('ghist',md.gradHistogram);
  const fl=await (await fetch('/train/flow/data?sessionId='+encodeURIComponent(sid))).json();
  flowChart('flow',fl);
  const ts=await (await fetch('/train/tsne/data')).json();
  scatterChart('tsne',ts.coords);
  const img=document.getElementById('convact');
  img.src='/train/activations?_='+Date.now();
  img.onerror=()=>{img.removeAttribute('src')};
  const sys=await (await fetch('/train/system/data?sessionId='+encodeURIComponent(sid))).json();
  lineChart('mem',sys.memory);
  const info=document.getElementById('info'); info.replaceChildren();
  const flat=(o,p)=>{for(const k in o){const v=o[k];
    if(v&&typeof v==='object'&&!Array.isArray(v)){flat(v,p+k+'.')}
    else{const tr=document.createElement('tr');
      const td1=document.createElement('td'); td1.textContent=p+k;
      const td2=document.createElement('td');
      td2.textContent=Array.isArray(v)?v.join(', '):String(v);
      tr.append(td1,td2); info.appendChild(tr);}}};
  flat(ov.info||{},'');
  document.getElementById('status').textContent=
    'iteration '+(ov.lastIteration??'-')+' · updated '+new Date().toLocaleTimeString();
}
refresh(); setInterval(refresh,2000);
</script></body></html>
"""
