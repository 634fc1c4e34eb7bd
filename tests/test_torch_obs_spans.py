"""The port's trace spans: when they record, where they go, one clock.

``obs.tracing`` spans record while ``DL4J_TORCH_TRACE_DIR`` is set or a
``torch.profiler`` profile records, and are the shared no-op object
otherwise. Under a profile each span is an ordinary host op of the
profile (never a user annotation, which the card's profiler mirrors as a
device event), stamped on the clock the Chrome file uses. A span open
when a profile starts or stops is dropped whole. The training step
(``TransformerLM``/``ViT.fit_batch``) and the generation scheduler
(``ContinuousLM``) carry the spans the benchmark's per-layer metrics
read; ``serve.queue_wait_seconds`` and ``serve.ttft_seconds`` record with
tracing off. The last test runs on the card only: device spans fill
``<name>.device_seconds`` with no synchronize in the span path.

No JAX here, so the card test runs where only PyTorch is installed::

    python -m pytest --noconftest -m cuda tests/test_torch_obs_spans.py
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
from deeplearning4j_tpu_torch.obs import tracing
from deeplearning4j_tpu_torch.serving import ContinuousLM
from deeplearning4j_tpu_torch.serving import decode as port_decode

FIT_SPANS = ("fit.step", "fit.input_copy", "fit.forward", "fit.backward",
             "fit.update", "fit.listeners")
SERVE_SPANS = ("serve.iteration", "serve.admit", "serve.prefill_window",
               "serve.decode_chunk", "serve.out_fetch")
V = 50


def small_lm():
    return TransformerLM(TransformerConfig(
        vocab_size=V, max_len=64, d_model=16, n_heads=2, n_layers=2,
        d_ff=32, seed=3), device="cpu").init()


def small_vit():
    return ViT(ViTConfig(image_size=8, patch_size=4, n_classes=3,
                         d_model=16, n_heads=2, n_layers=1, d_ff=32),
               device="cpu").init()


def tokens(rows=2, length=9):
    return np.arange(rows * length, dtype=np.int32).reshape(rows, length) \
        % (V - 1) + 1


def images():
    x = np.linspace(-1, 1, 2 * 8 * 8 * 3, dtype=np.float32)
    return x.reshape(2, 8, 8, 3), np.array([0, 2])


def serve_requests(sizes=(20, 3), n_new=4, **kw):
    """Serve one request per prompt size (20 tokens fill a prefill
    window, 3 teacher-force) to completion; returns the rows."""
    srv = ContinuousLM(small_lm(), slots=2, chunk=4, kv_ladder=(32, 64),
                       prefill_ladder=(16,), device="cpu")
    try:
        futs = [srv.submit(np.arange(1, 1 + n, dtype=np.int32), n_new, **kw)
                for n in sizes]
        return [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()


def profiled_serving():
    """A profile started and stopped on the scheduler's thread, from
    streamed spans, as the benchmark takes it: request A's first span
    starts it and submits B (20 tokens: an admit, two prefill windows);
    B's last span stops it. Returns the profile."""
    srv = ContinuousLM(small_lm(), slots=2, chunk=4, kv_ladder=(32, 64),
                       prefill_ladder=(16,), device="cpu")
    prof = profile(activities=[ProfilerActivity.CPU])
    futs = []

    def on_a(span):
        if len(futs) == 1:
            prof.start()
            futs.append(srv.submit(np.arange(1, 21, dtype=np.int32), 4,
                                   on_tokens=on_b))

    def on_b(span, got=[]):
        got.extend(span)
        if len(got) == 4:
            prof.stop()

    try:
        futs.append(srv.submit(np.arange(1, 4, dtype=np.int32), 24,
                               on_tokens=on_a))
        futs[0].result(timeout=120)
        futs[1].result(timeout=120)
    finally:
        srv.stop()
    return prof


def device_observations():
    h = obs.metrics_snapshot()["histograms"]
    return {n: v["count"] for n, v in h.items()
            if n.endswith(".device_seconds") and v["count"]}


def chrome_spans(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e["ph"] == "X"]


def host_events(prof):
    """(name, device type, user annotation, start ns) of every event."""
    return [(e.name(), str(e.device_type()).rsplit(".", 1)[-1],
             e.is_user_annotation(), e.start_ns())
            for e in prof.profiler.kineto_results.events()]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DL4J_TORCH_TRACE_DIR", raising=False)
    obs.reset_metrics()
    tracing.reset_trace()
    yield
    tracing.reset_trace()


@pytest.fixture
def trace_on(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_TRACE_DIR", str(tmp_path))
    return tmp_path


def test_span_is_the_null_object_when_nothing_records():
    assert not tracing.recording()
    for kw in ({}, {"device": "cpu"}, {"device": "cuda"}, {"req": 1}):
        assert obs.span("t.off", **kw) is tracing._NULL_SPAN


def test_fit_batch_and_request_record_nothing_when_off():
    small_lm().fit_batch(tokens())
    small_vit().fit_batch(*images())
    serve_requests()
    assert tracing.event_count() == 0
    assert device_observations() == {}


def test_spans_are_host_ops_of_a_profile():
    lm, vit = small_lm(), small_vit()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lm.fit_batch(tokens())
        vit.fit_batch(*images())
    events = host_events(prof) + host_events(profiled_serving())
    names = {n for n, *_ in events}
    assert set(FIT_SPANS + SERVE_SPANS) <= names
    ours = [e for e in events if e[0] in FIT_SPANS + SERVE_SPANS]
    assert all(dev == "CPU" and not user for _, dev, user, _ in ours)
    fwd = [e for e in events if e[0] == "fit.forward"]
    assert len(fwd) == 2   # one a step, the LM's and the ViT's
    assert device_observations() == {}   # a CPU device: host time only


def test_chrome_timestamp_and_profiler_range_share_a_clock(trace_on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("t.clock"):
            time.sleep(0.002)
    (start_ns,) = [s for n, _, _, s in host_events(prof) if n == "t.clock"]
    (event,) = [e for e in chrome_spans(tracing.flush())
                if e["name"] == "t.clock"]
    assert abs(event["ts"] - start_ns / 1e3) < 1000
    assert event["dur"] >= 2000


def test_add_span_converts_the_monotonic_clock(trace_on):
    t0 = time.perf_counter()
    wall_us = time.time_ns() / 1e3
    obs.add_span("t.manual", t0, 0.25, status=0)
    (event,) = chrome_spans(tracing.flush())
    assert abs(event["ts"] - wall_us) < 1000
    assert event["dur"] == 250_000 and event["args"] == {"status": 0}


def test_parent_and_req_are_set(trace_on):
    small_lm().fit_batch(tokens())
    serve_requests()
    spans = chrome_spans(tracing.flush())
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert set(FIT_SPANS + SERVE_SPANS) <= set(by)
    assert "args" not in by["fit.step"][0]   # top level, no args
    for name in FIT_SPANS[1:]:
        assert by[name][0]["args"]["parent"] == "fit.step"
    for name in SERVE_SPANS[1:]:
        assert all(e["args"]["parent"] == "serve.iteration"
                   for e in by[name])
    assert "args" not in by["serve.iteration"][0]
    reqs = {e["args"]["req"] for e in by["serve.admit"]}
    assert len(reqs) == 2
    windows = [e["args"] for e in by["serve.prefill_window"]]
    assert len(windows) == 2   # the 20-token prompt's 19 tokens: 16 + 3
    assert {w["req"] for w in windows} < reqs
    assert all(w["rung"] == 16 and w["inject"] is False for w in windows)
    chunk = by["serve.decode_chunk"][0]["args"]
    assert chunk["mode"] == "greedy" and chunk["rung"] in (32, 64)
    assert 1 <= chunk["active"] <= 2


@pytest.mark.parametrize("edge", ["start", "stop"])
def test_span_straddling_a_profile_edge_is_dropped(trace_on, edge):
    prof = profile(activities=[ProfilerActivity.CPU])
    if edge == "stop":
        prof.start()
    with obs.span("t.straddle"):
        if edge == "start":
            prof.start()
        else:
            prof.stop()
    with obs.span("t.after"):
        pass
    if edge == "start":
        prof.stop()
    names = [e["name"] for e in chrome_spans(tracing.flush())]
    assert names == ["t.after"]
    if edge == "start":   # the profiler ends a range open at its stop
        assert "t.straddle" not in {n for n, *_ in host_events(prof)}


def test_queue_wait_counts_every_admission_with_tracing_off():
    sizes = (3, 20, 5, 4, 6)   # five requests on two slots: three queue
    serve_requests(sizes)
    h = obs.metrics_snapshot()["histograms"]
    assert h["serve.queue_wait_seconds"]["count"] == len(sizes)
    assert h["serve.ttft_seconds"]["count"] == len(sizes)
    assert tracing.event_count() == 0


@pytest.mark.parametrize("stream", [False, True])
def test_ttft_is_recorded_once_the_first_token_is_done(monkeypatch, stream):
    """A 3-token prompt teacher-forces through the first chunk of 4, which
    samples its first token; 12 new tokens take four chunks. Each chunk
    and each ``out`` fetch is slowed by ``slow``. A streamed request's
    first token arrives with the fetch after the first chunk; an
    unstreamed one is fetched only at completion, and its first token is
    counted at the next scheduler pass after its chunk, long before."""
    slow = 0.1
    decode, fetch = port_decode._SlotPool.decode, port_decode._SlotPool.out_rows

    def slow_decode(pool, *args):
        decode(pool, *args)
        time.sleep(slow)

    def slow_fetch(pool):
        time.sleep(slow)
        return fetch(pool)

    monkeypatch.setattr(port_decode._SlotPool, "decode", slow_decode)
    monkeypatch.setattr(port_decode._SlotPool, "out_rows", slow_fetch)
    seen = []
    kw = {"on_tokens": seen.append} if stream else {}
    serve_requests((3,), n_new=12, **kw)
    h = obs.metrics_snapshot()["histograms"]
    ttft, req = h["serve.ttft_seconds"], h["serve.request_seconds"]
    assert ttft["count"] == req["count"] == 1
    assert ttft["sum"] >= (2 if stream else 1) * slow   # the fetch counts
    assert ttft["sum"] <= req["sum"] - 2 * slow   # three chunks later
    assert bool(seen) == stream


@pytest.mark.cuda
def test_device_spans_fill_without_a_synchronize(trace_on, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    (a @ a).sum().item()

    def refused(*args, **kw):
        raise AssertionError("the span path synchronized")

    def work():
        nonlocal a
        for _ in range(4):
            a = a @ a
            a = a / a.norm()

    n, cap = 6, 4
    monkeypatch.setattr(tracing, "_MAX_PENDING", cap)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", refused)
        m.setattr(torch.cuda.Event, "synchronize", refused)
        m.setattr(torch.cuda.Event, "wait", refused)
        for _ in range(n):
            with obs.span("t.gemm", device=dev):
                work()
        pending = len(tracing._PENDING)
    assert 1 <= pending <= n   # the card ran behind; the cap resolves
    # a span straddling a profile's start records no device time
    prof = profile(activities=[ProfilerActivity.CPU])
    with obs.span("t.straddle", device=dev):
        prof.start()
        work()
    prof.stop()
    torch.cuda.synchronize()
    tracing.resolve_device_spans()
    assert not tracing._PENDING
    assert device_observations() == {"t.gemm.device_seconds": n}
    h = obs.metrics_snapshot()["histograms"]["t.gemm.device_seconds"]
    assert h["min"] > 0
