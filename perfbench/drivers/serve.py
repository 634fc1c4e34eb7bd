"""Serving cells: the program's continuous-batching server over the
family's model, warmed with ``warm_start()`` and a few requests, then
driven for the window by an open loop (arrivals due on a schedule at the
cell's rate) or a closed loop (clients that each send their next request
when the last completes). Every request streams: the client clock reads
each span of tokens as it arrives.
"""

from __future__ import annotations

import math
import queue
import time

import torch

from perfbench import check, seeds, trace, traffic
from perfbench.reference.common import strict_f32

_LATE_S = 60.0   # how long past the close the run waits for an answer


def _submit(server, r, t0, tracer=None):
    r.submitted = time.perf_counter() - t0

    def on_tokens(span, r=r):
        r.arrivals.append((time.perf_counter() - t0, len(span)))
        if tracer is not None:
            tracer.on_tokens()

    try:
        r.future = server.submit(r.prompt, r.n_new,
                                 temperature=r.temperature, top_p=r.top_p,
                                 seed=r.seed, on_tokens=on_tokens)
    except Exception as e:   # refused (backpressure, stopped): a failure
        r.error = f"{type(e).__name__}: {e}"


def _wait(reqs, until):
    """Wait for every answer until ``until``; returns when it stopped."""
    for r in reqs:
        if r.future is None:
            continue
        try:
            r.future.result(timeout=max(until - time.perf_counter(), 0.0))
        except Exception as e:
            r.error = r.error or f"{type(e).__name__}: {e}"
    return time.perf_counter()


def _sleep_until(t):
    dt = t - time.perf_counter()
    if dt > 0:
        time.sleep(dt)


def p95(values):
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def _open_loop(job, server, reqs, t0, tracer):
    """Each request sent when it falls due."""
    for r in reqs:
        _sleep_until(t0 + r.due)
        _submit(server, r, t0, tracer)
    _sleep_until(t0 + job.seconds)
    return reqs


def _closed_loop(job, server, pool, t0, tracer):
    """The cell's clients, each sending the pool's next request when its
    last completes; returns the requests sent."""
    tr = job.traffic
    pool = iter(pool)
    done, reqs = queue.Queue(), []
    end = t0 + job.seconds

    def launch():
        r = next(pool, None)
        if r is None:   # the pool outlasts any window the cell sets
            return
        r.due = time.perf_counter() - t0
        reqs.append(r)
        _submit(server, r, t0, tracer)
        if r.future is None:
            done.put(r)
        else:
            r.future.add_done_callback(lambda _f: done.put(r))

    for _ in range(tr["clients"]):
        launch()
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        try:
            done.get(timeout=min(end - now, 0.05))
        except queue.Empty:
            continue
        launch()
    return reqs


class _Tracer:
    """In a traced run, the profile over the window's last
    ``trace_seconds``. It starts and stops on the scheduler's thread, from
    the first streamed span at or after each moment, so no other thread
    launches device work meanwhile (the client's thread only sleeps and
    submits)."""

    def __init__(self, job):
        self.rec = job.recorder() if job.trace else None
        self.state, self.error = "off", None
        if self.rec is not None:
            trace.prime()   # before the scheduler's thread exists

    def begin(self, t0, seconds, trace_seconds):
        self.at, self.end = t0 + seconds - trace_seconds, t0 + seconds

    def on_tokens(self):
        if self.rec is None or self.state == "done":
            return
        now = time.perf_counter()
        try:
            if self.state == "off" and now >= self.at:
                self.rec.start()
                self.rec.open()
                self.state = "open"
            elif self.state == "open" and now >= self.end:
                self.rec.close()
                self.rec.stop()
                self.state = "done"
        except Exception as e:   # kept for the main thread to raise
            self.error, self.state = e, "done"

    def result(self):
        """The trace, once every answer is in (the scheduler idles)."""
        if self.rec is None:
            return None
        if self.error is not None:
            raise self.error
        if self.state == "open":
            self.rec.close()
            self.rec.stop()
        if self.state == "off":
            raise RuntimeError("no streamed span came in the traced span")
        return self.rec.result()


def _counters(snap):
    out = dict(snap["counters"])
    for name, h in snap["histograms"].items():
        out[name + ".sum"], out[name + ".count"] = h["sum"], h["count"]
    return out


def run(job):
    from deeplearning4j_tpu_torch.obs import metrics as program_metrics
    from deeplearning4j_tpu_torch.serving.decode import ContinuousLM
    fam, cfg, tr, dev = job.family, job.cfg, job.traffic, job.device
    vocab = cfg["vocab_size"]
    lm = fam.port_model(cfg, fam.init_weights(cfg, job.seed, dev), dev)
    server = ContinuousLM(
        lm, slots=tr["slots"], chunk=tr["chunk"], queue_cap=tr["queue_cap"],
        seed=int(seeds.host(job.seed, "pool").integers(2 ** 31)),
        device=dev)
    server.warm_start()
    job.fault(server)
    tracer = _Tracer(job)   # the first submit starts the scheduler
    warm = traffic.requests(tr, vocab, job.seed, tr["warm_requests"],
                            stream="warm")
    t = time.perf_counter()
    for r in warm:
        _submit(server, r, t)
    _wait(warm, time.perf_counter() + 300)
    job.setup_done()

    if tr["arrivals"] == "poisson":
        loop, n = _open_loop, round(tr["rate"] * job.seconds)
        reqs = traffic.requests(tr, vocab, job.seed, n)
        for r, due in zip(reqs, traffic.arrivals(tr, n, job.seconds)):
            r.due = due
    else:
        loop = _closed_loop
        reqs = traffic.requests(tr, vocab, job.seed, tr["pool"])
    before = _counters(program_metrics.metrics_snapshot())
    t0 = time.perf_counter()
    tracer.begin(t0, job.seconds, tr["trace_seconds"])
    reqs = loop(job, server, reqs, t0, tracer)
    after = _counters(program_metrics.metrics_snapshot())
    job.measure.counters = {k: after[k] - before.get(k, 0) for k in after}
    gave_up = _wait(reqs, time.perf_counter() + _LATE_S) - t0
    job.measure.trace = tracer.result()
    job.read_memory_peak()
    server.stop()

    S = job.seconds
    ok = [r for r in reqs if r.error is None and r.received == r.n_new]
    lost = len(reqs) - len(ok)
    done = {id(r) for r in ok}
    # an answer that never came counts as late as the wait for it
    ttft = [((r.arrivals[0][0] if id(r) in done else gave_up) - r.due) * 1e3
            for r in reqs]
    tpot = [(r.arrivals[-1][0] - r.arrivals[0][0]) / (r.n_new - 1) * 1e3
            if id(r) in done else gave_up * 1e3
            for r in reqs if r.n_new > 1]
    if tr["arrivals"] == "poisson":
        job.e2e["ttft_p95_ms"] = p95(ttft)
        job.e2e["tpot_p95_ms"] = p95(tpot)
    else:
        job.e2e["serve_tokens_per_s"] = sum(
            n for r in reqs for t, n in r.arrivals if t < S) / S
        job.measure.tails = {"ttft_p95_ms": p95(ttft),
                             "tpot_p95_ms": p95(tpot)}
    job.requests = reqs
    job.attempted = len(reqs)
    job.failed = sum(r.error is not None for r in reqs)

    del server, lm
    job.free()
    greedy = _check_sample(job, [r for r in ok if r.greedy], "check",
                           job.traffic["check_tokens"])
    sampled = _check_sample(job, [r for r in ok if not r.greedy],
                            "check.sampled",
                            job.traffic["check_sampled_tokens"])
    w = fam.init_weights(cfg, job.seed, dev)
    worst, terms = 0.0, []
    with strict_f32(), torch.no_grad():
        for r, toks in greedy:
            gaps = check.token_gaps(*fam.reference_served(cfg, w, r.prompt,
                                                          toks, dev))
            worst = max(worst, float(gaps.max()))
        for r, toks in sampled:
            logits, t = fam.reference_served(cfg, w, r.prompt, toks, dev)
            terms.append((r.top_p, check.sampled_terms(
                logits, t, r.temperature, r.top_p)))
    job.numbers.update({"greedy_gap": worst, "lost": lost},
                       **check.sampled_numbers(terms))
    job.notes.update({
        "compared_tokens": sum(len(t) for _, t in greedy),
        "compared_requests": len(greedy),
        "compared_sampled_tokens": sum(len(t) for _, t in sampled),
        "compared_sampled_requests": len(sampled)})
    job.served, job.served_sampled = greedy, sampled


def _check_sample(job, done, stream, tokens):
    """The requests of ``done`` the check compares: the one with the most
    served tokens, then others in an order the seed draws, until
    ``tokens`` served tokens are reached."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r.n_new, len(r.prompt)))
    rest = [r for r in done if r is not longest]
    order = seeds.host(job.seed, stream).permutation(len(rest))
    picked, total = [longest], longest.n_new
    for i in order:
        if total >= tokens:
            break
        picked.append(rest[i])
        total += rest[i].n_new
    return [(r, r.future.result()[len(r.prompt):]) for r in picked]
