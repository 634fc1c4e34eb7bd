"""The port's ReplicaRouter held to the reference's router contracts.

After ``tests/test_serving_resilience.py``'s router class, on the CPU, at
the reference's ``small_lm`` sizes: the balance away from a slow replica,
kill-replica failover with at-most-once delivery and nothing lost, the
SLO shed gate closing and reopening, synchronous validation errors, and
drain then submit. Every routed row is held to the JAX ContinuousLM's row
for the same prompt, on one parameter tree carried across by
``params_from_numpy``.

Nothing here depends on timing: a replica is made slow, or killed, at a
gate the test opens itself (its ``_replica_fault`` seam, which the loop
calls after admitting and before each dispatch), and the heartbeat is
parked (``heartbeat_s`` of an hour) while the test calls ``check()`` at
the point it chooses, as ``bench.py``'s ``serve_scale`` does. The
reference's own kill-replica test waits on its heartbeat, and is flaky.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.errors import (ServeQueueFullError,
                                             ServeReplicaDeadError,
                                             ServeStoppedError, ServingError)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, params_from_numpy)
from deeplearning4j_tpu_torch.serving import ContinuousLM, ReplicaRouter
from deeplearning4j_tpu_torch.serving._base import _REQ_SECONDS
from deeplearning4j_tpu_torch.serving.router import _delta_quantile
from deeplearning4j_tpu_torch.testing import faults

KW = dict(vocab_size=50, max_len=64, d_model=16, n_heads=2, n_layers=2,
          d_ff=32, seed=3)
N_NEW = 3
PARKED = 3600.0     # a heartbeat that never beats during a test
WAIT = 120.0        # bound on every wait; none is reached when all is well
PROMPTS = [np.array([(7 * i + j) % 49 + 1 for j in range(3 + i % 4)],
                    np.int32) for i in range(12)]


@pytest.fixture(scope="module")
def models():
    """(port LM on the CPU, {prompt: the JAX ContinuousLM's row})."""
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig as JaxConfig, TransformerLM as JaxLM)
    from deeplearning4j_tpu.serving import ContinuousLM as JaxContinuousLM
    jlm = JaxLM(JaxConfig(**KW)).init()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)
                                   + (np.asarray(a) == 1)).astype(np.float32),
                        jax.tree.map(np.asarray, jlm.params))
    jlm.params = jax.tree.map(jnp.asarray, tree)
    plm = TransformerLM(TransformerConfig(**KW), device="cpu")
    plm.params = params_from_numpy(tree, "cpu")
    jsrv = JaxContinuousLM(jlm, slots=2, chunk=4)
    try:
        want = {tuple(p): np.asarray(f.result(240)) for p, f in
                [(p, jsrv.submit(p, N_NEW)) for p in PROMPTS]}
    finally:
        jsrv.stop()
    assert len({tuple(r[-N_NEW:]) for r in want.values()}) > 3
    return plm, want


@pytest.fixture(autouse=True)
def _clean():
    obs.reset_metrics()
    faults.clear()
    yield
    faults.clear()


def replicas(lm, n=2):
    return [ContinuousLM(lm, slots=2, chunk=4, device="cpu")
            for _ in range(n)]


def gate(rep, die):
    """Hold ``rep``'s loop at its next dispatch, after it admitted what it
    had, until the test releases it; then the loop dies there (a hard
    crash, as the ``kill-replica`` fault) or goes on."""
    entered, release = threading.Event(), threading.Event()
    fired = []

    def fault():
        if fired:
            return False
        fired.append(True)
        entered.set()
        assert release.wait(WAIT)
        if die:
            with rep._lock:
                rep._died = True
        return die
    rep._replica_fault = fault
    return entered, release


def recorded(rep):
    """The prompts ``rep`` was asked to serve, in order."""
    seen = []
    submit = rep.submit

    def wrapper(prompt, *a, **k):
        seen.append(tuple(np.asarray(prompt)))
        return submit(prompt, *a, **k)
    rep.submit = wrapper
    return seen


def test_error_status_contract_covers_the_replica_death():
    subs, todo = set(), [ServingError]
    while todo:
        for sub in todo.pop().__subclasses__():
            subs.add(sub)
            todo.append(sub)
    assert {s.__name__: (s.http_status, s.retryable) for s in subs} == {
        "ServeQueueFullError": (429, True),
        "ServeStoppedError": (503, True),
        "ServeDeadlineError": (504, False),
        "ServeReplicaDeadError": (502, True)}


def test_replicas_share_the_parameters_and_give_the_reference_rows(models):
    lm, want = models
    params = lm.params
    reps = replicas(lm)
    router = ReplicaRouter(reps, heartbeat_s=PARKED, slo_ms=0.0)
    seen = [recorded(r) for r in reps]
    try:
        futs = [(p, router.submit(p, N_NEW)) for p in PROMPTS[:6]]
        for p, f in futs:
            np.testing.assert_array_equal(f.result(WAIT), want[tuple(p)])
        assert lm.params is params and all(r.lm is lm for r in reps)
        assert sum(map(len, seen)) == 6
    finally:
        router.stop()


def test_balances_away_from_a_slow_replica(models):
    lm, want = models
    reps = replicas(lm)
    router = ReplicaRouter(reps, heartbeat_s=PARKED, slo_ms=0.0)
    entered, release = gate(reps[0], die=False)
    try:
        slow = router.submit(PROMPTS[0], N_NEW)   # equal loads: replica 0
        assert entered.wait(WAIT)                 # admitted, held
        assert reps[0].load() == 1 and reps[1].load() == 0
        fast = router.submit(PROMPTS[1], N_NEW)   # the lighter replica
        np.testing.assert_array_equal(fast.result(WAIT),
                                      want[tuple(PROMPTS[1])])
        assert not slow.done()
        release.set()
        np.testing.assert_array_equal(slow.result(WAIT),
                                      want[tuple(PROMPTS[0])])
    finally:
        release.set()
        router.stop()


def test_kill_replica_at_most_once_and_nothing_lost(models):
    """Replica 0 dies with one request admitted and two queued; replica 1
    is held with one admitted and two queued. A hand-driven heartbeat
    fails the admitted one typed (never run again anywhere) and moves the
    queued two to the survivor, which serves all five."""
    lm, want = models
    reps = replicas(lm)
    router = ReplicaRouter(reps, heartbeat_s=PARKED, slo_ms=0.0)
    dead_entered, dead_release = gate(reps[0], die=True)
    live_entered, live_release = gate(reps[1], die=False)
    seen = recorded(reps[1])
    futs = []
    try:
        futs.append(router.submit(PROMPTS[0], N_NEW))   # replica 0, admitted
        assert dead_entered.wait(WAIT)
        futs.append(router.submit(PROMPTS[1], N_NEW))   # replica 1, admitted
        assert live_entered.wait(WAIT)
        # both loops are held: the loads decide alone, ties to replica 0
        for p in PROMPTS[2:6]:
            futs.append(router.submit(p, N_NEW))
        assert [r.load() for r in reps] == [3, 3]
        assert len(reps[0]._pending) == 2 and len(reps[1]._pending) == 2
        dead_release.set()
        reps[0]._thread.join(WAIT)
        assert not reps[0]._thread.is_alive() and not reps[0].healthy()
        with pytest.warns(RuntimeWarning, match="failed over"):
            router.check()
        assert router.healthy_count() == 1 and router.healthy()
        assert reps[0].load() == 0          # its side cancelled
        with pytest.raises(ServeReplicaDeadError) as ei:
            futs[0].result(WAIT)
        assert ei.value.retryable and ei.value.http_status == 502
        live_release.set()
        for p, f in zip(PROMPTS[1:6], futs[1:]):
            np.testing.assert_array_equal(f.result(WAIT), want[tuple(p)])
        # the admitted request was never run again; the moved two were
        assert tuple(PROMPTS[0]) not in seen
        assert seen[-2:] == [tuple(PROMPTS[2]), tuple(PROMPTS[4])]
        assert obs.metrics.value("serve.replica_failovers_total") == 1
        assert obs.metrics.value("router.replicas_healthy") == 1
        # a second beat finds nothing more to do; the survivor serves on
        router.check()
        assert obs.metrics.value("serve.replica_failovers_total") == 1
        np.testing.assert_array_equal(
            router.submit(PROMPTS[6], N_NEW).result(WAIT),
            want[tuple(PROMPTS[6])])
    finally:
        dead_release.set()
        live_release.set()
        router.stop()


def test_slo_shed_gate_closes_and_reopens(models):
    lm, want = models
    router = ReplicaRouter(replicas(lm, 1), heartbeat_s=PARKED, slo_ms=50.0)
    try:
        router.check()                    # the window's baseline
        for _ in range(20):
            _REQ_SECONDS.record(0.4)      # a window with a 400 ms p99
        router.check()
        p99 = router.rolling_p99()
        assert p99 is not None and p99 * 1000.0 > 50.0
        with pytest.raises(ServeQueueFullError) as ei:
            router.submit(PROMPTS[0], N_NEW)
        assert "SLO" in str(ei.value) and ei.value.retryable
        assert obs.metrics.value("serve.shed_total") == 1
        # a quiet window (too few completions for a tail) reopens it
        router.check()
        assert router.rolling_p99() is None
        np.testing.assert_array_equal(
            router.submit(PROMPTS[0], N_NEW).result(WAIT),
            want[tuple(PROMPTS[0])])
    finally:
        router.stop()


def test_delta_quantile_interpolates_a_window():
    bounds = (0.1, 0.2, 0.4)
    assert _delta_quantile([0, 0, 0, 0], 0.99, bounds, None) is None
    assert _delta_quantile([10, 0, 0, 0], 0.5, bounds, 0.05) == 0.05
    assert _delta_quantile([0, 10, 0, 0], 0.5, bounds, None) == \
        pytest.approx(0.15)
    assert _delta_quantile([0, 0, 0, 3], 0.99, bounds, 7.0) == 7.0


def test_validation_errors_raise_synchronously(models):
    lm, _ = models
    router = ReplicaRouter(replicas(lm, 1), heartbeat_s=PARKED, slo_ms=0.0)
    try:
        with pytest.raises(ValueError):
            router.submit(PROMPTS[0], 0)          # n_new must be >= 1
        with pytest.raises(ValueError):
            router.submit(np.array([60], np.int32), 2)   # out of vocab
        assert router.load() == 0
    finally:
        router.stop()
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])


def test_drain_then_submit_is_typed(models):
    lm, want = models
    router = ReplicaRouter(replicas(lm, 1), heartbeat_s=PARKED, slo_ms=0.0)
    f = router.submit(PROMPTS[0], N_NEW)
    assert router.drain(timeout=WAIT) is True
    np.testing.assert_array_equal(f.result(5), want[tuple(PROMPTS[0])])
    assert not router.healthy()
    with pytest.raises(ServeStoppedError):
        router.submit(PROMPTS[0], N_NEW)
    router.stop()


def test_a_replica_that_refuses_work_is_skipped(models):
    """A replica that answers ``ServeStoppedError`` is marked unhealthy
    and the request goes to the next; with none left the error is the
    caller's."""
    lm, want = models
    reps = replicas(lm)
    router = ReplicaRouter(reps, heartbeat_s=PARKED, slo_ms=0.0)
    try:
        reps[0].stop()
        np.testing.assert_array_equal(
            router.submit(PROMPTS[3], N_NEW).result(WAIT),
            want[tuple(PROMPTS[3])])
        assert router.healthy_count() == 1
        reps[1].stop()
        with pytest.raises(ServeStoppedError):
            router.submit(PROMPTS[3], N_NEW)
    finally:
        router.stop()


def test_concurrent_clients_and_beats_lose_no_request(models):
    """More client threads than cores submitting through the router while
    another thread beats ``check()``, with a short switch interval: every
    future resolves to the reference's row, and the router's outstanding
    map and the replicas' loads drain to zero."""
    import os
    import sys
    lm, want = models
    reps = replicas(lm)
    router = ReplicaRouter(reps, heartbeat_s=PARKED, slo_ms=0.0)
    n_threads = max(8, 2 * (os.cpu_count() or 1))
    errors, done = [], []
    stop = threading.Event()

    def client(k):
        try:
            for i in range(3):
                p = PROMPTS[(k + i) % len(PROMPTS)]
                row = router.submit(p, N_NEW).result(WAIT)
                np.testing.assert_array_equal(row, want[tuple(p)])
                done.append(1)
        except Exception as e:          # reported by the assert below
            errors.append(e)

    def beat():
        while not stop.is_set():
            router.check()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=client, args=(k,))
              for k in range(n_threads)]
        hb = threading.Thread(target=beat)
        hb.start()
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
        stop.set()
        hb.join(WAIT)
        assert not any(t.is_alive() for t in ts) and not hb.is_alive()
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        router.stop()
    assert not errors, errors[:3]
    assert len(done) == 3 * n_threads
    assert not router._outstanding and router.load() == 0
    assert router.healthy_count() == 2
