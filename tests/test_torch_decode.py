"""The port's ContinuousLM held to the reference's serving contracts.

Case by case after ``tests/test_serving.py``'s continuous-decode,
paged-prefill, per-request-sampling, teardown and autotune classes, on
the CPU (every program runs eagerly; the same bodies are captured as
CUDA graphs on the card, ``tests/test_torch_cuda.py``): greedy rows equal
to the port's own ``generate()`` across slot reuse and mid-decode
admission, every KV rung equal to the ``max_len`` rung, chunked prefill
equal to teacher forcing, a prefix-cache hit equal to a cold run, a fixed
program inventory with nothing built after ``warm_start``, sampled rows
invariant to how requests interleave, the lifecycle (validation, typed
stop, restart at full capacity on a fresh pool), the ladder knobs, the
slot width from memory, the probe persisted and adopted through the
decision cache, streaming, deadlines, the fault sites, and one
end-to-end greedy comparison with the JAX ContinuousLM. These contracts
are bitwise: the port's CPU decode math is batch-invariant
(``models/transformer.py``: ``_mm``, ``_attend``).
"""

import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.errors import (ServeDeadlineError,
                                             ServeQueueFullError,
                                             ServeStoppedError)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, params_from_numpy)
from deeplearning4j_tpu_torch.serving import (ContinuousLM, kv_ladder,
                                              prefill_ladder, slots_ladder)
from deeplearning4j_tpu_torch.serving import decode as port_decode
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.tuning import autotuner

V = 50


def small_lm(seed=3, pos_embed="learned", max_len=64, n_kv_heads=None):
    """The reference's ``small_lm`` (V 50, d 16, L 2, H 2) on the CPU,
    its seeded weights scaled up so greedy rows vary."""
    lm = TransformerLM(TransformerConfig(
        vocab_size=V, max_len=max_len, d_model=16, n_heads=2, n_layers=2,
        d_ff=32, pos_embed=pos_embed, n_kv_heads=n_kv_heads, seed=seed),
        device="cpu").init()
    with torch.no_grad():
        for p in lm.parameters():
            if p.ndim > 1:
                p.mul_(15.0)
    return lm


def server(lm, **kw):
    return ContinuousLM(lm, device="cpu", **kw)


def prompts(sizes):
    return [np.arange(1, 1 + n, dtype=np.int32) % 49 + 1 for n in sizes]


def greedy(lm, p, n_new):
    return lm.generate(p[None, :], n_new, temperature=0.0)[0]


@pytest.fixture(autouse=True)
def _clean():
    obs.reset_metrics()
    faults.clear()
    autotuner._reset_for_tests()
    yield
    faults.clear()
    autotuner._reset_for_tests()


def _inventory(S, chunk, kv, pf):
    sigs = [("admit", S)]
    sigs += [("decode", S, chunk, w, m) for w in kv
             for m in ("filter", "greedy", "sample")]
    sigs += [("prefill", S, w, v) for w in pf
             for v in ("compute", "inject")]
    return sorted(sigs)


class TestContinuousDecode:
    @pytest.mark.parametrize("kind", ["learned", "rope", "gqa"])
    def test_greedy_parity_with_generate_across_slot_reuse(self, kind):
        """More requests than slots: completions free rows that are
        re-admitted mid-decode; every row equals generate()'s."""
        lm = small_lm(pos_embed="rope" if kind == "rope" else "learned",
                      n_kv_heads=1 if kind == "gqa" else None)
        srv = server(lm, slots=2, chunk=4)
        ps = prompts((5, 3, 7, 2, 6, 4))
        try:
            got = [f.result(120) for f in [srv.submit(p, 6) for p in ps]]
        finally:
            srv.stop()
        for p, g in zip(ps, got):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, greedy(lm, p, 6))
        assert len({tuple(g[-6:]) for g in got}) > 2   # rows vary

    def test_fixed_inventory_nothing_built_after_warm_start(self):
        """warm_start builds the whole inventory, 3 sampler variants a KV
        rung, compute and inject a prefill rung, one admit; a mixed pool
        of greedy, filtered, sampled and prefix-hit requests builds and
        binds nothing new."""
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        try:
            srv.warm_start()
            want = _inventory(2, 4, (32, 64), (16, 64))
            assert srv.graph_inventory() == want
            assert sorted(lm._jit_decode) == want
            graphs = dict(srv._pool.graphs)
            p = prompts((40,))[0]
            futs = [srv.submit(p, 5), srv.submit(prompts((3,))[0], 5),
                    srv.submit(prompts((25,))[0], 5, temperature=0.8,
                               top_k=4, seed=2),
                    srv.submit(p, 5),   # a prefix hit
                    srv.submit(prompts((6,))[0], 5, temperature=1.1,
                               seed=3)]
            got = [f.result(240) for f in futs]
            assert srv.graph_inventory() == want
            assert sorted(lm._jit_decode) == want
            assert all(srv._pool.graphs[k] is g for k, g in graphs.items())
        finally:
            srv.stop()
        assert obs.metrics.value("serve.prefix_hits_total") > 0
        np.testing.assert_array_equal(got[0], greedy(lm, p, 5))
        np.testing.assert_array_equal(got[3], got[0])
        assert obs.metrics.value("serve.tokens_total") >= 5 * 5

    def test_mid_decode_admission(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=2)
        try:
            long_f = srv.submit(prompts((4,))[0], 30)
            time.sleep(0.05)              # the long row is mid-decode now
            short = srv.generate(prompts((3,))[0], 4, timeout=120)
            long_out = long_f.result(120)
        finally:
            srv.stop()
        np.testing.assert_array_equal(short, greedy(lm, prompts((3,))[0], 4))
        np.testing.assert_array_equal(long_out,
                                      greedy(lm, prompts((4,))[0], 30))

    def test_sampled_serving_stays_in_vocab(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        try:
            out = srv.generate(prompts((4,))[0], 8, temperature=1.0, seed=7,
                               timeout=120)
        finally:
            srv.stop()
        assert out.shape == (12,)
        assert (out >= 0).all() and (out < V).all()

    def test_submit_validation(self):
        lm = small_lm(max_len=16)
        srv = server(lm, slots=2, chunk=2)
        try:
            for args in ((np.zeros(0, np.int32), 4), (prompts((4,))[0], 0),
                         (prompts((10,))[0], 10), (np.array([3, V]), 2)):
                with pytest.raises(ValueError):
                    srv.submit(*args)
            with pytest.raises(ValueError, match="callable"):
                srv.submit(prompts((4,))[0], 2, on_tokens=3)
        finally:
            srv.stop()

    def test_overflow_and_disconnect_sites(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        try:
            with faults.inject("queue-overflow@0"):
                with pytest.raises(ServeQueueFullError):
                    srv.submit(prompts((4,))[0], 4)
            with faults.inject("client-disconnect@0"):
                f1 = srv.submit(prompts((4,))[0], 4)
                f2 = srv.submit(prompts((3,))[0], 4)
                r2 = f2.result(120)
            assert r2.shape == (7,)
            assert f1.cancelled()               # caller gone, discarded
            assert obs.metrics.value("serve.disconnects_total") == 1
            assert srv.generate(prompts((5,))[0], 4,
                                timeout=120).shape == (9,)
        finally:
            srv.stop()

    def test_slow_request_and_kill_replica_sites(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        try:
            with faults.inject("slow-request@0:0.2"):
                t0 = time.monotonic()
                srv.generate(prompts((4,))[0], 4, timeout=120)
                assert time.monotonic() - t0 >= 0.2
                h = obs.metrics.histogram("serve.request_seconds")
                assert h.summary()["max"] >= 0.2
            with faults.inject("kill-replica@0"):
                f = srv.submit(prompts((4,))[0], 4)
                deadline = time.monotonic() + 10
                while srv.healthy() and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert not srv.healthy()
                assert not f.done()   # a hard crash resolves nothing
                with pytest.raises(ServeStoppedError, match="died"):
                    srv.submit(prompts((4,))[0], 4)
        finally:
            srv.stop()
        assert isinstance(f.exception(timeout=5), ServeStoppedError)

    def test_stop_fails_inflight_typed(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=2)
        p = prompts((4,))[0]
        f = srv.submit(p, 40)
        time.sleep(0.05)
        srv.stop()
        exc = f.exception(timeout=5)
        if exc is None:
            assert f.result().shape == (44,)
        else:
            assert isinstance(exc, ServeStoppedError), exc
        with pytest.raises(ServeStoppedError):
            srv.submit(p, 4)

    def test_restart_after_stop_binds_a_fresh_pool_at_full_capacity(self):
        """stop() with rows in flight releases the pool (state, graphs,
        staging); start() binds a fresh one at full width whose programs
        are all bound to its own state, never to the dropped one."""
        lm = small_lm()
        srv = server(lm, slots=2, chunk=2)
        srv.warm_start()
        old = srv._pool
        old_state = old.state
        inflight = [srv.submit(p, 40) for p in prompts((4, 3))]
        time.sleep(0.05)
        srv.stop()
        for f in inflight:
            assert f.done()
            exc = f.exception()
            assert exc is None or isinstance(exc, ServeStoppedError)
        assert srv._pool is None and srv.graph_inventory() == []
        srv.start()
        ps = prompts((3, 5, 4, 6))
        try:
            got = [f.result(120) for f in [srv.submit(p, 4) for p in ps]]
            pool = srv._pool
            assert pool is not old and pool.state is not old_state
            assert all(g.fn.__closure__ is not None for g in
                       pool.graphs.values())
            for g in pool.graphs.values():   # bound to the live pool only
                cells = [c.cell_contents for c in g.fn.__closure__]
                assert pool in cells and old not in cells
        finally:
            srv.stop()
        for p, g in zip(ps, got):
            np.testing.assert_array_equal(g, greedy(lm, p, 4))

    def test_warm_start_resets_the_pool_in_place(self):
        """The warm dispatches' scribbles are reset in place: the graphs
        keep their storage, and the first request starts from a blank
        pool."""
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        srv.warm_start()
        state = srv._pool.state
        ptrs = [t.data_ptr() for t in state["k"] + [state["pos"]]]
        fresh = lm._init_decode_state(2)
        for k in ("pos", "last", "out", "plen", "topk", "topp", "active"):
            assert torch.equal(state[k], fresh[k]), k
        try:
            p = prompts((5,))[0]
            np.testing.assert_array_equal(srv.generate(p, 4, timeout=60),
                                          greedy(lm, p, 4))
            assert [t.data_ptr() for t in state["k"] + [state["pos"]]] \
                == ptrs
        finally:
            srv.stop()

    def test_ladder_knob_garbage_warns_and_falls_back(self, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_SERVE_SLOTS_LADDER", "2,x")
        with pytest.warns(UserWarning, match="SLOTS_LADDER"):
            assert slots_ladder() == (2, 4, 8)

    def test_refuses_a_model_on_another_device(self):
        lm = small_lm()
        with pytest.raises(ValueError, match="lives on"):
            ContinuousLM(lm, device="meta")


class TestPagedPrefill:
    def test_kv_ladder_derivation_and_off(self, monkeypatch):
        assert kv_ladder(64, 4) == (32, 64)
        assert kv_ladder(64, 4, "off") == (64,)
        assert kv_ladder(256, 8, (16, 48, 128)) == (16, 48, 128, 256)
        assert kv_ladder(2048, 8)[-1] == 2048
        assert prefill_ladder(64) == (16, 64)
        assert prefill_ladder(64, "off") == ()
        assert prefill_ladder(300) == (16, 64, 256)
        monkeypatch.setenv("DL4J_TORCH_SERVE_KV_LADDER", "32,x")
        with pytest.warns(UserWarning, match="KV_LADDER"):
            assert kv_ladder(64, 4) == (32, 64)   # garbage -> derived
        monkeypatch.setenv("DL4J_TORCH_SERVE_PREFILL_LADDER", "8,y")
        with pytest.warns(UserWarning, match="PREFILL_LADDER"):
            assert prefill_ladder(64) == ()

    @pytest.mark.parametrize("pos_embed", ["learned", "rope"])
    def test_greedy_parity_every_rung(self, pos_embed):
        """The pool crosses every decode rung and both prefill rungs; each
        row equals generate() and the max_len-rung server's."""
        lm = small_lm(pos_embed=pos_embed)
        ps = prompts((3, 9, 17, 30))
        rows = {}
        for name, kv in (("paged", (16, 32, 64)), ("max_len", "off")):
            srv = server(lm, slots=2, chunk=4, kv_ladder=kv,
                         prefill_ladder=(8, 16), prefix_cache_mb=8)
            try:
                rows[name] = [f.result(240)
                              for f in [srv.submit(p, 8) for p in ps]]
            finally:
                srv.stop()
        for p, a, b in zip(ps, rows["paged"], rows["max_len"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, greedy(lm, p, 8))
        assert sorted({s[3] for s in lm._jit_decode if s[0] == "decode"}) \
            == [16, 32, 64]

    def test_prefill_equals_teacher_forced(self):
        """A prompt through the prefill windows leaves the slot's K/V
        rows, position and tokens bit-equal to teacher-forcing it through
        the decode chunk."""
        lm = small_lm()
        p = prompts((30,))[0]
        states = {}
        for name, pf in (("prefill", (8, 16)), ("forced", "off")):
            srv = server(lm, slots=2, chunk=4, prefill_ladder=pf,
                         prefix_cache_mb=0)
            try:
                out = srv.generate(p, 4, timeout=120)
                states[name] = (out, {k: [t.clone() for t in srv._pool.state[k]]
                                      for k in ("k", "v")})
            finally:
                srv.stop()
        (a, sa), (b, sb) = states["prefill"], states["forced"]
        np.testing.assert_array_equal(a, b)
        n = p.size + 3   # positions the request wrote
        for x, y in zip(sa["k"] + sa["v"], sb["k"] + sb["v"]):
            slot_x = int(x[:, :, :n].abs().sum((1, 2, 3)).argmax())
            slot_y = int(y[:, :, :n].abs().sum((1, 2, 3)).argmax())
            assert torch.equal(x[slot_x, :, :n], y[slot_y, :, :n])

    def test_prefix_hit_bit_equals_cold(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4, kv_ladder=(32, 64),
                     prefill_ladder=(8, 16), prefix_cache_mb=8)
        try:
            p = prompts((33,))[0]
            cold = srv.generate(p, 6, timeout=240)
            assert obs.metrics.value("serve.prefix_hits_total") == 0
            warm = srv.generate(p, 6, timeout=240)
        finally:
            srv.stop()
        assert obs.metrics.value("serve.prefix_hits_total") > 0
        np.testing.assert_array_equal(cold, warm)
        np.testing.assert_array_equal(cold, greedy(lm, p, 6))

    def test_prefix_pages_of_other_parameters_never_inject(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4, prefill_ladder=(8, 16),
                     prefix_cache_mb=8)
        p = prompts((33,))[0]
        try:
            srv.generate(p, 4, timeout=120)
            with torch.no_grad():
                lm.params["b0"]["fc"].mul_(1.5)   # trained in place
            hits = obs.metrics.value("serve.prefix_hits_total")
            again = srv.generate(p, 4, timeout=120)
            assert obs.metrics.value("serve.prefix_hits_total") == hits
        finally:
            srv.stop()
        np.testing.assert_array_equal(again, greedy(lm, p, 4))

    def test_prefix_cache_is_a_byte_bounded_lru(self):
        cache = port_decode._PrefixKVCache(3 * 64)
        pages = [torch.zeros(8) for _ in range(8)]   # 32 bytes each
        for i in range(4):
            cache.put(f"k{i}", pages[2 * i], pages[2 * i + 1], 0, 8, 8)
        assert len(cache) == 3 and cache.get("k0", 0, 8, 8) is None
        assert cache.get("k1", 0, 8, 8) is not None      # now most recent
        cache.put("k4", pages[0], pages[1], 0, 8, 8)
        assert cache.get("k2", 0, 8, 8) is None
        assert cache.get("k1", 0, 9, 8) is None          # other window
        assert obs.metrics.value("serve.prefix_evictions_total") == 2
        cache.clear()
        assert len(cache) == 0
        assert obs.metrics.value("serve.prefix_cache_bytes") == 0

    def test_mixed_long_short_pool(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        sizes = (40, 3, 25, 2, 33)
        try:
            srv.warm_start()
            inv = srv.graph_inventory()
            got = [f.result(240)
                   for f in [srv.submit(p, 5) for p in prompts(sizes)]]
            assert srv.graph_inventory() == inv
        finally:
            srv.stop()
        kl, pl = kv_ladder(64, 4), prefill_ladder(64)
        assert len(inv) == 3 * len(kl) + 2 * len(pl) + 1
        for p, g in zip(prompts(sizes), got):
            np.testing.assert_array_equal(g, greedy(lm, p, 5))

    def test_ladder_decision_persists_and_restart_adopts(self, monkeypatch,
                                                         tmp_path):
        monkeypatch.setenv("DL4J_TORCH_TUNE_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("DL4J_TORCH_SERVE_KV_LADDER", raising=False)
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4, kv_ladder=(16, 64))
        srv.generate(prompts((4,))[0], 4, timeout=120)
        srv.stop()
        assert os.listdir(tmp_path) == []     # unarmed: nothing written
        monkeypatch.setenv("DL4J_TORCH_SERVE_AUTOTUNE", "1")
        srv = server(lm, slots=2, chunk=4, kv_ladder=(16, 64))
        srv.generate(prompts((4,))[0], 4, timeout=120)
        srv.stop()
        assert len(os.listdir(tmp_path)) == 1
        autotuner._reset_for_tests()
        srv2 = server(small_lm(), slots=2, chunk=4)
        srv2.generate(prompts((4,))[0], 4, timeout=120)
        srv2.stop()
        assert srv2._kv_ladder == (16, 64)

    def test_prefill_and_ttft_metrics_recorded(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        try:
            srv.generate(prompts((33,))[0], 4, timeout=240)
        finally:
            srv.stop()
        h = obs.metrics_snapshot()["histograms"]
        assert h["serve.prefill_seconds"]["count"] >= 1
        assert h["serve.ttft_seconds"]["count"] >= 1
        assert obs.metrics.value("serve.prefill_windows_total") >= 1
        assert obs.metrics.value("serve.kv_window") in (32, 64)

    def test_stop_mid_prefill_fails_typed(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4, kv_ladder=(64,),
                     prefill_ladder=(8,))
        p = prompts((60,))[0]
        f = srv.submit(p, 4)
        srv.stop()
        exc = f.exception(timeout=5)
        if exc is None:
            assert f.result().shape == (64,)
        else:
            assert isinstance(exc, ServeStoppedError), exc
        with pytest.raises(ServeStoppedError):
            srv.submit(p, 4)


class TestPerRequestSampling:
    def test_top_k1_parity_with_greedy_generate(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        ps = prompts((5, 3, 7, 2))
        try:
            got = [f.result(120) for f in [
                srv.submit(p, 6, temperature=1.0, top_k=1, seed=11 + i)
                for i, p in enumerate(ps)]]
        finally:
            srv.stop()
        for p, g in zip(ps, got):
            np.testing.assert_array_equal(g, greedy(lm, p, 6))

    def test_tiny_top_p_parity_with_greedy(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        p = prompts((5,))[0]
        try:
            out = srv.generate(p, 6, temperature=1.0, top_p=1e-9, seed=3,
                               timeout=120)
        finally:
            srv.stop()
        np.testing.assert_array_equal(out, greedy(lm, p, 6))

    def test_sampled_rows_invariant_to_interleaving(self):
        """A sampled request alone and inside a mixed pool (other slots,
        other admission times, the filter variant): the same tokens; its
        noise is a function of (base seed, its seed, its position)."""
        lm = small_lm()
        p = prompts((6,))[0]
        kw = dict(temperature=1.0, seed=7)
        srv = server(lm, slots=3, chunk=4)
        try:
            alone = srv.generate(p, 12, timeout=120, **kw)
            futs = [srv.submit(q, 10, temperature=0.8, top_k=3, seed=9)
                    for q in prompts((9, 4))]
            mixed = srv.submit(p, 12, **kw)
            futs.append(srv.submit(prompts((20,))[0], 3))
            for f in futs:
                f.result(120)
            mixed = mixed.result(120)
            other = srv.generate(p, 12, timeout=120, temperature=1.0,
                                 seed=8)
        finally:
            srv.stop()
        np.testing.assert_array_equal(alone, mixed)
        assert not np.array_equal(alone, other)
        # another pool width and chunk: the same tokens
        srv = server(lm, slots=2, chunk=2)
        try:
            np.testing.assert_array_equal(
                srv.generate(p, 12, timeout=120, **kw), alone)
        finally:
            srv.stop()

    def test_sampler_variant_follows_the_admitted_requests(self):
        lm = small_lm()
        srv = server(lm, slots=3, chunk=4)
        req = port_decode._GenRequest
        g = req(np.ones(3, np.int32), 4, 0.0, V, 1.0, 0)
        s = req(np.ones(3, np.int32), 4, 0.9, V, 1.0, 0)
        f = req(np.ones(3, np.int32), 4, 0.9, 5, 1.0, 0)
        srv._slot_req = {0: [g, 0, 6]}
        assert srv._select_mode() == "greedy"
        srv._slot_req[1] = [s, 0, 6]
        assert srv._select_mode() == "sample"
        srv._prefilling = {2: [f, [], 0, 0.0]}     # mid-prefill filters
        assert srv._select_mode() == "filter"
        srv._slot_req.pop(1)
        assert srv._select_mode() == "greedy"      # no active row samples

    def test_sampler_validation(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=2)
        try:
            for kw in (dict(top_k=0), dict(top_k=V + 1), dict(top_p=0.0),
                       dict(top_p=1.5)):
                with pytest.raises(ValueError):
                    srv.submit(prompts((4,))[0], 4, **kw)
        finally:
            srv.stop()


class TestStreamingAndDeadlines:
    def test_on_tokens_streams_every_sampled_token_once(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=3)
        spans = []
        p = prompts((5,))[0]
        try:
            out = srv.submit(p, 10, on_tokens=spans.append).result(120)
        finally:
            srv.stop()
        assert len(spans) >= 3
        np.testing.assert_array_equal(np.concatenate(spans), out[5:])

    def test_raising_stream_consumer_is_a_disconnect(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=2)

        def boom(_):
            raise RuntimeError("client went away")
        try:
            f = srv.submit(prompts((4,))[0], 8, on_tokens=boom)
            assert srv.generate(prompts((3,))[0], 4, timeout=120).shape \
                == (7,)
            deadline = time.monotonic() + 10
            while not f.done() and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            srv.stop()
        assert f.cancelled()

    def test_deadline_swept_before_admission(self):
        lm = small_lm()
        srv = server(lm, slots=1, chunk=2)
        try:
            busy = srv.submit(prompts((4,))[0], 30)
            late = srv.submit(prompts((3,))[0], 4, deadline_s=0.001)
            with pytest.raises(ServeDeadlineError, match="no device work"):
                late.result(120)
            assert busy.result(120).shape == (34,)
            with faults.inject("expire-deadline@0"):
                f = srv.submit(prompts((3,))[0], 4)
                with pytest.raises(ServeDeadlineError):
                    f.result(120)
        finally:
            srv.stop()
        assert obs.metrics.value("serve.deadline_expired_total") == 2


class TestTeardown:
    def test_stop_releases_the_pool_graphs_and_pages(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        try:
            srv.generate(prompts((33,))[0], 4, timeout=120)
            assert len(srv._prefix) > 0 and srv._pool.graphs
        finally:
            srv.stop()
        assert srv._pool is None and len(srv._prefix) == 0
        assert obs.metrics.value("serve.prefix_cache_bytes") == 0
        assert obs.metrics.value("serve.active_slots") == 0
        assert srv._thread is None or not srv._thread.is_alive()

    def test_double_stop_is_idempotent(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=4)
        srv.generate(prompts((4,))[0], 4, timeout=120)
        srv.stop()
        srv.stop()


class TestSlotsAutotune:
    def test_explicit_knob_always_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("DL4J_TORCH_SERVE_AUTOTUNE", "1")
        monkeypatch.setenv("DL4J_TORCH_SERVE_SLOTS", "3")
        monkeypatch.setenv("DL4J_TORCH_TUNE_CACHE_DIR", str(tmp_path))
        srv = server(small_lm(), chunk=4)
        srv.generate(prompts((4,))[0], 4, timeout=120)
        srv.stop()
        assert obs.metrics.value("serve.autotune_probes_total") == 0
        assert obs.metrics.value("serve.slots") == 3

    def test_probe_persists_and_restart_skips(self, monkeypatch, tmp_path):
        monkeypatch.setenv("DL4J_TORCH_SERVE_AUTOTUNE", "1")
        monkeypatch.setenv("DL4J_TORCH_SERVE_SLOTS_LADDER", "1,2")
        monkeypatch.setenv("DL4J_TORCH_TUNE_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("DL4J_TORCH_SERVE_SLOTS", raising=False)
        lm = small_lm()
        srv = server(lm, chunk=2)
        for f in [srv.submit(p, 4) for p in prompts((4, 3, 5))]:
            f.result(120)
        srv.stop()
        assert obs.metrics.value("serve.autotune_probes_total") == 2
        winner = obs.metrics.value("serve.slots")
        assert winner in (1, 2)
        # the losers' programs left the cache: the winner's probe program
        # and what the served requests built remain
        assert sorted(lm._jit_decode) == [
            ("admit", winner), ("decode", winner, 2, 32, "greedy"),
            ("decode", winner, 2, 64, "greedy")]
        assert len(os.listdir(tmp_path)) == 1     # committed atomically
        autotuner._reset_for_tests()
        obs.reset_metrics()
        srv2 = server(small_lm(), chunk=2)
        srv2.generate(prompts((4,))[0], 4, timeout=120)
        srv2.stop()
        assert obs.metrics.value("serve.autotune_probes_total") == 0
        assert obs.metrics.value("serve.slots") == winner

    def test_decision_is_keyed_by_the_device(self):
        assert autotuner.backend_key("cpu") == "cpu"

    def test_warm_start_refused_on_a_live_scheduler(self):
        lm = small_lm()
        srv = server(lm, slots=2, chunk=2)
        try:
            f = srv.submit(prompts((4,))[0], 30)
            with pytest.raises(RuntimeError, match="before serving starts"):
                srv.warm_start()
            assert f.result(120).shape == (34,)
        finally:
            srv.stop()

    def test_model_key_ignores_value_only_config_fields(self):
        a, b = small_lm(seed=1), small_lm(seed=2)
        b.conf.learning_rate = 9.9
        c = TransformerLM(TransformerConfig(
            vocab_size=V, max_len=64, d_model=32, n_heads=2, n_layers=2,
            d_ff=32, seed=1), device="cpu")
        assert autotuner.model_key(a) == autotuner.model_key(b)
        assert autotuner.model_key(a) != autotuner.model_key(c)

    def test_unarmed_uses_memory_derived_default_without_probe(
            self, monkeypatch, tmp_path, caplog):
        monkeypatch.delenv("DL4J_TORCH_SERVE_AUTOTUNE", raising=False)
        monkeypatch.delenv("DL4J_TORCH_SERVE_SLOTS", raising=False)
        monkeypatch.setenv("DL4J_TORCH_TUNE_CACHE_DIR", str(tmp_path))
        lm = small_lm()
        params_b = sum(p.numel() * 4 for p in lm.parameters())
        kv_slot = 2 * 2 * 2 * 64 * 8 * 4   # 2 L kv_heads max_len hd f32
        monkeypatch.setenv("DL4J_TORCH_MEM_BUDGET",
                           str(2 * (params_b + 3 * kv_slot)))
        with caplog.at_level(logging.INFO,
                             logger="deeplearning4j_tpu_torch.serving."
                                    "decode"):
            srv = server(lm, chunk=4)
            srv.generate(prompts((4,))[0], 4, timeout=120)
            srv.stop()
        assert obs.metrics.value("serve.autotune_probes_total") == 0
        assert obs.metrics.value("serve.slots") == 3
        assert any("derived from memory" in r.message
                   for r in caplog.records)


def test_greedy_equals_the_jax_continuous_lm():
    """One burst through the reference's ContinuousLM and the port's, on
    one carried parameter tree: the same rows."""
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig as JaxConfig, TransformerLM as JaxLM)
    from deeplearning4j_tpu.serving import ContinuousLM as JaxContinuousLM
    kw = dict(vocab_size=V, max_len=64, d_model=16, n_heads=2, n_layers=2,
              d_ff=32, pos_embed="rope", seed=3)
    jlm = JaxLM(JaxConfig(**kw)).init()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)
                                   + (np.asarray(a) == 1)).astype(np.float32),
                        jax.tree.map(np.asarray, jlm.params))
    jlm.params = jax.tree.map(jnp.asarray, tree)
    plm = TransformerLM(TransformerConfig(**kw), device="cpu")
    plm.params = params_from_numpy(tree, "cpu")
    ps = prompts((5, 3, 20, 2, 33, 4))
    jsrv = JaxContinuousLM(jlm, slots=2, chunk=4)
    psrv = server(plm, slots=2, chunk=4)
    try:
        want = [f.result(240) for f in [jsrv.submit(p, 6) for p in ps]]
        got = [f.result(240) for f in [psrv.submit(p, 6) for p in ps]]
    finally:
        jsrv.stop()
        psrv.stop()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len({tuple(g[-6:]) for g in got}) > 2
