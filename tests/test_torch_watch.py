"""The port's runtime watchers (``deeplearning4j_tpu_torch/testing``)
against the JAX package's and against the static inventories.

- lockwatch and leakwatch run the JAX package's own pure-Python fixtures
  (``tests/fixtures/lockwatch/inversion.py``,
  ``tests/fixtures/leakwatch/leaky.py``), the port's watcher first, then
  the reference's, never both installed at once: the same violation
  kinds at the same ``file:line``, and the same clean result on the
  clean paths;
- over a CPU ``InferenceServer`` round trip (a tiny TransformerLM), the
  port's watchers observe only sites the static analysis knows:
  leakwatch's sites are in ``resource_inventory_for_paths`` and
  lockwatch's edges in ``lock_graph_for_paths``, both over the port's
  ``serving/`` and ``models/_cuda_graph.py``;
- compilewatch records nothing on the CPU (nothing is captured or
  built); through a stand-in capture seam it attributes both kinds of
  capture, the fused loop's direct ``torch.cuda.graph`` in
  ``models/_layered.py`` and a StaticGraph's (named by the line that
  built it), and its ``steady()`` gate catches the torch fixture
  ``tests/fixtures/torch_watch/recapture.py`` at its line;
- rngwatch catches ``tests/fixtures/torch_watch/rng_reuse.py``'s double
  draw at its line, stays clean on the clean twin, on same-seed re-runs
  and on a dropout net's steps, catches one counter key drawn at two
  sites, and skips draws during a (stubbed) capture.

Every watcher is uninstalled and reset in a ``finally``: under
``--dist loadfile`` other test files run later in the same process.
"""

import contextlib
import importlib.util
import os
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import _cuda_graph
from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph
from deeplearning4j_tpu_torch.models._layered import _WindowGraph
from deeplearning4j_tpu_torch.testing import (compilewatch, leakwatch,
                                              lockwatch, rngwatch)

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
LOCK_FIXTURE = FIX / "lockwatch" / "inversion.py"
LEAK_FIXTURE = FIX / "leakwatch" / "leaky.py"
RECAPTURE = FIX / "torch_watch" / "recapture.py"
RNG_REUSE = FIX / "torch_watch" / "rng_reuse.py"
SCOPE = [REPO / "deeplearning4j_tpu_torch" / "serving",
         REPO / "deeplearning4j_tpu_torch" / "models" / "_cuda_graph.py"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(label):
    """A watcher's ``file:line`` label with the file relative to the
    repository."""
    path, line = label.rsplit(":", 1)
    return f"{os.path.relpath(os.path.abspath(path), REPO)}:{line}"


def _line_of(path, text):
    """The 1-based line of ``path`` that holds ``text`` (lines that look
    it up are left out)."""
    lines = Path(path).read_text().splitlines()
    hits = [i + 1 for i, line in enumerate(lines)
            if text in line and "_line_of(" not in line]
    assert len(hits) == 1, (path, text, hits)
    return hits[0]


@contextlib.contextmanager
def _watched(mod):
    """Install ``mod`` for the block; always uninstall and reset it."""
    mod.install()
    try:
        yield mod
    finally:
        mod.uninstall()
        mod.reset()


# ---------------------------------------------------------------------------
# lockwatch and leakwatch against the reference's watchers
# ---------------------------------------------------------------------------
def _lock_scenario(lw):
    """(violations after the consistent order, the inversions' lock
    pairs, the fixture edges) under ``lw``."""
    with _watched(lw):
        mod = _load(LOCK_FIXTURE, "lw_inversion_port")
        inv = mod.Inverted()
        inv.forward()
        inv.forward()
        clean = [tuple(map(_rel, v["locks"])) for v in lw.violations()]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inv.backward()
        pairs = [tuple(map(_rel, v["locks"])) for v in lw.violations()]
        stacks = [(v["stack"], v["prior_stack"]) for v in lw.violations()]
        edges = sorted(tuple(map(_rel, e)) for e in lw.edges()
                       if all(s.startswith(str(LOCK_FIXTURE)) for s in e))
    return clean, pairs, stacks, edges


def test_lockwatch_matches_the_reference_on_its_fixture():
    from deeplearning4j_tpu.testing import lockwatch as ref
    assert not ref.installed() and not lockwatch.installed()
    port = _lock_scenario(lockwatch)
    try:
        want = _lock_scenario(ref)
    finally:
        ref.reset()
    clean, pairs, stacks, edges = port
    assert clean == [] and want[0] == []
    a = _line_of(LOCK_FIXTURE, "self._alpha_lock = threading.Lock()")
    b = _line_of(LOCK_FIXTURE, "self._beta_lock = threading.Lock()")
    fixture = os.path.relpath(LOCK_FIXTURE, REPO)
    assert pairs == [(f"{fixture}:{b}", f"{fixture}:{a}")], pairs
    assert pairs == want[1] and edges == want[3] and len(edges) == 2
    (this, prior), = stacks
    assert "backward" in this and "forward" in prior


def _leak_scenario(lw, tmp):
    """(live after the clean paths, (kind, site) of each leak of the
    defect paths) under ``lw``."""
    mod = _load(LEAK_FIXTURE, "leaky_port")
    src = tmp / "src.txt"
    src.write_text("hello\n")
    with _watched(lw):
        snap = lw.snapshot()
        mod.copy_first_line(str(src), str(tmp / "dst.txt"))
        mod.open_socket().close()
        evt = threading.Event()
        t = mod.start_waiter(evt)
        evt.set()
        t.join(5)
        assert not t.is_alive()
        clean = [(r.kind, _rel(r.site)) for r in lw.live(since=snap)]
        snap = lw.snapshot()
        err = None
        try:
            mod.copy_first_line(str(tmp / "missing.txt"),
                                str(tmp / "dst2.txt"))
        except OSError as e:
            err = e
        sock = mod.open_socket()
        evt = threading.Event()
        t = mod.start_waiter(evt)
        try:
            leaks = sorted((r.kind, _rel(r.site))
                           for r in lw.live(since=snap))
            with pytest.raises(AssertionError, match="leaked resource"):
                lw.assert_clean(since=snap)
        finally:
            sock.close()
            evt.set()
            t.join(5)
            err.__traceback__.tb_next.tb_frame.f_locals["out"].close()
            del err
        lw.assert_clean(since=snap)
    return clean, leaks


def test_leakwatch_matches_the_reference_on_its_fixture(tmp_path):
    from deeplearning4j_tpu.testing import leakwatch as ref
    assert not ref.installed() and not leakwatch.installed()
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    clean, leaks = _leak_scenario(leakwatch, tmp_path / "port")
    try:
        want = _leak_scenario(ref, tmp_path / "ref")
    finally:
        ref.reset()
    fixture = os.path.relpath(LEAK_FIXTURE, REPO)
    assert clean == [] and want[0] == []
    assert leaks == [
        ("file", f"{fixture}:{_line_of(LEAK_FIXTURE, 'out = open(dst')}"),
        ("socket", f"{fixture}:{_line_of(LEAK_FIXTURE, 's = socket.')}"),
        ("thread", f"{fixture}:{_line_of(LEAK_FIXTURE, 't = threading.')}"),
    ], leaks
    assert leaks == want[1]


# ---------------------------------------------------------------------------
# the serving path against the static inventories
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def static_serving():
    """graftlint's lock graph and resource inventory over the port's
    serving modules and the CUDA-graph lock (computed once)."""
    from tools.graftlint.concurrency import lock_graph_for_paths
    from tools.graftlint.resources import resource_inventory_for_paths
    paths = [str(p) for p in SCOPE]
    idx = lock_graph_for_paths(paths)
    lock_sites = {_rel(f"{n.created_path}:{n.created_line}"): key
                  for key, n in idx.locks.items()}
    resources = {_rel(f"{p}:{line}") for p, line in
                 resource_inventory_for_paths(paths)}
    return lock_sites, set(idx.edges), resources


def _in_scope(label):
    rel = _rel(label)
    return any(rel.startswith(os.path.relpath(p, REPO)) for p in SCOPE)


def test_serving_round_trip_sites_are_in_the_static_inventories(
        static_serving):
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.serving import InferenceServer
    lock_sites, static_edges, resources = static_serving
    lm = TransformerLM(TransformerConfig(
        vocab_size=50, max_len=16, d_model=16, n_heads=2, n_layers=2,
        d_ff=32, seed=3), device="cpu").init()
    rows = np.random.RandomState(0).randint(0, 50, (6, 16)).astype(np.int32)
    with _watched(lockwatch), _watched(leakwatch):
        snap = leakwatch.snapshot()
        srv = InferenceServer(lm, buckets=(2, 4), device="cpu")
        try:
            outs = [srv.submit(r) for r in rows]
            served = [f.result(60) for f in outs]
        finally:
            srv.stop(timeout=10)
        leakwatch.assert_clean(since=snap)
        lockwatch.assert_clean()
        sites = [(_rel(s), kind) for s, kind in leakwatch.observed_sites()
                 if _in_scope(s)]
        edges = [(_rel(a), _rel(b)) for a, b in lockwatch.edges()]
    want = lm.output(rows)
    for got, w in zip(served, want):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=0)
    assert ("deeplearning4j_tpu_torch/serving/_base.py:"
            f"{_line_of(SCOPE[0] / '_base.py', 'self._thread = threading.')}",
            "thread") in sites, sites
    for site, kind in sites:
        assert site in resources, (site, kind, sorted(resources))
    in_scope = [e for e in edges if all(_in_scope(s) for s in e)]
    for a, b in in_scope:
        assert (lock_sites.get(a), lock_sites.get(b)) in static_edges, \
            (a, b)
    locks = {s for e in edges for s in e if _in_scope(s)}
    assert locks, edges      # the server's lock, held around its hand-off
    for label in locks:
        assert label in lock_sites, (label, sorted(lock_sites))


# ---------------------------------------------------------------------------
# compilewatch
# ---------------------------------------------------------------------------
def test_compilewatch_records_nothing_on_the_cpu():
    rec = _load(RECAPTURE, "recapture_cpu")
    lm_rows = np.arange(8, dtype=np.int32)[None]
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    lm = TransformerLM(TransformerConfig(
        vocab_size=16, max_len=16, d_model=8, n_heads=2, n_layers=1,
        d_ff=16, seed=1), device="cpu").init()
    with _watched(compilewatch):
        snap = compilewatch.snapshot()
        d = rec.Doubler("cpu", n=8)
        with compilewatch.steady():
            d.rebuild_each_call()
            d.rebuild_each_call()
            lm.generate(lm_rows, 2, temperature=0.0)
        assert compilewatch.events(since=snap) == []
        compilewatch.assert_clean(since=snap)
        assert torch.equal(d.y, torch.arange(8.0) * 2)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU."""

    def __init__(self, *a, **kw):
        self.replays = 0

    def capture_begin(self, *a, **kw):
        pass

    def capture_end(self):
        pass

    def register_generator_state(self, gen):
        pass

    def replay(self):
        self.replays += 1


# Stands in for ``torch.cuda.graph``: begins and ends a capture. Compiled
# under a file name outside the repository, as torch's own context
# manager lies outside it: the capture's innermost in-repo frame is then
# the ``with`` line that opened it, as on the card.
_STAND_IN = {}
exec(compile("""
class _FakeGraphContext:
    def __init__(self, graph, **kw):
        self.graph = graph

    def __enter__(self):
        self.graph.capture_begin()

    def __exit__(self, *exc):
        self.graph.capture_end()
""", "<torch.cuda.graph stand-in>", "exec"), _STAND_IN)
_FakeGraphContext = _STAND_IN["_FakeGraphContext"]


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_capture_seam(monkeypatch):
    """The CUDA capture seam stood in for on the CPU: StaticGraph takes
    its card route, and every capture reaches ``_FakeGraph``'s
    ``capture_begin`` (wrapped by compilewatch at install)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeGraphContext)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **kw: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **kw: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(_cuda_graph, "captures_graphs", lambda device: True)


def test_compilewatch_attributes_both_capture_seams(fake_capture_seam):
    rec = _load(RECAPTURE, "recapture_fake")
    layered = "deeplearning4j_tpu_torch/models/_layered.py:" + str(
        _line_of(REPO / "deeplearning4j_tpu_torch/models/_layered.py",
                 "with torch.cuda.graph(graph):"))
    rebuild = "tests/fixtures/torch_watch/recapture.py:" + str(
        _line_of(RECAPTURE, "StaticGraph(self._run, self.device)()"))
    reuse = "tests/fixtures/torch_watch/recapture.py:" + str(
        _line_of(RECAPTURE, "self.program = StaticGraph("))
    compilewatch.extend_watch_paths(RECAPTURE)
    try:
        with _watched(compilewatch):
            snap = compilewatch.snapshot()
            # the fused loop's window graph: torch.cuda.graph directly
            x = torch.zeros(2, 3)
            wg = _WindowGraph([x], [x], torch.zeros(2))
            steps = []
            wg.capture(steps.append)
            assert isinstance(wg.graph, _FakeGraph) and len(steps) > 1
            # StaticGraph programs: the clean twin captures once, then
            # replays inside steady()
            d = rec.Doubler("cpu", n=8)
            d.reuse()
            with compilewatch.steady():
                d.reuse()
                d.reuse()
            assert d.program.graph.replays == 2
            compilewatch.assert_clean(since=snap)
            assert compilewatch.counts_by_family(since=snap) == {
                layered: 1, reuse: 1}
            assert compilewatch.counts_by_site(since=snap) == {
                (layered.rsplit(":", 1)[0], int(layered.rsplit(":")[1])): 1,
                (reuse.rsplit(":", 1)[0], int(reuse.rsplit(":")[1])): 1}
            # the defect: a new program every call, inside steady()
            snap = compilewatch.snapshot()
            with compilewatch.steady():
                d.rebuild_each_call()
                d.rebuild_each_call()
            assert compilewatch.counts_by_family(since=snap) == {rebuild: 2}
            with pytest.raises(AssertionError,
                               match="steady-state capture") as err:
                compilewatch.assert_clean(since=snap)
            assert rebuild in str(err.value)
            assert [v["family"] for v in compilewatch.violations()] == \
                [rebuild, rebuild]
    finally:
        compilewatch._watch_paths.clear()
        compilewatch._inv_cache[0] = None
    assert torch.cuda.CUDAGraph.capture_begin is _FakeGraph.capture_begin


def test_compilewatch_event_on_a_foreign_thread_leaves_no_thread():
    """An event recorded on a thread Python did not start (autograd's
    backward threads on the card load the LSTM backward's library) must
    not make a ``_DummyThread`` that leakwatch then sees left alive."""
    import _thread
    done = threading.Event()

    def foreign():
        try:
            compilewatch._record("load", "load:lstm_cell_bwd")
        finally:
            done.set()
    with _watched(leakwatch), _watched(compilewatch):
        snap = leakwatch.snapshot()
        _thread.start_new_thread(foreign, ())
        assert done.wait(10)
        ev, = compilewatch.events()
        assert ev.thread.startswith("tid-") and ev.family == \
            "load:lstm_cell_bwd"
        leakwatch.assert_clean(since=snap)


def test_compilewatch_inventory_names_every_program_site():
    inv = compilewatch.inventory()
    captures = {v for v in inv.values() if v.startswith("capture: ")}
    assert captures == {
        "capture: torch.cuda.graph in _WindowGraph.capture",
        "capture: StaticGraph in _SlotPool.run",
        "capture: StaticGraph in TransformerLM._build_generate",
        "capture: StaticGraph in TransformerLM._build_beam",
        "capture: StaticGraph in Glove._fit_pairs",
        "capture: StaticGraph in SequenceVectors._launch"}, captures
    from deeplearning4j_tpu_torch.ops._build import KERNELS
    for name in KERNELS:
        assert f"build:{name}" in inv and f"load:{name}" in inv


def test_static_graph_site_is_the_line_that_built_it():
    """compilewatch records the line that built a StaticGraph while it
    is installed (it wraps ``__init__``), and nothing before or after."""
    before = StaticGraph(lambda: None, "cpu")
    init = vars(StaticGraph)["__init__"]
    with _watched(compilewatch):
        g = (None, StaticGraph(   # built here
            lambda: None, "cpu"))[1]
        assert before not in compilewatch._sites
    after = StaticGraph(lambda: None, "cpu")
    line = _line_of(__file__, "StaticGraph(   # built here")
    assert compilewatch._sites[g] == (__file__, line)
    assert after not in compilewatch._sites
    assert vars(StaticGraph)["__init__"] is init
    assert not hasattr(g, "site")


# ---------------------------------------------------------------------------
# rngwatch
# ---------------------------------------------------------------------------
def test_rngwatch_catches_the_fixture_at_its_line():
    mod = _load(RNG_REUSE, "rng_reuse_port")
    fixture = os.path.relpath(RNG_REUSE, REPO)
    with _watched(rngwatch):
        mod.draw_on()
        mod.two_models_one_seed()
        assert rngwatch.violations() == []
        mod.draw_twice(seed=1)
        mod.draw_twice(seed=1)   # seeded again: a fresh generation, again
        consumed = rngwatch.consumptions()
        bad = rngwatch.violations()
        rep = rngwatch.report()
    assert consumed == 8 and len(bad) == 2, rep
    defect = _line_of(RNG_REUSE, "# the same state")
    seeded = _line_of(RNG_REUSE, "def draw_twice") + 1
    for v in bad:
        assert v["created"] == (str(RNG_REUSE), seeded)
        assert v["first"][1] == (str(RNG_REUSE), defect - 2)
        assert v["second"][1] == (str(RNG_REUSE), defect)
    assert f"{fixture}:{defect}" in rep and f"{fixture}:{seeded}" in rep


@pytest.mark.parametrize("remat", [False, True])
def test_rngwatch_is_clean_on_same_seed_models_and_dropout_steps(remat):
    """Two nets from one seed (each seeding a fresh generation) and two
    dropout steps each; under remat the recomputation draws each mask
    again at the same site, on purpose."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn import layers as players
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
            .updater("sgd").list()
            .layer(players.DenseLayer(n_in=6, n_out=8, activation="tanh",
                                      dropout=0.5))
            .layer(players.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .build())
    conf.remat = remat
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    with _watched(rngwatch):
        a = MultiLayerNetwork(conf, device="cpu").init()
        b = MultiLayerNetwork(conf, device="cpu").init()
        for net in (a, b):
            for _ in range(2):
                net.fit(DataSet(x, y))
        keys = {fp: n for fp, (_site, n) in rngwatch.generations().items()
                if fp[0] == "counter"}
        rngwatch.assert_clean()
    # (seed, counter, stream): two steps, two layers; only the dense
    # layer draws, once a step (twice under remat); the second net's
    # keys are fresh generations of the same values
    assert sorted(keys) == [("counter", 5, c, s) for c in (0, 1)
                            for s in (0, 1)], keys
    assert [keys[("counter", 5, c, 0)] for c in (0, 1)] == \
        [2 if remat else 1] * 2, keys
    for pa, pb in zip(a.params_list, b.params_list):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


def test_rngwatch_catches_a_counter_key_drawn_at_two_sites():
    from deeplearning4j_tpu_torch.ops import random as random_mod
    with _watched(rngwatch):
        key = random_mod.DropoutKey(7, torch.tensor(3), 1)
        for _ in range(2):   # one site, twice: a recomputation
            random_mod.dropout_keep(key, (4, 4), 0.5, "cpu")
        assert rngwatch.violations() == []
        random_mod.uniform_bits(key, 16, "cpu")            # another site
        bad = rngwatch.violations()
    assert len(bad) == 1 and bad[0]["created_by"] == "DropoutKey"
    assert bad[0]["second"][1] == (
        __file__, _line_of(__file__, "random_mod.uniform_bits(key, 16,"))


def test_rngwatch_skips_draws_during_a_capture(monkeypatch):
    mod = _load(RNG_REUSE, "rng_reuse_capture")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with _watched(rngwatch):
        mod.draw_twice()
        assert rngwatch.violations() == []
        assert rngwatch.consumptions() == 0
        assert rngwatch.skipped() == 3     # the seeding and both draws
    assert torch.Generator is torch._C.Generator
    assert "normal_" not in vars(torch.Tensor)
