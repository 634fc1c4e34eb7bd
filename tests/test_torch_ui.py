"""The port's training UI (``deeplearning4j_tpu_torch/ui``) against the
JAX package's: the TLV codec, the stats storages, StatsListener, the
convolutional activation listener and UIServer.

One JSON builds each net in both packages and the port takes the JAX
net's initial parameters (``params_from_numpy``); both fit the same numpy
batches, fused (``fit(iterator)``, K 4) and per batch.

Tolerances, with their reasons:
- codec bytes, storage records read across packages, ``_summary`` and
  ``activations_to_grid``/``encode_png_gray`` on identical arrays, the
  static report's model keys, learning rates and every server endpoint
  over the same records: exact (the same host code on the same values);
- StatsListener on carried parameters: the iteration exactly; the score
  1e-6 relative; mean, stdev, mean magnitude and histogram min/max 1e-5
  of the leaf's scale (its largest magnitude), and histogram counts with
  equal sums and at most 2 apart over a leaf (a value near a bin edge may
  cross it): the two frameworks train the same math in a different
  summation order;
- the convolutional listener's grids: 1 grey level (the same rounding
  from activations that differ by summation order).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.datasets.dataset import (
    DataSet as JDataSet, ListDataSetIterator as JListIterator,
    MultiDataSet as JMultiDataSet)
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.conf.preprocessors import (
    FeedForwardToRnnPreProcessor as JFfToRnn,
    RnnToFeedForwardPreProcessor as JRnnToFf)
from deeplearning4j_tpu.nn.layers import (
    LSTM as JLSTM, ConvolutionLayer as JConv, DenseLayer as JDense,
    OutputLayer as JOut, RnnOutputLayer as JRnnOut)
from deeplearning4j_tpu.ui import codec as jcodec
from deeplearning4j_tpu.ui import conv_listener as jconv
from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import storage as jstorage
from deeplearning4j_tpu_torch import nativelib, obs
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.models import computation_graph as pcg
from deeplearning4j_tpu_torch.models import multi_layer_network as pmln
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.ui import codec
from deeplearning4j_tpu_torch.ui import conv_listener as pconv
from deeplearning4j_tpu_torch.ui import stats as pstats
from deeplearning4j_tpu_torch.ui import storage as pstorage
from deeplearning4j_tpu_torch.ui.server import (RemoteUIStatsStorageRouter,
                                                UIServer)
from deeplearning4j_tpu_torch.utils.pngio import decode_png

TYPE_ID = pstats.TYPE_ID
REL = 1e-5
SCORE_REL = 1e-6
COUNT_SLACK = 2


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
_VALUES = {
    "none": None, "true": True, "false": False, "int": -(2 ** 40),
    "np_int": np.int64(7), "float": 2.5, "np_float": np.float32(0.1),
    "str": "päth ✓", "bytes": b"\x00\x01binary", "bytearray": bytearray(b"ab"),
    "scalar_array": np.array(3.5, np.float32),
    "matrix": np.arange(6, dtype=np.float32).reshape(2, 3),
    "f64_array": np.linspace(-1, 1, 8).reshape(2, 2, 2),
    "empty_array": np.zeros((0, 3), np.float32),
    "list": [1, 2.0, "x", None, [b"y"]], "tuple": (1, "t"),
    "dict": {"nested": {"deep": 42, "arr": np.ones(3, np.float32)}},
    "report": {"iteration": 3, "score": 0.25, "memory": {"host_rss_bytes":
               1e9}, "params": {"0_DenseLayer": {"W": {"mean": 0.1,
               "histogram": {"min": -1.0, "max": 1.0,
                             "counts": np.arange(20, dtype=np.float32)}}}}},
}


@pytest.mark.parametrize("name", sorted(_VALUES))
def test_codec_bytes_equal_reference(name):
    """The same value encodes to the same bytes in both packages; each
    decodes the other's; the native validator accepts them."""
    obj = {"v": _VALUES[name]}
    data = codec.encode(obj)
    assert data == jcodec.encode(obj)
    assert nativelib.tlv_validate(data) == 0
    back, jback = codec.decode(data), jcodec.decode(data)
    assert codec.encode(back) == jcodec.encode(jback) == data


@pytest.mark.parametrize("data", [
    b"XXXX\x01\x00\x00", b"DLTS\x02\x00\x00", b"DLTS\x01\x00\x63",
    b"DLTS\x01\x00\x04\x10\x00\x00\x00ab"], ids=[
    "magic", "version", "type", "truncated"])
def test_codec_rejects_as_reference(data):
    for mod in (codec, jcodec):
        with pytest.raises(ValueError):
            mod.decode(data)


def test_codec_rejects_tensors():
    """A tensor is not a host value: the codec refuses it by name rather
    than reading it (reports copy to the host first)."""
    with pytest.raises(TypeError, match="Tensor"):
        codec.encode({"w": torch.zeros(3)})


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------
def _records(mod):
    P = mod.Persistable
    return [("static", P("s1", TYPE_ID, "w0", 0, {"init": True})),
            ("update", P("s1", TYPE_ID, "w0", 10, {"score": 1.0})),
            ("update", P("s1", TYPE_ID, "w0", 20, {"score": 0.5})),
            ("update", P("s1", TYPE_ID, "w1", 15, {"score": 0.7})),
            ("update", P("s2", "Other", "w0", 5,
                         {"a": np.arange(4, dtype=np.float32)}))]


def _fill(st, mod):
    for kind, p in _records(mod):
        (st.put_static_info if kind == "static" else st.put_update)(p)


def _dump(st):
    """Every query of the StatsStorage API, as plain values."""
    out = {"sessions": st.list_session_ids()}
    for s in out["sessions"]:
        for t in st.list_type_ids(s):
            for w in st.list_worker_ids(s, t):
                info = st.get_static_info(s, t, w)
                ups = st.get_all_updates_after(s, t, w, -1)
                latest = st.get_latest_update(s, t, w)
                out[(s, t, w)] = (
                    None if info is None else info.encode(),
                    [p.encode() for p in ups],
                    [p.encode() for p in st.get_all_updates_after(s, t, w,
                                                                  10)],
                    None if latest is None else latest.encode())
    return out


def test_in_memory_storage_matches_reference():
    got = pstorage.InMemoryStatsStorage()
    want = jstorage.InMemoryStatsStorage()
    ev_got, ev_want = [], []
    got.register_stats_storage_listener(lambda k, p: ev_got.append(k))
    want.register_stats_storage_listener(lambda k, p: ev_want.append(k))
    _fill(got, pstorage)
    _fill(want, jstorage)
    assert _dump(got) == _dump(want)
    assert ev_got == ev_want == ["static"] + ["update"] * 4


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_log_reads_across_packages(tmp_path, writer):
    """A log written by either package (with a truncated tail) replays in
    the other to the same records; both write the same bytes."""
    mods = {"port": pstorage, "reference": jstorage}
    paths = {}
    for name, mod in mods.items():
        paths[name] = str(tmp_path / f"{name}.bin")
        st = mod.FileStatsStorage(paths[name])
        _fill(st, mod)
        st.close()
    with open(paths["port"], "rb") as a, open(paths["reference"], "rb") as b:
        assert a.read() == b.read()
    with open(paths[writer], "ab") as f:
        f.write(b"\x01\xff\xff\xff\x7fgarbage")
    reader = mods["reference" if writer == "port" else "port"]
    back = reader.FileStatsStorage(paths[writer])
    want = jstorage.InMemoryStatsStorage()
    _fill(want, jstorage)
    assert _dump(back) == _dump(want)
    back.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sqlite_reads_across_packages(tmp_path, writer):
    mods = {"port": pstorage, "reference": jstorage}
    path = str(tmp_path / "stats.db")
    st = mods[writer].SqliteStatsStorage(path)
    _fill(st, mods[writer])
    st.close()
    reader = mods["reference" if writer == "port" else "port"]
    back = reader.SqliteStatsStorage(path)
    want = jstorage.InMemoryStatsStorage()
    _fill(want, jstorage)
    assert _dump(back) == _dump(want)
    back.put_static_info(reader.Persistable("s1", TYPE_ID, "w0", 1,
                                            {"init": False}))
    assert back.get_static_info("s1", TYPE_ID, "w0").content["init"] is False
    back.close()


def test_collection_router():
    r = pstorage.CollectionStatsStorageRouter()
    _fill(r, pstorage)
    assert len(r.static_info) == 1 and len(r.updates) == 4


# ---------------------------------------------------------------------------
# StatsListener
# ---------------------------------------------------------------------------
def _dense_lstm_conf():
    return (JBuilder.Builder().seed(3).learning_rate(0.05).updater("adam")
            .list()
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JLSTM(n_out=6))
            .layer(JRnnOut(n_out=3, activation="softmax", loss="mcxent"))
            .input_preprocessor(0, JRnnToFf())
            .input_preprocessor(1, JFfToRnn(timeseries_length=7))
            .set_input_type(JInputType.recurrent(4, timeseries_length=7))
            .build())


def _mln_pair(jconf):
    jnet = JNet(jconf).init()
    pnet = pmln.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = pmln.params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    pnet.reset_updater_state()
    return jnet, pnet


def _seq_batches(n=3, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(5, 7, 4).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.randint(0, 3, (5, 7))])
            for _ in range(n)]


def _assert_summary_close(got, want, what):
    assert set(got) == set(want), what
    hist = want.get("histogram")
    scale = max(abs(hist["min"]), abs(hist["max"])) if hist else \
        max(abs(want.get("mean", 0.0)), want.get("meanmag", 0.0))
    scale = max(scale, 1e-30)
    for k in ("mean", "stdev", "meanmag"):
        if k in want:
            assert abs(got[k] - want[k]) <= REL * scale, (what, k)
    if hist:
        g = got["histogram"]
        assert abs(g["min"] - hist["min"]) <= REL * scale, what
        assert abs(g["max"] - hist["max"]) <= REL * scale, what
        gc, wc = np.asarray(g["counts"]), np.asarray(hist["counts"])
        assert gc.dtype == wc.dtype == np.float32
        assert gc.sum() == wc.sum(), what
        assert np.abs(gc - wc).sum() <= COUNT_SLACK, (what, gc, wc)


def _assert_reports_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = g.content, w.content
        assert g["iteration"] == w["iteration"]
        assert abs(g["score"] - w["score"]) <= SCORE_REL * abs(w["score"])
        assert g["learning_rates"] == w["learning_rates"]
        assert set(g) == set(w)
        assert set(g["memory"]) == set(w["memory"]) >= {
            "host_rss_bytes", "host_total_bytes"}
        for group in ("params", "gradients"):
            assert set(g[group]) == set(w[group])
            for layer in w[group]:
                assert set(g[group][layer]) == set(w[group][layer])
                for k in w[group][layer]:
                    _assert_summary_close(g[group][layer][k],
                                          w[group][layer][k],
                                          f"{group}.{layer}.{k}")


def _assert_static_matches(got, want):
    g, w = got.content, want.content
    assert set(g) == set(w) == {"hardware", "software", "model"}
    assert g["model"] == w["model"]
    assert set(g["hardware"]) == set(w["hardware"])
    assert g["hardware"]["devices"] == ["cpu:cpu"]
    assert set(g["software"]) == set(w["software"]) - {"jax"} | {
        "torch", "cuda"}
    assert g["software"]["torch"] == torch.__version__


@pytest.mark.parametrize("k", [4, 1], ids=["fused", "per_batch"])
def test_stats_listener_matches_reference(monkeypatch, k):
    """Dense + LSTM from one JSON, three batches through ``fit(iterator)``
    (one fused group of 3 and a padding step, or the per-batch loop):
    every report of the port's listener against the reference's."""
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", str(k))
    jnet, pnet = _mln_pair(_dense_lstm_conf())
    js, ps = jstorage.InMemoryStatsStorage(), pstorage.InMemoryStatsStorage()
    jnet.set_listeners([jstats.StatsListener(js, session_id="s")])
    pnet.set_listeners([pstats.StatsListener(ps, session_id="s")])
    batches = _seq_batches()
    jnet.fit(JListIterator([JDataSet(x, y) for x, y in batches]))
    pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    if k > 1:
        assert pnet._last_fuse_stats["fused_groups"] == 1
    _assert_static_matches(ps.get_static_info("s", TYPE_ID, "single"),
                           js.get_static_info("s", TYPE_ID, "single"))
    got = ps.get_all_updates_after("s", TYPE_ID, "single", -1)
    want = js.get_all_updates_after("s", TYPE_ID, "single", -1)
    assert [p.content["iteration"] for p in got] == [1, 2, 3]
    _assert_reports_close(got, want)
    # the last report is the model's own tensors and last gradients
    cfg = pstats.StatsUpdateConfiguration()
    last = got[-1].content
    for group, tree in (("params", pstats._named_params(pnet)),
                        ("gradients", pstats._named_grads(pnet))):
        for name, d in tree:
            for key, v in d.items():
                assert codec.encode(last[group][name][key]) == codec.encode(
                    pstats._summary(v.detach().numpy(), cfg))


def test_graph_stats_match_reference():
    """A ComputationGraph's reports (layer names from the graph, last
    gradients a list in the port, a dict in the reference)."""
    jconf = (JBuilder.Builder().seed(2).learning_rate(0.1).graph_builder()
             .add_inputs("in")
             .add_layer("d1", JDense(n_in=4, n_out=8), "in")
             .add_layer("out", JOut(n_in=8, n_out=2, activation="softmax",
                                    loss="mcxent"), "d1")
             .set_outputs("out").build())
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    pnet = pcg.ComputationGraph(pconf, device="cpu").init()
    jnet = JGraph(jconf).init()
    pnet.params_map = pcg.params_from_numpy(pconf, _np_tree(jnet.params_map),
                                            "cpu")
    js, ps = jstorage.InMemoryStatsStorage(), pstorage.InMemoryStatsStorage()
    jnet.set_listeners([jstats.StatsListener(js, session_id="g")])
    pnet.set_listeners([pstats.StatsListener(ps, session_id="g")])
    r = np.random.RandomState(4)
    for _ in range(2):
        x = r.normal(size=(8, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[r.randint(0, 2, 8)]
        jnet.fit_batch(JMultiDataSet([x], [y]))
        pnet.fit_batch(MultiDataSet([x], [y]))
    _assert_static_matches(ps.get_static_info("g", TYPE_ID, "single"),
                           js.get_static_info("g", TYPE_ID, "single"))
    got = ps.get_all_updates_after("g", TYPE_ID, "single", -1)
    want = js.get_all_updates_after("g", TYPE_ID, "single", -1)
    assert set(got[0].content["gradients"]) == {"d1", "out"}
    _assert_reports_close(got, want)


@pytest.mark.parametrize("case", ["normal", "constant", "empty", "one",
                                  "flags_off"])
def test_summary_identical_to_reference(case):
    r = np.random.RandomState(1)
    arr = {"normal": r.normal(size=(13, 7)).astype(np.float32),
           "constant": np.full(9, 0.5, np.float32),
           "empty": np.zeros((0,), np.float32),
           "one": np.array([2.0], np.float32),
           "flags_off": r.uniform(size=40)}[case]
    kw = dict(collect_histograms=False, collect_stdev=False,
              num_histogram_bins=7) if case == "flags_off" else {}
    got = pstats._summary(arr, pstats.StatsUpdateConfiguration(**kw))
    want = jstats._summary(arr, jstats.StatsUpdateConfiguration(**kw))
    assert codec.encode(got) == jcodec.encode(want)


def test_host_trees_one_copy_mixed_dtypes():
    """A report's leaves come to the host in one copy, bf16, f32 and f64
    leaves alike, each equal to its own float64 value."""
    r = np.random.RandomState(2)
    params = [("a", {"W": torch.tensor(r.normal(size=(3, 4)),
                                       dtype=torch.bfloat16),
                     "b": torch.zeros(0)}),
              ("b", {"W": torch.tensor(r.normal(size=5),
                                       dtype=torch.float64)})]
    grads = [("a", {"W": torch.tensor(r.normal(size=(3, 4)),
                                      dtype=torch.float32)})]

    class Count(torch.overrides.TorchFunctionMode):
        copies = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.cpu, torch.Tensor.numpy):
                Count.copies += 1
            return func(*args, **(kwargs or {}))

    with Count():
        hp, hg = pstats._host_trees(params, grads)
    assert Count.copies == 2      # one .cpu() and one .numpy()
    for (_, h), (_, t) in zip(hp + hg, params + grads):
        for k in t:
            assert h[k].dtype == np.float64 and h[k].shape == tuple(t[k].shape)
            np.testing.assert_array_equal(h[k], t[k].double().numpy())


class _CardModel:
    device = torch.device("cuda", 0)


def test_memory_reads_the_card_without_fallback(monkeypatch):
    """A model on a card reports ``device0_*`` from torch's allocator; a
    reading that fails raises (no silent gap)."""
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda dev: {"allocated_bytes.all.current": 1234})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (10, 80 * 2 ** 30))
    out = pstats.StatsListener._memory_stats(_CardModel())
    assert out["device0_bytes_in_use"] == 1234.0
    assert out["device0_bytes_limit"] == float(80 * 2 ** 30)
    assert out["host_rss_bytes"] > 0 and out["host_total_bytes"] > 0

    def broken(dev):
        raise RuntimeError("card unreadable")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    with pytest.raises(RuntimeError, match="card unreadable"):
        pstats.StatsListener._memory_stats(_CardModel())


def test_reporting_frequency_matches_reference():
    jnet, pnet = _mln_pair(_dense_lstm_conf())
    cfg = dict(reporting_frequency=3, collect_histograms=False)
    jr, pr = jstorage.CollectionStatsStorageRouter(), \
        pstorage.CollectionStatsStorageRouter()
    jnet.set_listeners([jstats.StatsListener(
        jr, jstats.StatsUpdateConfiguration(**cfg))])
    pnet.set_listeners([pstats.StatsListener(
        pr, pstats.StatsUpdateConfiguration(**cfg))])
    for x, y in _seq_batches(7, seed=5):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    assert [p.content["iteration"] for p in pr.updates] == \
        [p.content["iteration"] for p in jr.updates] == [1, 4, 7]
    assert all("histogram" not in s for p in pr.updates
               for layer in p.content["params"].values()
               for s in layer.values())
    # the port's report decodes in the reference
    back = jstorage.Persistable.decode(pr.updates[-1].encode())
    assert back.content["iteration"] == 7
    assert codec.encode(back.content) == codec.encode(pr.updates[-1].content)


# ---------------------------------------------------------------------------
# convolutional listener
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,max_maps", [((6, 5, 3), 16), ((8, 8, 20), 16),
                                            ((4, 4, 7), 4), ((3, 3, 1), 16)])
def test_activation_grid_bytes_equal_reference(shape, max_maps):
    r = np.random.RandomState(sum(shape))
    a = r.normal(size=shape).astype(np.float32)
    a[..., 0] = 1.0                     # a constant map renders black
    got = pconv.activations_to_grid(a, max_maps)
    want = jconv.activations_to_grid(a, max_maps)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert pconv.encode_png_gray(got) == jconv.encode_png_gray(want)


def _conv_conf():
    return (JBuilder.Builder().seed(1).list()
            .layer(JConv(n_out=4, kernel_size=(3, 3)))
            .layer(JOut(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1))
            .build())


def test_feed_forward_layout_matches_reference():
    """The listener's premise: ``feed_forward`` gives host numpy, the input
    first, conv activations NHWC, as the reference's does."""
    jnet, pnet = _mln_pair(_conv_conf())
    x = np.random.RandomState(3).normal(size=(2, 8, 8, 1)).astype(np.float32)
    got, want = pnet.feed_forward(x), jnet.feed_forward(x)
    assert all(isinstance(a, np.ndarray) for a in got)
    assert [a.shape for a in got] == [np.asarray(a).shape for a in want]
    assert got[1].shape == (2, 6, 6, 4)
    np.testing.assert_array_equal(got[0], x)


def test_conv_listener_grid_matches_reference():
    jnet, pnet = _mln_pair(_conv_conf())
    r = np.random.RandomState(6)
    probe = r.normal(size=(8, 8, 1)).astype(np.float32)
    js, ps = jstorage.InMemoryStatsStorage(), pstorage.InMemoryStatsStorage()
    jnet.set_listeners([jconv.ConvolutionalIterationListener(
        js, probe, frequency=1, session_id="c")])
    pnet.set_listeners([pconv.ConvolutionalIterationListener(
        ps, probe, frequency=1, session_id="c")])
    for _ in range(2):
        x = r.normal(size=(4, 8, 8, 1)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[r.randint(0, 2, 4)]
        jnet.fit_batch(x, y)
        pnet.fit_batch(x, y)
    got = ps.get_all_updates_after("c", pconv.TYPE_ID, "worker_0", -1)
    want = js.get_all_updates_after("c", jconv.TYPE_ID, "worker_0", -1)
    assert [p.content["iteration"] for p in got] == \
        [p.content["iteration"] for p in want] == [1, 2]
    for g, w in zip(got, want):
        a = decode_png(g.content["png"]).astype(int)
        b = decode_png(w.content["png"]).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


# ---------------------------------------------------------------------------
# UIServer
# ---------------------------------------------------------------------------
def _reference_records():
    """Records from reference runs: a dense MLN's stats session, a graph's
    (for the flow module) and a conv listener's PNG."""
    st = jstorage.InMemoryStatsStorage()
    conf = (JBuilder.Builder().seed(7).learning_rate(0.1).list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    net = JNet(conf).init()
    net.set_listeners([jstats.StatsListener(st, session_id="ui_sess")])
    r = np.random.RandomState(12345)
    x = r.randn(32, 4).astype(np.float32)
    ds = JDataSet(x, np.eye(3, dtype=np.float32)[r.randint(0, 3, 32)])
    for _ in range(3):
        net.fit(ds)
    g = (JBuilder.Builder().graph_builder().add_inputs("in")
         .add_layer("d1", JDense(n_in=4, n_out=8), "in")
         .add_layer("out", JOut(n_in=8, n_out=2, activation="softmax",
                                loss="mcxent"), "d1")
         .set_outputs("out").build())
    gnet = JGraph(g).init()
    gnet.set_listeners([jstats.StatsListener(st, session_id="flow_g")])
    gnet.fit_batch(JMultiDataSet([x[:8]], [np.eye(2, dtype=np.float32)[
        r.randint(0, 2, 8)]]))
    cnet = JNet(_conv_conf()).init()
    cnet.set_listeners([jconv.ConvolutionalIterationListener(
        st, r.normal(size=(8, 8, 1)).astype(np.float32), frequency=1,
        session_id="conv_s")])
    cnet.fit_batch(r.normal(size=(4, 8, 8, 1)).astype(np.float32),
                   np.eye(2, dtype=np.float32)[r.randint(0, 2, 4)])
    out = []
    for s in st.list_session_ids():
        for t in st.list_type_ids(s):
            for w in st.list_worker_ids(s, t):
                info = st.get_static_info(s, t, w)
                if info is not None:
                    out.append(("static", info.encode()))
                out.extend(("update", p.encode()) for p in
                           st.get_all_updates_after(s, t, w, -1))
    return out


def _stored(mod, records):
    st = mod.InMemoryStatsStorage()
    for kind, data in records:
        p = mod.Persistable.decode(data)
        (st.put_static_info if kind == "static" else st.put_update)(p)
    return st


@pytest.fixture(scope="module")
def servers():
    records = _reference_records()
    port_srv = UIServer(port=0).start()
    ref_srv = jserver.UIServer(port=0).start()
    port_srv.attach(_stored(pstorage, records))
    ref_srv.attach(_stored(jstorage, records))
    for srv in (port_srv, ref_srv):
        for name in ("first", "second"):
            _post(srv, f"/train/tsne/upload?name={name}",
                  json.dumps([[1.0, 2.0, name], [0.5, -1.0, "z"]]).encode())
    yield port_srv, ref_srv
    port_srv.stop()
    ref_srv.stop()


def _get(srv, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _post(srv, path, data, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


_GETS = ["/", "/train", "/train/overview", "/train/sessions",
         "/train/overview/data?sessionId=ui_sess",
         "/train/overview/data?sessionId=nope",
         "/train/model/data?sessionId=ui_sess",
         "/train/model/data?sessionId=ui_sess&layer=1_OutputLayer",
         "/train/system/data?sessionId=ui_sess",
         "/train/histogram/data?sessionId=ui_sess",
         "/train/histogram/data?sessionId=flow_g&layer=out",
         "/train/flow/data?sessionId=ui_sess",
         "/train/flow/data?sessionId=flow_g",
         "/train/tsne/data", "/train/tsne/data?name=first",
         "/train/tsne/data?name=missing",
         "/train/activations", "/train/activations?sessionId=conv_s",
         "/train/activations?sessionId=ui_sess", "/no/such/page"]


@pytest.mark.parametrize("path", _GETS)
def test_get_endpoint_matches_reference(servers, path):
    """Status, content type and body equal the reference server's over the
    same records (the page differs in its title line only)."""
    port_srv, ref_srv = servers
    got, want = _get(port_srv, path), _get(ref_srv, path)
    assert got[:2] == want[:2]
    if want[1].startswith("text/html"):
        assert b"Training UI" in got[2]
        return
    if want[1] == "application/json":
        assert json.loads(got[2]) == json.loads(want[2])
    else:
        assert got[2] == want[2]


@pytest.mark.parametrize("path,data,headers", [
    ("/train/tsne/upload", b"{not json", {}),
    ("/train/tsne/upload?name=bad", b'[[NaN, 1.0, "a"]]', {}),
    ("/train/tsne/upload?name=bad", b'{"a": 1}', {}),
    ("/remoteReceive", b"DLTS\x01\x00\x63garbage", {}),
    ("/remoteReceive", b"XXXXgarbage", {}),
    ("/elsewhere", b"", {}),
], ids=["tsne_json", "tsne_nan", "tsne_shape", "tlv_type", "tlv_magic",
        "unknown"])
def test_post_errors_match_reference(servers, path, data, headers):
    port_srv, ref_srv = servers
    got, want = _post(port_srv, path, data, headers), \
        _post(ref_srv, path, data, headers)
    assert got[0] == want[0] >= 400


def test_remote_receive_without_storage_is_503():
    srvs = [UIServer(port=0).start(), jserver.UIServer(port=0).start()]
    try:
        body = pstorage.Persistable("s", TYPE_ID, "w", 1, {"a": 1}).encode()
        assert [_post(s, "/remoteReceive", body)[0] for s in srvs] == \
            [503, 503]
    finally:
        for s in srvs:
            s.stop()


def test_remote_router_into_port_server(tmp_path):
    """A port listener posts through RemoteUIStatsStorageRouter into a
    port UIServer; the server's storage ends with the records of a file
    storage fed by the same listener run."""
    srv = UIServer(port=0).start()
    remote = pstorage.InMemoryStatsStorage()
    srv.attach(remote)
    router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{srv.port}")
    fst = pstorage.FileStatsStorage(str(tmp_path / "stats.bin"))

    class Tee(pstorage.StatsStorageRouter):
        def put_static_info(self, p):
            fst.put_static_info(p)
            router.put_static_info(p)

        def put_update(self, p):
            fst.put_update(p)
            router.put_update(p)

    try:
        _, pnet = _mln_pair(_dense_lstm_conf())
        pnet.set_listeners([pstats.StatsListener(Tee(), session_id="rs")])
        for x, y in _seq_batches(2, seed=8):
            pnet.fit(DataSet(x, y))
        deadline = time.time() + 10
        while time.time() < deadline and len(remote.get_all_updates_after(
                "rs", TYPE_ID, "single", -1)) < 2:
            time.sleep(0.05)
    finally:
        router.close()
        srv.stop()
    assert _dump(remote) == _dump(fst) and router.dropped == 0
    fst.close()


def test_get_instance_is_a_singleton_and_serves_metrics():
    obs.counter("ui.test_requests_total", "a test counter").inc()
    srv = UIServer.get_instance(port=0)
    try:
        assert UIServer.get_instance(port=0) is srv
        status, ctype, body = _get(srv, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert b"dl4j_torch_ui_test_requests_total " in body
        status, _, body = _get(srv, "/train/metrics/data")
        assert status == 200
        assert json.loads(body)["counters"]["ui.test_requests_total"] >= 1
    finally:
        srv.stop()
    assert UIServer.get_instance(port=0) is not srv
    UIServer.get_instance(port=0).stop()
