"""The port stands alone: no JAX, no reference package, no silent CPU.

- no file of ``deeplearning4j_tpu_torch/`` (the prefetcher
  ``datasets/async_iterator.py`` and ``tuning/autotuner.py`` included),
  nor ``chip_smoke.py`` or the design-variant timers ``flash_variants.py``,
  ``lstm_variants.py``, ``conv_variants.py`` and ``serve_variants.py``,
  imports ``jax``, ``jaxlib`` or
  ``deeplearning4j_tpu`` (AST scan), and
  importing the whole package in a fresh interpreter loads no ``jax``;
- a CPU tensor never touches a kernel: no launch count moves and no
  kernel library is loaded, forward, backward or a training step; the
  ``scan`` parity routes (``DL4J_TORCH_LM_ATTN``, ``DL4J_TORCH_FLASH_BWD``)
  refuse a tensor that is not on the CPU; each kernel's boundary refuses
  what its kernel cannot take before any pointer is passed;
- with no CUDA present, the entry points without ``device="cpu"`` raise
  instead of running on the CPU (the model-archive restores, and
  ComputationGraph and its archive's restores, ContinuousLM and the
  decode-state carrier, the router over such replicas, Word2Vec and its
  lookup table included); generation, serving through the router and the
  ingress, and a Word2Vec fit on the CPU capture no CUDA graph and load
  no kernel.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy as mln_params_from_numpy,
    updater_state_from_numpy)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, decode_state_from_numpy,
    params_from_numpy)
from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops import flash_attention as port_fa
from deeplearning4j_tpu_torch.ops import lstm_cell as port_lc
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.ops.lstm_cell import lstm_cell, lstm_sequence
from deeplearning4j_tpu_torch.serving import ContinuousLM, InferenceServer

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deeplearning4j_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}
SMALL = dict(vocab_size=32, max_len=16, d_model=16, n_heads=2, n_layers=1,
             d_ff=32, block_size=8)


def _port_sources():
    scripts = [REPO / name for name in ("chip_smoke.py", "flash_variants.py",
                                        "lstm_variants.py",
                                        "conv_variants.py",
                                        "serve_variants.py")]
    files = sorted(PKG.rglob("*.py")) + scripts
    assert len(files) > 10 and all(p.exists() for p in scripts)
    # the fused loop's modules, and the LeNet path's and persistence's,
    # carried over from the reference's modules (its jax-free ones too),
    # are scanned like every other
    for mod in ("datasets/async_iterator.py", "tuning/autotuner.py",
                "models/multi_layer_network.py", "datasets/fetchers.py",
                "nn/layers/conv.py", "nn/layers/pooling.py",
                "nn/layers/norm.py", "nn/conf/preprocessors.py",
                "utils/atomic_io.py", "utils/model_serializer.py",
                "utils/training_checkpoint.py", "utils/flat_params.py",
                "models/_device_state.py", "models/_layered.py",
                "models/computation_graph.py", "nn/conf/graph.py",
                "nn/conf/computation_graph.py", "serving/decode.py",
                "models/_cuda_graph.py", "serving/router.py",
                "serving/ingress.py", "utils/http_base.py", "nlp/__init__.py",
                "nlp/vocab.py", "nlp/text.py", "nlp/lookup.py",
                "nlp/sequence_vectors.py", "nlp/word2vec.py"):
        assert PKG / mod in files, mod
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "__import__", "import_module"):
            roots.update(a.value.split(".")[0] for a in node.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str))
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_loads_no_jax():
    mods = sorted(
        "deeplearning4j_tpu_torch." + ".".join(
            p.relative_to(PKG).with_suffix("").parts).replace(
                ".__init__", "")
        for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'deeplearning4j_tpu'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _launches():
    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches)


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _launches()
    q = torch.randn(2, 4, 24, 8, requires_grad=True)
    torch.autograd.grad(flash_attention(q, q, q, causal=True).sum(), q)
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    lm.output(np.zeros((2, 16), np.int32))
    lm.fit_batch(np.ones((2, 17), np.int32))
    assert _launches() == before


@pytest.mark.parametrize("window", [None, 3])
def test_scan_route_refuses_device_tensors(monkeypatch, window):
    """``DL4J_TORCH_LM_ATTN=scan`` is a CPU parity route: a tensor on any
    other device (``meta`` stands in for the card here) raises before it
    reaches plain attention, with or without a window."""
    from deeplearning4j_tpu_torch.models import transformer as tr

    def no_plain(*args, **kw):
        raise AssertionError("plain attention reached by a device tensor")
    monkeypatch.setattr(tr, "blockwise_attention", no_plain)
    monkeypatch.setattr(tr, "dense_attention", no_plain)
    monkeypatch.setenv("DL4J_TORCH_LM_ATTN", "scan")
    c = TransformerConfig(**dict(SMALL, window=window))
    q = torch.zeros(1, 2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        tr._blockwise_route(c, q, q, q)


@pytest.mark.parametrize("window", [None, 3])
def test_flash_bwd_scan_route_refuses_device_tensors(monkeypatch, window):
    """``DL4J_TORCH_FLASH_BWD=scan`` is a CPU parity route too: a device
    tensor (``meta`` stands in for the card) raises before it reaches
    the plain recurrence or the plain backward."""
    def no_plain(*args, **kw):
        raise AssertionError("plain attention reached by a device tensor")
    for name in ("blockwise_attention", "dense_attention",
                 "flash_attention_bwd_plain"):
        monkeypatch.setattr(port_fa, name, no_plain)
    monkeypatch.setenv("DL4J_TORCH_FLASH_BWD", "scan")
    q = torch.zeros(4, 16, 8, device="meta")
    lse = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        port_fa._flash_backward(q, q, q, q, lse, q, causal=True,
                                window=window, kv_group=1, block_k=8)


@pytest.mark.parametrize("case", ["dtype", "mixed", "strided", "head_dim",
                                  "kv_heads", "kv_length"])
def test_kernel_boundary_refuses_what_the_kernel_cannot_take(monkeypatch,
                                                             case):
    """The checks in front of the kernel's pointers run before the kernel
    library is loaded, so they are held here on CPU tensors."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a refused call")
    monkeypatch.setattr(_build, "load", no_kernel)
    q = torch.zeros(4, 16, 8)
    k = v = torch.zeros(2, 16, 8)
    err = ValueError
    if case == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "mixed":
        k, err = k.double(), TypeError
    elif case == "strided":
        q = torch.zeros(4, 8, 16).transpose(1, 2)
    elif case == "head_dim":
        # one past the kernels' largest head dim (MAX_HEAD_DIM, 256)
        q, k, v = torch.zeros(4, 16, 257), torch.zeros(2, 16, 257), \
            torch.zeros(2, 16, 257)
    elif case == "kv_heads":
        k = v = torch.zeros(1, 16, 8)
    else:
        k = v = torch.zeros(2, 15, 8)
    before = _launches()
    with pytest.raises(err):
        port_fa._kernel_forward(q, k, v, causal=True, window=None,
                                kv_group=2)
    assert _launches() == before


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_lm_without_device_refuses_the_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(TransformerConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(TransformerConfig(**SMALL), device="cuda")


def test_server_without_device_refuses_the_cpu(no_cuda):
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(lm, buckets=(2,))
    srv = InferenceServer(lm, buckets=(2,), device="cpu")
    srv.stop()


def test_params_without_device_refuse_the_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"wte": np.zeros((4, 2), np.float32)})


def test_server_refuses_a_model_on_another_device():
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    with pytest.raises(ValueError, match="lives on"):
        InferenceServer(lm, device="meta")
    with pytest.raises(ValueError, match="lives on"):
        ContinuousLM(lm, device="meta")


def test_continuous_lm_without_device_refuses_the_cpu(no_cuda):
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousLM(lm, slots=2)
    srv = ContinuousLM(lm, slots=2, device="cpu")
    srv.stop()
    tree = {k: np.zeros(2, np.int64) for k in (
        "pos", "last", "plen", "nnew", "topk", "seed")}
    tree.update(k=[], v=[], out=np.zeros((2, 4), np.int64),
                prompts=np.zeros((2, 4), np.int64),
                temp=np.zeros(2, np.float32), topp=np.ones(2, np.float32),
                active=np.zeros(2, bool), rng=np.array([0, 5], np.uint32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_state_from_numpy(tree)
    assert int(decode_state_from_numpy(tree, "cpu")["rng"]) == 5


def test_cpu_generation_never_loads_a_kernel_or_captures(monkeypatch):
    """generate(), beam_search() and ContinuousLM on the CPU: no kernel
    library loaded, no launch counted, no CUDA graph captured (their
    programs run as direct calls)."""
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    lm = TransformerLM(TransformerConfig(**dict(SMALL, block_size=None)),
                       device="cpu").init()
    before, captures = _launches(), capture_count()
    prompt = np.array([[1, 2, 3]])
    lm.generate(prompt, 4, temperature=0.0)
    lm.generate(prompt, 4, temperature=1.0, top_k=3)
    lm.beam_search(prompt, 3, beams=2)
    srv = ContinuousLM(lm, slots=2, chunk=2, device="cpu")
    try:
        srv.warm_start()
        srv.generate(np.arange(1, 13), 3, timeout=60)
    finally:
        srv.stop()
    assert _launches() == before and capture_count() == captures


BWD_CASES = ["dtype", "mixed", "strided_do", "head_dim", "kv_heads",
             "do_shape", "lse_dtype", "lse_shape", "delta_strided"]


@pytest.mark.parametrize("entry", ["_kernel_dq", "_kernel_dkv"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_boundaries_refuse_what_the_kernels_cannot_take(
        monkeypatch, entry, case):
    """The dQ and dK/dV wrappers check every input before the kernel
    library is loaded, so they are held here on CPU tensors."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a refused call")
    monkeypatch.setattr(_build, "load", no_kernel)
    q, do = torch.zeros(4, 16, 8), torch.zeros(4, 16, 8)
    k = v = torch.zeros(2, 16, 8)
    lse, delta = torch.zeros(4, 16), torch.zeros(4, 16)
    err = ValueError
    if case == "dtype":
        q, k, v, do, err = q.half(), k.half(), v.half(), do.half(), TypeError
    elif case == "mixed":
        do, err = do.to(torch.bfloat16), TypeError
    elif case == "strided_do":
        do = torch.zeros(4, 8, 16).transpose(1, 2)
    elif case == "head_dim":
        q, do = torch.zeros(4, 16, 257), torch.zeros(4, 16, 257)
        k = v = torch.zeros(2, 16, 257)
    elif case == "kv_heads":
        k = v = torch.zeros(1, 16, 8)
    elif case == "do_shape":
        do = torch.zeros(4, 15, 8)
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "lse_shape":
        lse = torch.zeros(4, 15)
    else:
        delta = torch.zeros(16, 4).t()
    before = _launches()
    with pytest.raises(err):
        getattr(port_fa, entry)(q, k, v, do, lse, delta, causal=True,
                                window=None, kv_group=2)
    assert _launches() == before


def test_build_directory_is_git_ignored():
    rules = (REPO / ".gitignore").read_text().split()
    assert str(_build.BUILD_DIR.relative_to(REPO)) + "/" in rules
    assert _build.SRC_DIR == PKG / "csrc"
    assert sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")) == \
        sorted(_build.KERNELS)


def _lstm_launches():
    return lstm_sequence.launches, lstm_cell.bwd_launches


def test_cpu_char_rnn_never_touches_the_lstm_kernels(monkeypatch):
    """Training (per batch and through the fused loop), inference and
    stepping a char-RNN on the CPU move no LSTM launch count and load no
    kernel library."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _lstm_launches()
    net = MultiLayerNetwork(zoo.char_rnn(vocab_size=8, hidden=6,
                                         tbptt_length=4),
                            device="cpu").init()
    x = np.eye(8, dtype=np.float32)[np.random.RandomState(0).randint(
        0, 8, (2, 9))]
    net.fit_batch(x, x)
    net.fit(ListDataSetIterator([DataSet(x, x)] * 2))
    assert net._last_fuse_stats["fused_groups"] == 1
    net.output(x)
    net.rnn_time_step(x[:, 0])
    assert _lstm_launches() == before


def test_builtin_lstm_route_refuses_device_tensors(monkeypatch):
    """``DL4J_TORCH_LSTM_KERNEL=builtin`` is a CPU parity route: a tensor
    on any other device (``meta`` stands in for the card) raises before
    the plain recurrence runs."""
    monkeypatch.setenv("DL4J_TORCH_LSTM_KERNEL", "builtin")
    layer = GravesLSTM(n_in=5, n_out=6, activation="tanh")

    def no_plain(*a, **kw):
        raise AssertionError("the plain recurrence ran for a device tensor")
    monkeypatch.setattr(GravesLSTM, "_scan_builtin", no_plain)
    params = {k: torch.zeros(s, device="meta")
              for k, s in layer.param_shapes().items()}
    z = torch.zeros(3, 6, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        layer._scan(params, torch.zeros(3, 7, 5, device="meta"), z, z, None)


def test_mln_without_device_refuses_the_cpu(no_cuda):
    conf = zoo.char_rnn(vocab_size=8, hidden=6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mln_params_from_numpy(conf.layers, [{} for _ in conf.layers])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        updater_state_from_numpy([{}])


LSTM_CASES = ["dtype", "mixed", "zx_strided", "zx_width", "rw_shape",
              "peep_shape", "c_shape", "devices", "grad_shape",
              "grad_strided"]


@pytest.mark.parametrize("entry", ["_kernel_forward", "_kernel_backward"])
@pytest.mark.parametrize("case", LSTM_CASES)
def test_lstm_boundaries_refuse_what_the_kernels_cannot_take(monkeypatch,
                                                             entry, case):
    """The LSTM wrappers check every input before the kernel library is
    loaded, so they are held here on CPU tensors."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a refused call")
    monkeypatch.setattr(_build, "load", no_kernel)
    b, h = 4, 6
    zx, rw = torch.zeros(b, 4 * h), torch.zeros(h, 4 * h)
    hp, cp, p = torch.zeros(b, h), torch.zeros(b, h), torch.zeros(3, h)
    dh, dc = torch.zeros(b, h), torch.zeros(b, h)
    err = ValueError
    if case == "dtype":
        zx, hp, cp, rw, p, dh, dc = (t.half() for t in
                                     (zx, hp, cp, rw, p, dh, dc))
        err = TypeError
    elif case == "mixed":
        rw, err = rw.double(), TypeError
    elif case == "zx_strided":
        zx = torch.zeros(4 * h, b).t()
    elif case == "zx_width":
        zx = torch.zeros(b, 4 * h + 1)
    elif case == "rw_shape":
        rw = torch.zeros(4 * h, h)
    elif case == "peep_shape":
        p = torch.zeros(4, h)
    elif case == "c_shape":
        cp = torch.zeros(b, h + 1)
    elif case == "devices":
        rw = torch.zeros(h, 4 * h, device="meta")
    elif case == "grad_shape":
        dh = torch.zeros(b + 1, h)
    else:
        dc = torch.zeros(h, b).t()
    args = (zx, hp, cp, rw, p)
    if entry == "_kernel_backward":
        args += (dh, dc)
    elif case.startswith("grad"):
        args = (zx, hp, cp, rw, torch.zeros(3, h + 1))   # still refused
    before = _lstm_launches()
    with pytest.raises(err):
        getattr(port_lc, entry)(*args)
    assert _lstm_launches() == before


def test_restore_without_device_refuses_the_cpu(no_cuda, tmp_path):
    from deeplearning4j_tpu_torch.utils import (model_serializer,
                                                training_checkpoint)
    net = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    path = str(tmp_path / "lenet.zip")
    model_serializer.write_model(net, path)
    for restore in (model_serializer.restore_multi_layer_network,
                    model_serializer.restore_model):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            restore(path)
        assert restore(path, device="cpu").device.type == "cpu"
    # a resume restores onto the network's own device
    training_checkpoint.save_training_checkpoint(net, str(tmp_path / "ck"))
    again = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    assert training_checkpoint.resume_latest(again,
                                             str(tmp_path / "ck")) == {}
    assert again.params_list[0]["W"].device.type == "cpu"


def test_graph_without_device_refuses_the_cpu(no_cuda, tmp_path):
    """ComputationGraph, its parameter carriers, and the graph archive's
    restores (``restore_computation_graph`` and ``restore_model``) raise
    without CUDA unless they get ``device="cpu"``."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph, params_from_numpy as cg_params_from_numpy,
        updater_state_from_numpy as cg_updater_state_from_numpy)
    from deeplearning4j_tpu_torch.utils import model_serializer
    conf = zoo.resnet50(n_classes=3, height=16, width=16, stages=(1,))
    for make in (lambda: ComputationGraph(conf),
                 lambda: ComputationGraph(conf, device="cuda"),
                 lambda: cg_params_from_numpy(conf, {
                     n: {} for n in conf.layer_names()}),
                 lambda: cg_updater_state_from_numpy(conf, {
                     n: {} for n in conf.layer_names()})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    net = ComputationGraph(conf, device="cpu").init()
    path = str(tmp_path / "graph.zip")
    model_serializer.write_model(net, path)
    for restore in (model_serializer.restore_computation_graph,
                    model_serializer.restore_model):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            restore(path)
        again = restore(path, device="cpu")
        assert isinstance(again, ComputationGraph)
        assert again.device.type == "cpu"


def test_cpu_graphs_never_load_a_kernel(monkeypatch):
    """A CPU graph (ResNet through fit(), a recurrent graph through tBPTT
    and rnn_time_step) runs no kernel of the package: its LSTM vertices
    take the kernels' plain twins."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator, MultiDataSet)
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _launches() + _lstm_launches()
    r = np.random.RandomState(0)
    net = ComputationGraph(zoo.resnet50(n_classes=3, height=16, width=16,
                                        stages=(1,)), device="cpu").init()
    x = r.rand(4, 16, 16, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 4)]
    net.fit(ListDataSetIterator([DataSet(x, y)] * 2))
    net.output(x)
    rnn = ComputationGraph(
        NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
        .add_layer("lstm", GravesLSTM(n_in=5, n_out=6), "in")
        .add_layer("out", RnnOutputLayer(n_in=6, n_out=5), "lstm")
        .set_outputs("out").backprop_type("tbptt").tbptt_fwd_length(3)
        .build(), device="cpu").init()
    seq = r.rand(2, 7, 5).astype(np.float32)
    rnn.fit_batch(MultiDataSet([seq], [seq]))
    rnn.rnn_time_step(seq[:, 0])
    assert _launches() + _lstm_launches() == before


def test_cpu_lenet_never_loads_a_kernel(monkeypatch):
    """The LeNet path (conv, pooling, dense; per batch and through the
    fused loop) runs no kernel of the package on the CPU."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _launches() + _lstm_launches()
    net = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    r = np.random.RandomState(0)
    x = r.rand(4, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 4)]
    net.fit(ListDataSetIterator([DataSet(x, y)] * 2))
    assert net._last_fuse_stats["fused_groups"] == 1
    net.output(x)
    assert _launches() + _lstm_launches() == before


def test_router_word2vec_and_tables_without_device_refuse_the_cpu(no_cuda):
    from deeplearning4j_tpu_torch.nlp import InMemoryLookupTable, Word2Vec
    from deeplearning4j_tpu_torch.serving import ReplicaRouter
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicaRouter([ContinuousLM(lm, slots=2) for _ in range(2)])
    router = ReplicaRouter([ContinuousLM(lm, slots=2, device="cpu")
                            for _ in range(2)])
    router.stop()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Word2Vec(layer_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InMemoryLookupTable(8, 4)
    Word2Vec(layer_size=4, device="cpu")
    assert InMemoryLookupTable(8, 4, device="cpu").syn0.device.type == "cpu"


def test_cpu_router_ingress_and_word2vec_never_load_a_kernel_or_capture(
        monkeypatch):
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.serving import ReplicaRouter, ServingIngress

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before, captures = _launches(), capture_count()
    lm = TransformerLM(TransformerConfig(**dict(SMALL, block_size=None)),
                       device="cpu").init()
    router = ReplicaRouter([ContinuousLM(lm, slots=2, chunk=2, device="cpu")
                            for _ in range(2)], heartbeat_s=3600.0)
    ing = ServingIngress(router).start()
    try:
        body = json.dumps({"prompt": [1, 2, 3], "n_new": 3}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{ing.port}/v1/generate", data=body),
            timeout=60)
        assert len(json.loads(r.read())["tokens"]) == 6
    finally:
        ing.stop()
        router.stop()
    w2v = Word2Vec(layer_size=8, window=2, negative=2, min_word_frequency=1,
                   batch_size=64, device="cpu")
    w2v.fit_corpus(["a b c d e f", "b c d a e", "f e d c b a"] * 20)
    assert _launches() == before and capture_count() == captures
