"""The port stands alone: no JAX, no reference package, no silent CPU.

- no file of ``deeplearning4j_tpu_torch/`` (the prefetcher
  ``datasets/async_iterator.py`` and ``tuning/autotuner.py`` included),
  nor ``chip_smoke.py`` or the design-variant timers ``flash_variants.py``,
  ``lstm_variants.py``, ``conv_variants.py`` and ``serve_variants.py``,
  imports ``jax``, ``jaxlib``, ``optax`` or
  ``deeplearning4j_tpu`` (AST scan; the optax rules, the solvers and the
  counter-based draws included), and
  importing the whole package in a fresh interpreter loads none of them;
- a CPU tensor never touches a kernel: no launch count moves and no
  kernel library is loaded, forward, backward or a training step; the
  ``scan`` parity routes (``DL4J_TORCH_LM_ATTN``, ``DL4J_TORCH_FLASH_BWD``)
  refuse a tensor that is not on the CPU; each kernel's boundary refuses
  what its kernel cannot take before any pointer is passed;
- with no CUDA present, the entry points without ``device="cpu"`` raise
  instead of running on the CPU (the model-archive restores, and
  ComputationGraph and its archive's restores, ContinuousLM and the
  decode-state carrier, the router over such replicas, Word2Vec and its
  lookup table included, and the Keras importers and the Keras RPC
  server's fit); generation, serving through the router and the
  ingress, and a Word2Vec fit on the CPU capture no CUDA graph and load
  no kernel; SelfAttentionLayer on the CPU declines its flash helper
  (counted) and a Keras-imported LSTM runs the LSTM kernels' plain twins,
  with no kernel loaded;
- an LM archive restored, GloVe, DeepWalk, the word- and graph-vector
  readers and the trained-model helper refuse the CPU without CUDA
  unless asked for it, and GloVe and DeepWalk fits on the CPU capture no
  CUDA graph and load no kernel;
- k-means, exact t-SNE and the early-stopping file saver's restore
  refuse the CPU without CUDA unless asked for it; the pretrain layers,
  transfer learning, early stopping, the gradient checker, the profiler
  listener, the reports and the trees are scanned like every module;
- ViT and MoETransformerLM, and the restores of their archives, refuse
  the CPU without CUDA unless asked for it; on the CPU their training
  steps load no kernel and count no launch, and the ViT's attention
  refuses a tensor on any other device before plain attention sees it;
  the model modules, the fetchers and the PNG codec are scanned like
  every module;
- joining a process group, ParallelWrapper, ``TransformerLM.shard`` and
  ``fsdp_trainer`` refuse the CPU without CUDA unless asked for it; the
  data-parallel modules (``parallel/``) are scanned like every module;
- the scaleout stack (``nativelib.py``, the coordinator and its CLI, the
  training master, the parameter-server wrapper, the worker process and
  ``nlp/distributed.py``) is scanned like every module; without CUDA a
  worker process started without ``--device``, a distributed network
  built from a configuration and distributed Word2Vec refuse the CPU
  unless asked for it;
- elastic training, the shard checkpoints and tensor parallelism
  (``parallel/elastic.py``, ``utils/orbax_io.py``,
  ``parallel/tensor_parallel.py``, ``parallel/tp_transformer.py``) are
  scanned like every module; without CUDA a re-formed process group,
  the tensor-parallel trainers and an elastic trainer over a model on
  the card refuse the CPU unless asked for it;
- pipeline, sequence and expert parallelism (``parallel/
  pipeline_parallel.py``, ``pp_transformer.py``, ``sp_transformer.py``,
  ``expert_parallel.py``, ``ep_transformer.py``) are scanned like every
  module; without CUDA their trainers refuse the CPU unless asked for
  it, their grids form no process group there, and a PP step on the CPU
  (flash attention's route, one stage) loads no kernel and counts no
  launch.
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
FORBIDDEN = {"jax", "jaxlib", "optax", "deeplearning4j_tpu"}
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
                "nlp/sequence_vectors.py", "nlp/word2vec.py",
                "nn/helpers.py", "nn/layers/attention.py", "eval/roc.py",
                "utils/h5.py", "modelimport/__init__.py",
                "modelimport/keras.py", "modelimport/keras_server.py",
                "datasets/normalizers.py", "datasets/records.py",
                "datasets/magic_queue.py", "nlp/glove.py",
                "nlp/serializer.py", "graph/__init__.py", "graph/graph.py",
                "graph/walkers.py", "graph/deepwalk.py",
                "modelimport/imagenet_labels.py",
                "modelimport/trained_models.py", "ops/random.py",
                "ops/optax_adapter.py", "ops/updaters.py",
                "optimize/solvers.py", "nn/layers/pretrain.py",
                "nn/transfer_learning.py", "earlystopping/__init__.py",
                "earlystopping/early_stopping.py",
                "gradientcheck/__init__.py",
                "gradientcheck/gradient_check_util.py",
                "optimize/listeners.py", "ui/__init__.py",
                "ui/components.py", "eval/evaluation_tools.py",
                "clustering/__init__.py", "clustering/trees.py",
                "clustering/kmeans.py", "plot/__init__.py",
                "plot/tsne.py", "models/vit.py",
                "models/moe_transformer.py", "utils/pngio.py",
                "nativelib.py", "parallel/coordinator.py",
                "parallel/coordinator_main.py",
                "parallel/training_master.py", "parallel/worker.py",
                "parallel/param_server_wrapper.py", "nlp/distributed.py",
                "parallel/elastic.py", "utils/orbax_io.py",
                "parallel/tensor_parallel.py",
                "parallel/tp_transformer.py",
                "parallel/pipeline_parallel.py",
                "parallel/pp_transformer.py", "parallel/sp_transformer.py",
                "parallel/expert_parallel.py",
                "parallel/ep_transformer.py", "ui/codec.py",
                "ui/storage.py", "ui/stats.py", "ui/conv_listener.py",
                "ui/server.py", "streaming/__init__.py",
                "streaming/serde.py", "streaming/broker.py",
                "streaming/routes.py", "nlp/vectorizer.py", "nlp/bpe.py",
                "nlp/analysis.py", "nlp/trees.py", "nlp/pcfg.py",
                "nlp/japanese.py", "nlp/korean.py"):
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
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
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


def test_clustering_tsne_and_saver_without_device_refuse_the_cpu(no_cuda,
                                                                tmp_path):
    """k-means, exact t-SNE and the file model saver's restore run on the
    card unless asked for the CPU; a transferred net stays on its
    source's device."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.earlystopping.early_stopping import (
        LocalFileModelSaver)
    from deeplearning4j_tpu_torch.nn.transfer_learning import (
        TransferLearning)
    from deeplearning4j_tpu_torch.plot import Tsne
    x = np.random.RandomState(0).rand(40, 3).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KMeansClustering(2).apply_to(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Tsne(max_iter=2, perplexity=5.0).fit(x)
    assert len(KMeansClustering(2, device="cpu").apply_to(x).clusters) == 2
    net = MultiLayerNetwork(zoo.mlp_mnist(hidden=8), device="cpu").init()
    saver = LocalFileModelSaver(str(tmp_path / "es"))
    saver.save_best_model(net, 0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        saver.get_best_model()
    assert LocalFileModelSaver(str(tmp_path / "es"), device="cpu") \
        .get_best_model().device.type == "cpu"
    tuned = TransferLearning.Builder(net).set_feature_extractor(0).build()
    assert all(t.device.type == "cpu" for p in tuned.params_list
               for t in p.values())


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


KERAS = REPO / "tests" / "fixtures" / "keras"


def test_keras_import_without_device_refuses_the_cpu(no_cuda, tmp_path):
    import json
    import urllib.error
    import urllib.request
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_and_weights,
        import_keras_sequential_model_and_weights)
    from deeplearning4j_tpu_torch.modelimport.keras_server import \
        KerasRPCServer
    path = str(KERAS / "lstm_k2_charrnn.h5")
    for imp in (import_keras_sequential_model_and_weights,
                import_keras_model_and_weights):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            imp(path)
        assert imp(path, device="cpu").device.type == "cpu"
    data = tmp_path / "mb"
    data.mkdir()
    np.savez(data / "b0.npz", features=np.zeros((2, 50, 65), np.float32),
             labels=np.eye(65, dtype=np.float32)[[0, 1]])
    srv = KerasRPCServer().start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/fit", data=json.dumps(
                {"model_path": path, "data_dir": str(data)}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert "CUDA is not available" in json.loads(e.value.read())["error"]
    finally:
        srv.stop()


def test_cpu_attention_and_keras_nets_never_load_a_kernel(monkeypatch):
    """An attention net trains and infers on the CPU through its built-in
    route (the flash helper declines, once a layer call) and the imported
    Keras LSTM runs and fine-tunes on the kernels' plain twins: no kernel
    library loaded, no launch counted."""
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_sequential_model_and_weights
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (RnnOutputLayer,
                                                    SelfAttentionLayer)

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _launches() + _lstm_launches()
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(SelfAttentionLayer(n_in=8, n_out=8, n_heads=2,
                                      causal=True))
            .layer(RnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    r = np.random.RandomState(0)
    x = r.randn(2, 6, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, (2, 6))]
    declined = helpers.declines("SelfAttentionLayer")
    net.fit_batch(x, y)
    net.output(x)
    assert helpers.declines("SelfAttentionLayer") == declined + 2
    lstm = import_keras_sequential_model_and_weights(
        str(KERAS / "lstm_k2_charrnn.h5"), device="cpu")
    seq = np.eye(65, dtype=np.float32)[r.randint(0, 65, (2, 50))]
    lstm.output(seq)
    lstm.fit_batch(seq, np.eye(65, dtype=np.float32)[[3, 4]])
    assert _launches() + _lstm_launches() == before


def test_persistence_embeddings_and_helper_without_device_refuse_the_cpu(
        no_cuda, tmp_path):
    from deeplearning4j_tpu_torch.graph import (DeepWalk,
                                                GraphVectorSerializer)
    from deeplearning4j_tpu_torch.modelimport.trained_models import \
        TrainedModelHelper
    from deeplearning4j_tpu_torch.nlp import Glove, WordVectorSerializer
    from deeplearning4j_tpu_torch.utils import model_serializer
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    path = str(tmp_path / "lm.zip")
    model_serializer.write_model(lm, path)
    text = tmp_path / "v.txt"
    text.write_text("1 2\nw 0.5 0.25\n")
    graph = tmp_path / "g.txt"
    graph.write_text("0\t0.5\t0.25\n")
    for call in (lambda: model_serializer.restore_model(path),
                 lambda: model_serializer.restore_transformer_lm(path),
                 lambda: Glove(layer_size=4), lambda: DeepWalk(),
                 lambda: WordVectorSerializer.read_word_vectors(str(text)),
                 lambda: GraphVectorSerializer.read_graph_vectors(
                     str(graph)),
                 lambda: TrainedModelHelper("vgg16").set_path_to_h5(
                     str(KERAS / "vgg16_tiny_k1_tf.h5")).load_model()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_glove_and_deepwalk_never_load_a_kernel_or_capture(
        monkeypatch):
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.nlp import Glove

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    captured = capture_count()
    g = Glove(layer_size=4, window=2, epochs=1, batch_size=8, device="cpu")
    g.fit_corpus(["a b c a", "b c d"])
    gr = Graph(4)
    for a, b in ((0, 1), (1, 2), (2, 3)):
        gr.add_edge(a, b)
    DeepWalk(vector_size=4, walk_length=4, batch_size=8,
             device="cpu").fit(gr)
    assert capture_count() == captured


def test_vit_and_moe_without_device_refuse_the_cpu(no_cuda, tmp_path):
    from deeplearning4j_tpu_torch.models import (MoETransformerConfig,
                                                 MoETransformerLM, ViT,
                                                 ViTConfig)
    from deeplearning4j_tpu_torch.utils import model_serializer
    vit_conf = ViTConfig(image_size=4, n_channels=1, patch_size=2,
                         d_model=8, n_heads=2, n_layers=1, d_ff=16)
    moe_conf = MoETransformerConfig(**SMALL, n_experts=2)
    paths = []
    for cls, conf in ((ViT, vit_conf), (MoETransformerLM, moe_conf)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(conf)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(conf, device="cuda")
        net = cls(conf, device="cpu").init()
        paths.append(str(tmp_path / f"{cls.__name__}.zip"))
        model_serializer.write_model(net, paths[-1])
    for path in paths:
        for restore in (model_serializer.restore_model,
                        model_serializer.restore_transformer_lm):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                restore(path)
            assert restore(path, device="cpu").device.type == "cpu"


def test_cpu_vit_and_moe_never_load_a_kernel(monkeypatch):
    from deeplearning4j_tpu_torch.models import (MoETransformerConfig,
                                                 MoETransformerLM, ViT,
                                                 ViTConfig)

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _launches()
    vit = ViT(ViTConfig(image_size=4, n_channels=1, patch_size=2, d_model=8,
                        n_heads=2, n_layers=1, d_ff=16), device="cpu").init()
    x = np.random.RandomState(0).rand(2, 4, 4, 1).astype(np.float32)
    vit.fit_batch(x, np.array([1, 3]))
    assert vit.output(x).shape == (2, 10)
    moe = MoETransformerLM(MoETransformerConfig(**SMALL, n_experts=2),
                           device="cpu").init()
    toks = np.random.RandomState(1).randint(0, 32, (2, 9))
    moe.fit_batch(toks)
    assert moe.output(toks).shape == (2, 9, 32)
    assert _launches() == before


def test_vit_attention_refuses_device_tensors(monkeypatch):
    """The ViT's attention: the flash kernels for a CUDA tensor, the dense
    math for a CPU tensor, and an error for anything else (``meta``
    stands in for a device that is neither)."""
    from deeplearning4j_tpu_torch.models import vit

    def no_plain(*args, **kw):
        raise AssertionError("plain attention reached by a device tensor")
    monkeypatch.setattr(vit, "dense_attention", no_plain)
    q = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        vit._attend(q, q, q)


def test_data_parallelism_without_device_refuses_the_cpu(no_cuda):
    """Joining a process group, ParallelWrapper, TransformerLM.shard and
    fsdp_trainer take the card unless ``device="cpu"`` is asked for: no
    group is created and no plan placed on the CPU behind the caller."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize("127.0.0.1:1", 1, 0, backend="gloo")
    assert not dist.is_initialized()
    net = MultiLayerNetwork(zoo.char_rnn(vocab_size=5, hidden=4),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParallelWrapper(net)
    assert ParallelWrapper(net, device="cpu").workers == 1
    lm = TransformerLM(TransformerConfig(**SMALL), device="cpu").init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.shard()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.fsdp_trainer()
    assert lm._shard_plan is None
    assert lm.shard(device="cpu")._shard_plan.n == 1


def test_scaleout_entry_points_without_device_refuse_the_cpu(no_cuda,
                                                            tmp_path):
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import worker
    from deeplearning4j_tpu_torch.parallel.training_master import (
        DistributedMultiLayerNetwork, ParameterAveragingTrainingMaster)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main(["--host", "127.0.0.1", "--port", "1", "--worker-id",
                     "0", "--data-dir", str(tmp_path)])
    tm = ParameterAveragingTrainingMaster(n_workers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedMultiLayerNetwork(zoo.mlp_mnist(hidden=8), tm)
    assert DistributedMultiLayerNetwork(zoo.mlp_mnist(hidden=8), tm,
                                        device="cpu").network.device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedWord2Vec(n_workers=1)
    DistributedWord2Vec(n_workers=1, device="cpu")


def test_elastic_and_tensor_parallel_without_device_refuse_the_cpu(
        no_cuda, tmp_path):
    """``multihost.reform``, the tensor-parallel trainers and an elastic
    trainer take the card unless ``device="cpu"`` is asked for: no group
    is formed and no trainer placed on the CPU behind the caller."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        TPMesh, TensorParallelMLP)
    from deeplearning4j_tpu_torch.parallel.tp_transformer import \
        TPTransformerLM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.reform(str(tmp_path / "store"), 1, 0)
    assert not dist.is_initialized()
    conf = TransformerConfig(**dict(SMALL, block_size=None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPTransformerLM(TPMesh(1, 1, 0, 0), conf)
    assert TPTransformerLM(TPMesh(1, 1, 0, 0), conf,
                           device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TensorParallelMLP(TPMesh(1, 1, 0, 0), 4, 8, 2)
    net = MultiLayerNetwork(zoo.char_rnn(vocab_size=5, hidden=4),
                            device="cpu")
    assert ElasticTrainer(net, "127.0.0.1", 1).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticTrainer(object(), "127.0.0.1", 1)


def _grid(*names):
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
    return TPMesh(1, 1, 0, 0, axis_names=names)


def test_model_parallel_trainers_without_device_refuse_the_cpu(no_cuda):
    """PipelineParallelNet, PPTransformerLM, SPTransformerLM,
    ExpertParallelMoE and EPTransformerLM take the card unless
    ``device="cpu"`` is asked for; the grid factories form no process
    group in a process that joined none."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerConfig
    from deeplearning4j_tpu_torch.parallel import (
        EPTransformerLM, ExpertParallelMoE, PipelineParallelNet,
        PPTransformerLM, SPTransformerLM, ep_mesh, pp_mesh)
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
    conf = TransformerConfig(**dict(SMALL, block_size=None))
    moe = MoETransformerConfig(**dict(SMALL, block_size=None, n_experts=2,
                                      moe_every=1))
    assert pp_mesh(1, 1).shape == {"data": 1, "pipe": 1}
    assert ep_mesh(1).shape == {"data": 1, "expert": 1}
    assert not dist.is_initialized()
    pipe, seq, expert = (_grid("data", "pipe"), _grid("data", "seq"),
                         _grid("data", "expert"))
    for make in (lambda **kw: PipelineParallelNet(pipe, 4, 8, 2, 1, **kw),
                 lambda **kw: PPTransformerLM(pipe, conf, 1, **kw),
                 lambda **kw: SPTransformerLM(seq, conf, **kw),
                 lambda **kw: ExpertParallelMoE(expert, 4, 8, 2, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        assert make(device="cpu").device.type == "cpu"
    # two experts need a row of two: a view of one, with no group
    row = TPMesh(1, 2, 0, 0, axis_names=("data", "expert"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EPTransformerLM(row, moe)
    assert EPTransformerLM(row, moe, device="cpu").device.type == "cpu"


def test_cpu_pipeline_step_never_loads_a_kernel(monkeypatch):
    """A PP step on the CPU over the flash route (block_size set: the
    kernel on the card) takes the plain twin: no kernel library loaded,
    no launch counted."""
    from deeplearning4j_tpu_torch.parallel.pp_transformer import \
        PPTransformerLM

    def no_kernel(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _launches()
    pp = PPTransformerLM(_grid("data", "pipe"),
                         TransformerConfig(**SMALL), 2, device="cpu")
    loss = float(pp.fit_batch(np.ones((2, 17), np.int32)))
    assert np.isfinite(loss) and _launches() == before
