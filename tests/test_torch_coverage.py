"""The port is whole: every module of the JAX package has a counterpart
at the same path in ``deeplearning4j_tpu_torch/``, and every public
top-level name of the JAX package is defined at the top level of some
module of the port, but for the names below, each with its reason.

``ops/pallas_kernels.py`` is the one module without a same-path
counterpart: its five Pallas kernels are the CUDA sources of
``deeplearning4j_tpu_torch/csrc/``, each named there.

An AST scan of both packages (nothing is imported): about 1 s on one
worker.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "deeplearning4j_tpu"
PORT = REPO / "deeplearning4j_tpu_torch"

# the Pallas launchers' counterparts: the CUDA sources, one a kernel
KERNEL_SOURCES = {
    "_flash_kernel": "flash_attn_fwd.cu",
    "_flash_dq_kernel": "flash_attn_dq.cu",
    "_flash_dkv_kernel": "flash_attn_dkv.cu",
    "_lstm_cell_fwd_kernel": "lstm_cell_fwd.cu",
    "_lstm_cell_bwd_kernel": "lstm_cell_bwd.cu",
}

# public names of the JAX package the port has no same-name counterpart
# for: (module, name) -> the reason
ALLOWED = {
    ("datasets/fetchers.py", "ingest_mnist"):
        "a download; the port's fetchers read local paths only",
    ("datasets/fetchers.py", "ingest_cifar10"):
        "a download; the port's fetchers read local paths only",
    ("datasets/fetchers.py", "ingest_iris"):
        "a download; the port's fetchers read local paths only",
    ("datasets/fetchers.py", "ingest_lfw"):
        "a download; the port's fetchers read local paths only",
    ("datasets/fetchers.py", "MNIST_BASE_URL"): "the downloads' URL",
    ("datasets/fetchers.py", "CIFAR10_URL"): "the downloads' URL",
    ("datasets/fetchers.py", "IRIS_URL"): "the downloads' URL",
    ("datasets/fetchers.py", "LFW_URL"): "the downloads' URL",
    ("datasets/fetchers.py", "MNIST_FILES"):
        "the downloads' file list; the port's MNIST reader names the "
        "idx files it looks for itself",
    ("hw.py", "TPU_V5E_BF16_PEAK_FLOPS"):
        "a TPU's peak; the port's hw.py holds the H100's",
    ("models/_device_state.py", "fuse_unroll"):
        "an XLA:CPU scan-unroll choice; the port's fused loop replays a "
        "CUDA graph a window",
    ("models/_device_state.py", "maybe_remat"):
        "jax.checkpoint around a layer; inline in models/_layered.py "
        "(torch.utils.checkpoint in _layer_forward)",
    ("ops/updaters.py", "RULES"):
        "the reference's tuple of rule names, read by nothing; the port's "
        "init_state/compute_updates dispatch on the name and raise on an "
        "unknown one",
    ("ops/updaters.py", "apply_l1_l2"):
        "called by nothing in the reference; both packages add "
        "l1_l2_score to the loss, and autograd differentiates it",
    ("parallel/multihost.py", "global_put"):
        "places a host array on a JAX global mesh; the port's ranks are "
        "processes that each hold their own tensors (ROADMAP.md queue 2, "
        "known difference 5)",
    ("parallel/sharding_core.py", "MODEL_AXIS"):
        "a JAX mesh axis name; the port's grids of process groups "
        "(known difference 6) name their axes per grid",
    ("parallel/sharding_core.py", "mesh_2d"):
        "builds a JAX device mesh; replaced by the port's process-group "
        "grids (tp_mesh, pp_mesh, ep_mesh; known difference 6)",
    ("parallel/sharding_core.py", "place_tree"):
        "device_put of a tree onto a JAX mesh; the port's ranks take "
        "their shards of the tree themselves (known differences 5-6)",
    ("provisioning/cluster.py", "TpuVmCreator"):
        "creates TPU VMs; the port's GpuVmCreator creates GCE GPU VMs",
    ("testing/compilewatch.py", "outlaws"):
        "siglint's G025 findings (unblessed jax.jit caches); the port's "
        "programs are captured CUDA graphs and kernel builds, held by "
        "steady() alone",
    ("ui/stats.py", "os_cpu_count"):
        "a one-line wrapper of os.cpu_count, inline in the port's "
        "ui/stats.py",
}


def _modules(pkg):
    return {p.relative_to(pkg).as_posix(): p for p in pkg.rglob("*.py")
            if "_build" not in p.parts}


def _public_names(path):
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


@pytest.fixture(scope="module")
def scan():
    ref, port = _modules(REF), _modules(PORT)
    port_names = set()
    for path in port.values():
        port_names |= _public_names(path)
    ref_names = {m: _public_names(p) for m, p in ref.items()}
    return ref, port, port_names, ref_names


def test_every_module_has_a_same_path_counterpart(scan):
    ref, port, _, _ = scan
    missing = sorted(set(ref) - set(port) - {"ops/pallas_kernels.py"})
    assert not missing, missing


def test_the_pallas_kernels_map_to_the_cuda_sources():
    text = (REF / "ops" / "pallas_kernels.py").read_text()
    kernels = {n.name for n in ast.parse(text).body
               if isinstance(n, ast.FunctionDef) and n.name.endswith(
                   "_kernel")}
    assert kernels == set(KERNEL_SOURCES), kernels
    assert text.count("pl.pallas_call(") == len(KERNEL_SOURCES)
    for src in KERNEL_SOURCES.values():
        assert (PORT / "csrc" / src).is_file(), src


def test_every_public_name_has_a_counterpart(scan):
    _, _, port_names, ref_names = scan
    missing = sorted((m, n) for m, names in ref_names.items()
                     if m != "ops/pallas_kernels.py"
                     for n in names - port_names)
    unexplained = [k for k in missing if k not in ALLOWED]
    assert not unexplained, unexplained
    # the allow-list holds no name that has a counterpart after all
    stale = sorted(k for k in ALLOWED if k not in missing)
    assert not stale, stale
    assert all(len(reason) > 10 for reason in ALLOWED.values())
