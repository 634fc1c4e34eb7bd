#!/usr/bin/env python3
"""Time design variants of the LSTM cell backward kernel on one GPU.

Each variant is a copy of ``deeplearning4j_tpu_torch/csrc`` with a text
patch to ``lstm_cell_bwd.cu``, built with the package's nvcc flags (all
variants in parallel, by ``flash_variants.build``) into the git-ignored
build directory, loaded with ctypes and timed at the char-RNN's cell step
(B 32, H 200, peepholes, f32) by CUDA-graph replay (``chip_smoke.graph_ms``:
the device time with the host taken out), beside the package's own kernel,
which is timed first and last. Some variants cut a phase out to show what
it costs, and so give wrong results: each variant's largest difference
from the package kernel is printed, not checked. Run from the repository
root on a host with the card::

    python3 lstm_variants.py

It prints one JSON object: times in ms, the largest difference from the
package kernel, and ptxas's register and spill lines of the f32 instance.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

_SYNC = "  cg::this_grid().sync();   // every dz and dP partial is written\n"
_NO_PHASE1 = ("for (int it = blockIdx.x; it < tj * n_chunks; it += gridDim.x)",
              "for (int it = blockIdx.x; it < 0; it += gridDim.x)")
_RETURN_BEFORE_BARRIER = (_SYNC, "  return;\n" + _SYNC)
_RETURN_AFTER_BARRIER = (_SYNC, _SYNC + "  return;\n")
_TWO_BLOCKS = ("__launch_bounds__(NT, 1)", "__launch_bounds__(NT, 2)")
# name -> (kernel source, [(text in the source, its replacement)])
VARIANTS = {
    # what the parts cost: the launch alone, with the barrier, each phase
    "launch_only": ("lstm_cell_bwd", [_NO_PHASE1, _RETURN_BEFORE_BARRIER]),
    "launch_and_barrier": ("lstm_cell_bwd", [_NO_PHASE1,
                                             _RETURN_AFTER_BARRIER]),
    "phase1_only": ("lstm_cell_bwd", [_RETURN_BEFORE_BARRIER]),
    "phase1_and_barrier": ("lstm_cell_bwd", [_RETURN_AFTER_BARRIER]),
    "barrier_and_phase2": ("lstm_cell_bwd", [_NO_PHASE1]),
    # registers capped at 128: two blocks an SM, a grid of 264
    "2_blocks_per_sm": ("lstm_cell_bwd", [_TWO_BLOCKS]),
    "2_blocks_per_sm_launch_and_barrier": ("lstm_cell_bwd", [
        _TWO_BLOCKS, _NO_PHASE1, _RETURN_AFTER_BARRIER]),
}
B, H = 32, 200


def f32_usage(log):
    """ptxas's lines for the f32 instance."""
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines) if "lstm_bwd_kernelIf" in ln]
    return [ln.strip() for ln in lines[at[-1] + 1:at[-1] + 3]] if at else []


def main():
    import torch
    if not torch.cuda.is_available():
        print("lstm_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import flash_variants
    from chip_smoke import graph_ms
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import lstm_cell as lc

    started = flash_variants.build(_build.BUILD_DIR / "variants", _build,
                                   VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0):
        return std * torch.randn(shape, generator=g, device="cuda")
    args = (rnd(B, 4 * H), rnd(B, H, std=0.5), rnd(B, H),
            rnd(H, 4 * H, std=H ** -0.5), rnd(3, H, std=0.1))
    dh, dc = rnd(B, H), rnd(B, H)
    want = lc._kernel_backward(*args, dh, dc)

    def package():
        return graph_ms(lambda: lc._kernel_backward(*args, dh, dc))
    out = {"shape": {"B": B, "H": H, "peephole": True, "dtype": "float32"},
           "device": torch.cuda.get_device_name(0),
           "package_first": package(), "variants": {}}
    for name, (lib_path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            out["variants"][name] = {"build_failed": log[-2000:]}
            continue
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.lstm_cell_bwd
        fn.argtypes, fn.restype = _build.KERNELS["lstm_cell_bwd"], ctypes.c_int
        size = lib.lstm_cell_bwd_scratch_floats
        size.argtypes, size.restype = (ctypes.c_int, ctypes.c_int), \
            ctypes.c_longlong
        got = [torch.empty_like(x) for x in want]
        scratch = torch.empty(size(B, H), device="cuda")
        rc = []

        def call():
            rc.append(fn(*(x.data_ptr() for x in args), dh.data_ptr(),
                         dc.data_ptr(), got[0].data_ptr(), got[0].data_ptr(),
                         scratch.data_ptr(),
                         *(x.data_ptr() for x in got[1:]), B, H, 0,
                         torch.cuda.current_stream().cuda_stream))
        call()
        torch.cuda.synchronize()
        out["variants"][name] = {
            "rc": max(rc), "ms": graph_ms(call),
            "max_diff_vs_package": max((a - b).abs().max().item()
                                       for a, b in zip(got, want)),
            "ptxas_f32": f32_usage(log)}
    out["package_last"] = package()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
