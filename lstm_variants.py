#!/usr/bin/env python3
"""Time design variants of the LSTM kernels on one GPU.

Each variant is a copy of ``deeplearning4j_tpu_torch/csrc`` with a text
patch to ``lstm_cell_fwd.cu`` (the sequence kernel) or ``lstm_cell_bwd.cu``
(the cell backward), built with the package's nvcc flags (all variants in
parallel, by ``flash_variants.build``) into the git-ignored build
directory, loaded with ctypes and timed by CUDA-graph replay
(``chip_smoke.graph_ms``: the device time with the host taken out) beside
the package's own kernel, which is timed first and last: the sequence
kernel over the char-RNN's layer window (T 50, B 32, H 200, peepholes,
f32), the backward at its cell step. Some variants cut a part out to show
what it costs, and so give wrong results: each variant's largest
difference from the package kernel is printed, not checked. Run from the
repository root on a host with the card::

    python3 lstm_variants.py

It prints one JSON object: times in ms, the largest difference from the
package kernel, and ptxas's register and spill lines of the f32 instance.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

_FWD, _BWD = "lstm_cell_fwd", "lstm_cell_bwd"
_GRID_SYNC = ("constexpr bool kTileCounters = true;",
              "constexpr bool kTileCounters = false;")
_RW_FROM_L2 = ("constexpr bool kRwResident = true;",
               "constexpr bool kRwResident = false;")
_NO_WAIT = ("if (kTileCounters && k > 0) wait_count(counters + bt, k * n_jt);",
            "")
_SYNC = "  cg::this_grid().sync();   // every dz and dP partial is written\n"
_NO_PHASE1 = ("for (int it = blockIdx.x; it < tj * n_chunks; it += gridDim.x)",
              "for (int it = blockIdx.x; it < 0; it += gridDim.x)")
_RETURN_BEFORE_BARRIER = (_SYNC, "  return;\n" + _SYNC)
_RETURN_AFTER_BARRIER = (_SYNC, _SYNC + "  return;\n")
_TWO_BLOCKS = ("__launch_bounds__(NT, 1)", "__launch_bounds__(NT, 2)")
# name -> (kernel source, [(text in the source, its replacement)])
VARIANTS = {
    # the sequence kernel's exchange (a grid sync a step in place of the
    # batch-tile counters) and its RW slice (from L2 every step)
    "fwd_grid_sync": (_FWD, [_GRID_SYNC]),
    "fwd_rw_from_l2": (_FWD, [_RW_FROM_L2]),
    "fwd_grid_sync_rw_from_l2": (_FWD, [_GRID_SYNC, _RW_FROM_L2]),
    # what the exchange costs: no wait at all (wrong results)
    "fwd_no_wait": (_FWD, [_NO_WAIT]),
    # the backward: what the parts cost (the launch alone, with the
    # barrier, each phase), and two blocks an SM
    "launch_only": (_BWD, [_NO_PHASE1, _RETURN_BEFORE_BARRIER]),
    "launch_and_barrier": (_BWD, [_NO_PHASE1, _RETURN_AFTER_BARRIER]),
    "phase1_only": (_BWD, [_RETURN_BEFORE_BARRIER]),
    "phase1_and_barrier": (_BWD, [_RETURN_AFTER_BARRIER]),
    "barrier_and_phase2": (_BWD, [_NO_PHASE1]),
    # registers capped at 128: two blocks an SM, a grid of 264
    "2_blocks_per_sm": (_BWD, [_TWO_BLOCKS]),
    "2_blocks_per_sm_launch_and_barrier": (_BWD, [
        _TWO_BLOCKS, _NO_PHASE1, _RETURN_AFTER_BARRIER]),
}
T, B, H = 50, 32, 200


def f32_usage(log, entry):
    """ptxas's lines for the f32 instance of ``entry``."""
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines) if f"{entry}If" in ln]
    return [ln.strip() for ln in lines[at[-1] + 1:at[-1] + 3]] if at else []


def _load(lib_path, name, helper):
    from deeplearning4j_tpu_torch.ops import _build
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = _build.KERNELS[name], ctypes.c_int
    size = getattr(lib, helper)
    size.argtypes, size.restype = (ctypes.c_int, ctypes.c_int), \
        ctypes.c_longlong
    return fn, size


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
    zx_t = rnd(T, B, 4 * H)
    args = (zx_t[0], rnd(B, H, std=0.5), rnd(B, H),
            rnd(H, 4 * H, std=H ** -0.5), rnd(3, H, std=0.1))
    dh, dc = rnd(B, H), rnd(B, H)
    seq_args = (zx_t, *args[1:], None, False)
    want_fwd = lc._kernel_sequence(*seq_args)
    want_bwd = lc._kernel_backward(*args, dh, dc)

    def stream():   # the capturing stream inside graph_ms
        return torch.cuda.current_stream().cuda_stream

    def fwd_package():
        return graph_ms(lambda: lc._kernel_sequence(*seq_args))

    def bwd_package():
        return graph_ms(lambda: lc._kernel_backward(*args, dh, dc))
    out = {"fwd_shape": {"T": T, "B": B, "H": H, "peephole": True,
                         "dtype": "float32"},
           "bwd_shape": {"B": B, "H": H, "peephole": True,
                         "dtype": "float32"},
           "device": torch.cuda.get_device_name(0),
           "fwd_package_first": fwd_package(),
           "bwd_package_first": bwd_package(), "variants": {}}
    for name, (lib_path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            out["variants"][name] = {"build_failed": log[-2000:]}
            continue
        src = VARIANTS[name][0]
        rc = []
        if src == _FWD:
            fn, size = _load(lib_path, _FWD, "lstm_cell_fwd_scratch_ints")
            got = [torch.empty_like(x) for x in want_fwd]
            n = size(B, H)
            counters = torch.empty(max(n, 1), dtype=torch.int32,
                                   device="cuda")

            def call():
                rc.append(fn(*(x.data_ptr() for x in seq_args[:5]), None,
                             got[1].data_ptr(), got[2].data_ptr(),
                             got[0].data_ptr(), counters.data_ptr(), T, B,
                             H, 0, 0, stream()))
            usage = f32_usage(log, "lstm_seq_kernel")
        else:
            fn, size = _load(lib_path, _BWD, "lstm_cell_bwd_scratch_floats")
            got = [torch.empty_like(x) for x in want_bwd]
            scratch = torch.empty(size(B, H), device="cuda")

            def call():
                rc.append(fn(*(x.data_ptr() for x in args), dh.data_ptr(),
                             dc.data_ptr(), got[0].data_ptr(),
                             got[0].data_ptr(), scratch.data_ptr(),
                             *(x.data_ptr() for x in got[1:]), B, H, 0, 0,
                             stream()))
            usage = f32_usage(log, "lstm_bwd_kernel")
        call()
        torch.cuda.synchronize()
        want = want_fwd if src == _FWD else want_bwd
        out["variants"][name] = {
            "kernel": src, "rc": max(rc), "ms": graph_ms(call),
            "max_diff_vs_package": max((a - b).abs().max().item()
                                       for a, b in zip(got, want)),
            "ptxas_f32": usage}
    out["fwd_package_last"] = fwd_package()
    out["bwd_package_last"] = bwd_package()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
