#!/usr/bin/env python3
"""Time design variants of the bf16 flash-attention kernels on one GPU.

Each variant is a copy of ``deeplearning4j_tpu_torch/csrc`` with a text
patch to one kernel source, built with the package's nvcc flags (all
variants in parallel) into the git-ignored build directory, loaded with
ctypes and timed at the LM train shape (n 256, T 511, d 64, causal, bf16;
mean of 20 back-to-back launches by CUDA events, inputs warm in L2) beside
the package's own kernel, which is timed first and last. Each variant's
output is compared with the package kernel's. Run from the repository
root on a host with the card::

    python3 flash_variants.py

It prints one JSON object: times in ms, the largest difference from the
package kernel, and ptxas's register and spill lines of the d 64 instance.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

# name -> (kernel source, [(text in the source, its replacement)])
VARIANTS = {
    "fwd_2_blocks_per_sm": ("flash_attn_fwd", [
        ("__launch_bounds__(NT, DP <= 64 ? 4 : 2)", "__launch_bounds__(NT, 2)")]),
    "fwd_3_blocks_per_sm": ("flash_attn_fwd", [
        ("__launch_bounds__(NT, DP <= 64 ? 4 : 2)",
         "__launch_bounds__(NT, DP <= 64 ? 3 : 2)")]),
    "fwd_expf": ("flash_attn_fwd", [
        ("exp2f((s[j][e] - m_new[e >> 1]) * LOG2E)",
         "expf(s[j][e] - m_new[e >> 1])")]),
    "dkv_one_pass_of_64": ("flash_attn_dkv", [
        ("constexpr int QW = 32;", "constexpr int QW = DP > 64 ? 32 : 64;")]),
    "dkv_exp2f": ("flash_attn_dkv", [
        ("expf(s[j][e] * scale - lst[qc])",
         "exp2f((s[j][e] * scale - lst[qc]) * 1.4426950408889634f)")]),
    "dq_2_blocks_per_sm": ("flash_attn_dq", [
        ("__launch_bounds__(NT, DP <= 64 ? 4 : 2)", "__launch_bounds__(NT, 2)")]),
    "dq_3_blocks_per_sm": ("flash_attn_dq", [
        ("__launch_bounds__(NT, DP <= 64 ? 4 : 2)",
         "__launch_bounds__(NT, DP <= 64 ? 3 : 2)")]),
    "dq_one_pass_of_64": ("flash_attn_dq", [
        ("constexpr int KW = 32;", "constexpr int KW = DP > 64 ? 32 : 64;")]),
    "dq_expf": ("flash_attn_dq", [
        ("exp2f((s[j][e] * scale - lse_r[r]) * LOG2E)",
         "expf(s[j][e] * scale - lse_r[r])")]),
}
N, T, D = 256, 511, 64


def build(build_dir, build_mod, variants=None):
    """Start one nvcc per variant of ``variants`` (default
    :data:`VARIANTS`: name -> (kernel source, patches)); returns {name:
    (library path, process)}."""
    started = {}
    for name, (src, patches) in (variants or VARIANTS).items():
        d = build_dir / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build_mod.SRC_DIR, d)
        text = (d / f"{src}.cu").read_text()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: patch target not in {src}.cu: {old}")
            text = text.replace(old, new)
        (d / f"{src}.cu").write_text(text)
        lib = d / "lib.so"
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{src}.cu")]
        started[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return started


def d64_usage(log):
    """ptxas's lines for the d 64 tensor-core instance."""
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines) if "mma_kernelILi64" in ln]
    return [ln.strip() for ln in lines[at[-1] + 1:at[-1] + 3]] if at else []


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import time_ms
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    started = build(_build.BUILD_DIR / "variants", _build)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = ((0.5 * torch.randn((N, T, D), generator=g, device="cuda"))
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, window=None, kv_group=1)
    o, lse = fa._kernel_forward(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = fa._kernel_dkv(q, k, v, do, lse, delta, **kw)
    dq = fa._kernel_dq(q, k, v, do, lse, delta, **kw)
    stream = torch.cuda.current_stream().cuda_stream

    def package():
        return {"flash_attn_fwd": time_ms(
                    lambda: fa._kernel_forward(q, k, v, **kw)),
                "flash_attn_dq": time_ms(
                    lambda: fa._kernel_dq(q, k, v, do, lse, delta, **kw)),
                "flash_attn_dkv": time_ms(
                    lambda: fa._kernel_dkv(q, k, v, do, lse, delta, **kw))}
    out = {"shape": {"n": N, "T": T, "d": D, "causal": True,
                     "dtype": "bfloat16"},
           "device": torch.cuda.get_device_name(0),
           "package_first": package(), "variants": {}}
    for name, (lib_path, proc) in started.items():
        log, _ = proc.communicate()
        src = VARIANTS[name][0]
        if proc.returncode != 0:
            out["variants"][name] = {"build_failed": log[-2000:]}
            continue
        fn = getattr(ctypes.CDLL(str(lib_path)), src)
        fn.argtypes, fn.restype = _build.KERNELS[src], ctypes.c_int
        if src == "flash_attn_fwd":
            got, got_lse = torch.empty_like(q), torch.empty_like(lse)

            def call():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          got.data_ptr(), got_lse.data_ptr(), N, T, D, 1, 1,
                          0, fa._scale(q), 1, stream)
            want = ((got, o), (got_lse, lse))
        elif src == "flash_attn_dq":
            gq = torch.empty_like(q)

            def call():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          gq.data_ptr(), N, T, D, 1, 1, 0, fa._bwd_scale(D),
                          1, stream)
            want = ((gq, dq),)
        else:
            gk, gv = torch.empty_like(k), torch.empty_like(v)

            def call():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          gk.data_ptr(), gv.data_ptr(), N, T, D, 1, 1, 0,
                          fa._bwd_scale(D), 1, stream)
            want = ((gk, dk), (gv, dv))
        rc = call()
        torch.cuda.synchronize()
        out["variants"][name] = {
            "rc": rc, "ms": time_ms(call),
            "max_diff_vs_package": max((a.float() - b.float()).abs().max()
                                       .item() for a, b in want),
            "ptxas_d64": d64_usage(log)}
    out["package_last"] = package()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
