#!/usr/bin/env python3
"""Compare the routes a small-kernel, few-channel convolution can take on
one GPU, at LeNet's first conv (28x28x1 to 24x24x20, kernel 5x5, f32,
TF32 off) at batch 128 (the LeNet phase's) and 16 (cuDNN's choice of
algorithm depends on it):

- ``cudnn``: ``F.conv2d`` on the channels_last view of the NHWC input,
  cuDNN choosing its algorithms (the port's route for every other conv),
  and again under ``torch.backends.cudnn.deterministic``;
- ``unfold_gemm``: ``F.unfold`` patches and one GEMM;
- ``port``: ``ConvolutionLayer``'s own route for this shape (strided
  window views copied once, one GEMM), the one LeNet trains through.

For each: the output and weight-gradient error against a float64 CPU
reference (each relative to that result's max abs), whether two calls
give the same weight-gradient bits, and for a forward plus the weight
gradient (the first conv's input needs no gradient): the device time of
its kernels and copies and their names and counts (``torch.profiler``
over ``PROFILED`` calls), and the time a call by CUDA events over
back-to-back calls, which at this size is the host's pace. Run from the
repository root on a host with the card::

    python3 conv_variants.py

It prints one JSON object a route, then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = [(128, 28, 28, 1), (16, 28, 28, 1)]     # NHWC
KERNEL, N_OUT = (5, 5), 20
ITERS, WARMUP, PROFILED = 50, 5, 10


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(shape, card):
    """One record a route at ``shape`` (see the module docstring)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer
    r = np.random.RandomState(0)
    x = r.rand(*shape).astype(np.float32)
    w = (0.2 * r.randn(*KERNEL, shape[3], N_OUT)).astype(np.float32)
    b, h, wd, c = shape
    oh, ow = h - KERNEL[0] + 1, wd - KERNEL[1] + 1
    g = r.randn(b, oh, ow, N_OUT).astype(np.float32)
    layer = ConvolutionLayer(n_out=N_OUT, kernel_size=KERNEL,
                             has_bias=False, activation="identity")
    layer.set_input_type(InputType.convolutional(h, wd, c))
    assert layer.uses_im2col()

    def cudnn(xt, wt):
        z = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1))
        return z.permute(0, 2, 3, 1)

    def unfold_gemm(xt, wt):
        cols = F.unfold(xt.permute(0, 3, 1, 2), KERNEL)   # [B, C*KH*KW, L]
        cols = cols.transpose(1, 2).reshape(b * oh * ow, -1)
        wmat = wt.permute(2, 0, 1, 3).reshape(-1, N_OUT)
        return (cols @ wmat).reshape(b, oh, ow, N_OUT)

    def port(xt, wt):
        return layer.pre_output({"W": wt}, xt)

    # float64 reference on the CPU
    x64 = torch.tensor(x, dtype=torch.float64)
    w64 = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    out64 = cudnn(x64, w64)
    (dw64,) = torch.autograd.grad((out64 * torch.tensor(
        g, dtype=torch.float64)).sum(), w64)
    out64 = out64.detach()

    xt = torch.tensor(x, device="cuda")
    gt = torch.tensor(g, device="cuda")

    def step(route, wt):
        out = route(xt, wt)
        (dw,) = torch.autograd.grad((out * gt).sum(), wt)
        return out, dw

    def rel(got, want):
        return float((got.double().cpu() - want).abs().max()
                     / want.abs().max())

    routes = [("cudnn", cudnn, False), ("cudnn_deterministic", cudnn, True),
              ("unfold_gemm", unfold_gemm, False), ("port", port, False)]
    for name, route, det in routes:
        torch.backends.cudnn.deterministic = det
        try:
            wt = torch.tensor(w, device="cuda", requires_grad=True)
            for _ in range(WARMUP):
                step(route, wt)
            torch.cuda.synchronize()
            out, dw1 = step(route, wt)
            _, dw2 = step(route, wt)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                step(route, wt)
            end.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED):
                    step(route, wt)
                torch.cuda.synchronize()
            device = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")]
        finally:
            torch.backends.cudnn.deterministic = False
        yield {
            "route": name, "shape": {"x": shape, "kernel": KERNEL,
                                     "n_out": N_OUT},
            "out_rel_err_vs_f64": rel(out.detach(), out64),
            "dw_rel_err_vs_f64": rel(dw1, dw64),
            "dw_same_bits_twice": bool(torch.equal(dw1, dw2)),
            "device_ms_per_call": sum(
                getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in device) / 1e3 / PROFILED,
            "host_paced_call_ms": start.elapsed_time(end) / ITERS,
            "cuda_kernels_per_call": {e.key[:90]: e.count / PROFILED
                                      for e in device}, "card": card}


def main():
    import torch
    if not torch.cuda.is_available():
        print("conv_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    for shape in SHAPES:
        for rec in compare(shape, card):
            print(json.dumps(rec), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
