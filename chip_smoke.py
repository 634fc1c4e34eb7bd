#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain versions.

Run from the repository root on a host with an H100 and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build — compile every kernel of ``deeplearning4j_tpu_torch/csrc`` with
   nvcc (one process per source, started together) and report the time;
2. kernels — each kernel on the card against its plain PyTorch twin on
   the same inputs, at the serving and training paths' shapes and a few
   edge shapes: the forward, and the two backward kernels (dQ, dK/dV)
   against the plain backward, each with its time, the twin's, one
   PyTorch library call's (a yardstick the port never calls) and the
   least time the card could take; and the public wrapper on bf16 q/k/v
   laid out as the model hands them over;
3. slice — a full-width TransformerLM (V 32768, T 512, d 512, L 8, H 8,
   ff 2048, bf16 compute, flash block 128; random weights from a seed)
   behind ``InferenceServer`` answers 16 concurrent 512-token requests.
   Served rows must equal ``output()`` of their batch, the forward kernel
   must have launched once per layer per batch (and no backward kernel),
   and an f32 copy of the model on the card must match the same weights
   run on the CPU;
4. train — the same model takes 2 warm-up and 10 timed ``fit_batch``
   steps on one fixed batch of 32 next-token rows of 512 tokens. The loss
   must be finite and fall, each step must launch each of the three
   kernels once per layer, and every parameter must get a non-zero
   gradient; it reports step time, tokens/s, MFU, peak memory and a step
   breakdown. A 2-layer f32 copy then takes one step's gradients on the
   card and on the CPU from the same weights, which must agree.

Every line before the last is a JSON object or the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}   # dense, published
F32_TOL = 1e-5     # summation order only
# bf16 O against the twin's O rounded to bf16: two roundings of nearly
# equal f32 values land at most one bf16 step apart, and a step is at most
# 2^-7 |O|; so |err| <= BF16_ATOL + BF16_RTOL |want| element by element
BF16_ATOL, BF16_RTOL = 1e-5, 2.0 ** -7
BF16_TOL = 1e-2    # and against the twin's unrounded f32 O: half a step
CPU_GPU_TOL = 1e-4  # f32 logits, CPU vs card, eight layers deep
# backward kernels: f32 dq/dk/dv within 1e-5 of each gradient's max abs
# (summation order only); bf16 within one bf16 step of the twin's bf16
# result (1e-5 max|g| + 2^-7 |g| element by element), and within one bf16
# step at the gradient's scale (2^-7 max|g|) of its unrounded f32 result
BWD_F32_RTOL = 1e-5
# f32 training step, card against CPU, two layers: loss 1e-5 abs; each
# gradient leaf within 1e-4 of its max abs (cuBLAS and the CPU's BLAS sum
# the d 512 / vocab 32768 products in another order)
TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4

# the serving slice: bench.py's full-width TransformerLM config
SLICE = dict(vocab_size=32768, max_len=512, d_model=512, n_heads=8,
             n_layers=8, d_ff=2048, compute_dtype="bfloat16", block_size=128,
             seed=SEED)
BUCKET = 8
N_REQUESTS = 16
# the train phase: bench.py:bench_transformer_lm's batch, next-token rows
TRAIN_BATCH = 32
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
CPU_CHECK_T = 128   # the f32 card-against-CPU step: 2 rows of 128 inputs

# kernel cases: (name, n q-heads, kv-heads, T, d, causal, window)
KERNEL_CASES = [
    ("main", 64, 64, 512, 64, True, None),     # 8 requests x 8 heads
    ("gqa2_window24_T500", 64, 32, 500, 64, True, 24),
    ("d16", 64, 64, 512, 16, True, None),
    ("d128", 32, 32, 512, 128, True, None),
    # the train phase's attention: 32 rows x 8 heads, T = 512 - 1
    ("train", 256, 256, 511, 64, True, None),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events (inputs stay in L2, as after the producing matmul)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pairs(t, window, causal):
    """(query, key) pairs the mask keeps."""
    if not causal:
        return t * t
    w = t if window is None else window
    return sum(min(i + 1, w) for i in range(t))


def _bound(bytes_moved, ops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", bytes_moved, ops)


def attention_bound(n, kv_n, t, d, window, causal, dtype_name):
    """Least time for one forward call: each input read once and each
    output written once at the memory rate, against the products this
    mask needs (QKᵀ and PV, 2 ops per multiply-add) at the type's peak."""
    es = 4 if dtype_name == "float32" else 2
    bytes_moved = (2 * n + 2 * kv_n) * t * d * es + n * t * 4
    return _bound(bytes_moved, 4 * n * _pairs(t, window, causal) * d,
                  dtype_name)


def backward_bounds(n, kv_n, t, d, window, causal, dtype_name):
    """Least times of the two backward calls. Both read q, k, v, dO, lse
    and delta once. dQ writes dQ and needs S, dP and dS·K (6 ops per pair
    and dim); dK/dV writes dK and dV and needs S, dP, Pᵀ·dO and dSᵀ·Q
    (8 ops per pair and dim)."""
    es = 4 if dtype_name == "float32" else 2
    reads = (2 * n + 2 * kv_n) * t * d * es + 2 * n * t * 4
    pairs = _pairs(t, window, causal)
    return (_bound(reads + n * t * d * es, 6 * n * pairs * d, dtype_name),
            _bound(reads + 2 * kv_n * t * d * es, 8 * n * pairs * d,
                   dtype_name))


def _numpy_tree(params):
    return {k: _numpy_tree(v) if hasattr(v, "items")
            else v.detach().cpu().numpy() for k, v in params.items()}


def output_breakdown(lm, x, n_batches, wall):
    """Where one served batch's ``output()`` spends its time: the forward
    on the card (CUDA events), the logits' copy to the host and the
    numpy hand-off (host clock); and the card's busy share of the main
    path's wall time, taken as forward time x batches / wall."""
    import numpy as np
    import torch
    toks = torch.from_numpy(x.astype(np.int64)).to(DEVICE)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: lm._logits(lm.params, toks), iters=5,
                             warmup=1)
        logits = lm._logits(lm.params, toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = logits.cpu()
        t1 = time.perf_counter()
        host.numpy()
        t2 = time.perf_counter()
    return {"rows": int(x.shape[0]), "logits_bytes": logits.numel() * 4,
            "forward_ms": forward_ms, "to_host_ms": (t1 - t0) * 1e3,
            "numpy_ms": (t2 - t1) * 1e3,
            "device_busy_share": forward_ms * 1e-3 * n_batches / wall}


def phase_build(card):
    from deeplearning4j_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        emit({"phase": "build", "kernel": name, "ptxas": usage})
    emit({"phase": "build", "seconds": seconds, "card": card})


def check_o(got, want, dtype):
    """Kernel O against the twin's O in the same dtype: (max abs error,
    the largest error over its limit, ok). f32: 1e-5 abs; bf16: one bf16
    step, BF16_ATOL + BF16_RTOL |want| element by element."""
    import torch
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        limit = torch.full_like(err, F32_TOL)
    else:
        limit = BF16_ATOL + BF16_RTOL * want.float().abs()
    ratio = (err / limit).max().item()
    return err.max().item(), ratio, ratio <= 1.0 and \
        bool(torch.isfinite(got).all())


def phase_kernels(card):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, n, kv_n, t, d, causal, window in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            # unit normals in f32; in bf16 the size of the serving path's
            # q/k/v (std ~0.45 after LayerNorm and a std-0.02 projection)
            std = 1.0 if dtype == torch.float32 else 0.5
            q, k, v = (std * torch.randn(s, generator=g, device=dev)
                       for s in ((n, t, d), (kv_n, t, d), (kv_n, t, d)))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kw = dict(causal=causal, window=window, kv_group=n // kv_n)
            out, lse = fa._flash_forward(q, k, v, **kw)
            torch.cuda.synchronize()
            want_o, want_lse = fa.flash_attention_plain(q, k, v, **kw)
            err_o, limit_ratio, ok = check_o(out, want_o, dtype)
            # the twin's f32 O before its rounding to the input dtype
            want_f32, _ = fa._plain_forward(q, k, v, **kw)
            err_f32 = (out.float() - want_f32).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            ok = ok and err_f32 <= tol and err_lse <= F32_TOL

            kernel_ms = time_ms(lambda: fa._flash_forward(q, k, v, **kw))
            plain_ms = time_ms(lambda: fa._plain_forward(q, k, v, **kw))
            q4, k4, v4 = q[None], k[None], v[None]
            if window is None:
                def library():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=causal,
                        enable_gqa=kv_n != n)
            else:
                pos = torch.arange(t, device=dev)
                mask = (pos[:, None] >= pos[None, :]) & \
                    (pos[:, None] - pos[None, :] < window)

                def library():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask, enable_gqa=kv_n != n)
            library_ms = time_ms(library)
            bound_ms, bound_by, nbytes, ops = attention_bound(
                n, kv_n, t, d, window, causal, dname)
            rec = {"phase": "kernel", "case": name, "dtype": dname,
                   "shape": {"n": n, "kv_heads": kv_n, "T": t, "d": d,
                             "causal": causal, "window": window},
                   "max_abs_err": err_o, "err_over_limit": limit_ratio,
                   "max_abs_err_vs_f32_twin": err_f32,
                   "lse_max_abs_err": err_lse, "tol_vs_f32_twin": tol,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                   "card": card, "ok": ok}
            emit(rec)
            if not ok:
                raise AssertionError(f"flash_attn_fwd disagrees with its "
                                     f"twin: {rec}")
            results[(name, dname)] = rec
            del want_o, want_lse, want_f32
            results[(name, dname, "bwd")] = backward_case(
                card, g, name, q, k, v, out, lse, causal, window, std)
            del q, k, v, out, lse
    results["model_views"] = wrapper_on_model_views(card, g)
    return results


def check_grad(got, want, want_f32, dtype):
    """A backward kernel's gradient against the plain backward's on the
    same inputs: (max abs error, the largest error over its limit, max
    abs error against the unrounded f32 result, ok)."""
    import torch
    scale = want_f32.abs().max().item()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        limit = torch.full_like(err, BWD_F32_RTOL * scale)
        err_f32, ok_f32 = err.max().item(), True
    else:
        limit = BWD_F32_RTOL * scale + BF16_RTOL * want.float().abs()
        err_f32 = (got.float() - want_f32).abs().max().item()
        ok_f32 = err_f32 <= BF16_RTOL * scale
    ratio = (err / limit).max().item()
    return err.max().item(), ratio, err_f32, ratio <= 1.0 and ok_f32 and \
        bool(torch.isfinite(got).all())


def backward_case(card, g, name, q, k, v, out, lse, causal, window, std):
    """dQ and dK/dV kernels against ``flash_attention_bwd_plain`` on the
    same q, k, v, the forward kernel's O and lse, and a random dO; with
    their times, the plain backward's, and the backward of PyTorch's
    ``scaled_dot_product_attention`` (the forward outside the timed
    region) as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    n, t, d = q.shape
    kv_n = k.shape[0]
    dtype = q.dtype
    dname = str(dtype).split(".")[1]
    do = (std * torch.randn((n, t, d), generator=g, device=q.device)) \
        .to(dtype)
    kw = dict(causal=causal, window=window, kv_group=n // kv_n)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa._kernel_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa._kernel_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    # the same inputs upcast exactly: the plain backward before rounding
    want_f32 = want if dtype == torch.float32 else \
        fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     out.float(), lse, do.float(), **kw)
    errs = {}
    ok = True
    for gname, got, w, w32 in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                  want_f32):
        err, ratio, err_f32, good = check_grad(got, w, w32, dtype)
        errs[gname] = {"max_abs_err": err, "err_over_limit": ratio,
                       "max_abs_err_vs_f32_twin": err_f32,
                       "scale": w32.abs().max().item()}
        ok = ok and good and got.shape == w.shape and got.dtype == dtype
    del want, want_f32

    dq_ms = time_ms(lambda: fa._kernel_dq(q, k, v, do, lse, delta, **kw))
    dkv_ms = time_ms(lambda: fa._kernel_dkv(q, k, v, do, lse, delta, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=5, warmup=1)
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    if window is None:
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                            enable_gqa=kv_n != n)
    else:
        pos = torch.arange(t, device=q.device)
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)
        o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                            enable_gqa=kv_n != n)
    library_ms = time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do[None], retain_graph=True))
    del o4, q4, k4, v4
    (dq_bound, dq_by, dq_bytes, dq_ops), (dkv_bound, dkv_by, dkv_bytes,
                                          dkv_ops) = backward_bounds(
        n, kv_n, t, d, window, causal, dname)
    rec = {"phase": "kernel_bwd", "case": name, "dtype": dname,
           "shape": {"n": n, "kv_heads": kv_n, "T": t, "d": d,
                     "causal": causal, "window": window},
           "errors": errs, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
           "plain_bwd_ms": plain_ms, "library_bwd_ms": library_ms,
           "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
           "dq_bytes": dq_bytes, "dq_ops": dq_ops,
           "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
           "dkv_bytes": dkv_bytes, "dkv_ops": dkv_ops, "card": card,
           "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"backward kernels disagree with the plain "
                             f"backward: {rec}")
    return rec


def wrapper_on_model_views(card, g):
    """The public wrapper as the slice calls it: bf16 q/k/v split from one
    [B, T, 3d] projection and viewed [B, H, T, hd] (transposed, not
    contiguous), causal, flash block 128; against the twin on the same
    values. ``wrapper_ms`` includes the copies the wrapper makes."""
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    b, t, d, h = BUCKET, SLICE["max_len"], SLICE["d_model"], \
        SLICE["n_heads"]
    hd = d // h
    blk = SLICE["block_size"]
    qkv = (0.5 * torch.randn((b, t, 3 * d), generator=g, device=DEVICE)) \
        .to(torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2)
               for x in torch.split(qkv, [d, d, d], dim=-1))
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, causal=True, block_q=blk, block_k=blk)
    torch.cuda.synchronize()
    want, _ = fa.flash_attention_plain(
        *(x.reshape(-1, t, hd) for x in (q, k, v)), causal=True)
    err_o, limit_ratio, ok = check_o(out.reshape(-1, t, hd), want,
                                     torch.bfloat16)
    ok = ok and out.shape == q.shape and out.dtype == torch.bfloat16
    wrapper_ms = time_ms(lambda: fa.flash_attention(
        q, k, v, causal=True, block_q=blk, block_k=blk))
    rec = {"phase": "kernel", "case": "main_model_views", "dtype": "bfloat16",
           "shape": {"B": b, "H": h, "T": t, "hd": hd, "causal": True,
                     "layout": "[B, T, H, hd] viewed [B, H, T, hd]"},
           "max_abs_err": err_o, "err_over_limit": limit_ratio,
           "wrapper_ms": wrapper_ms, "card": card, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"flash_attention on the model's views "
                             f"disagrees with its twin: {rec}")
    return rec


def reset_launches():
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
    flash_attention.launches = 0
    flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0


def read_launches():
    """(forward, dQ, dK/dV) launch counts."""
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches)


def phase_slice(card):
    import dataclasses
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, params_from_numpy)
    from deeplearning4j_tpu_torch.serving import InferenceServer

    conf = TransformerConfig(**SLICE)
    t = conf.max_len
    lm = TransformerLM(conf, device=DEVICE).init()
    srv = InferenceServer(lm, buckets=(BUCKET,), device=DEVICE)
    t0 = time.perf_counter()
    srv.warm_start([(t,)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    rng = np.random.RandomState(SEED)
    rows = [rng.randint(0, conf.vocab_size, t).astype(np.int32)
            for _ in range(N_REQUESTS)]
    batches = []                               # (tokens, logits) per call
    served_output = lm.output

    def recording_output(x):
        y = served_output(x)
        batches.append((x, y))
        return y
    lm.output = recording_output

    obs.reset_metrics()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # the main path starts here
    t0 = time.perf_counter()

    def client(x):
        t_sub = time.perf_counter()
        y = srv.infer(x, timeout=600)
        return y, time.perf_counter() - t_sub
    with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
        served, client_s = zip(*pool.map(client, rows))
    wall = time.perf_counter() - t0
    launches, *bwd_launches = read_launches()  # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    n_batches = obs.metrics.value("serve.batches_total")
    lat = obs.metrics.histogram("serve.request_seconds")
    srv.stop()
    del lm.output                              # back to the class method

    assert launches == conf.n_layers * n_batches > 0, \
        (launches, conf.n_layers, n_batches)
    assert bwd_launches == [0, 0], bwd_launches   # inference: no backward
    max_served_err = 0.0
    for x, y in batches:
        again = lm.output(x)                   # same weights, same shapes
        max_served_err = max(max_served_err, float(np.abs(again - y).max()))
    for tok, got in zip(rows, served):
        assert got.shape == (t, conf.vocab_size) and np.isfinite(got).all()
        hits = [y[j] for x, y in batches for j in range(len(x))
                if np.array_equal(x[j], tok)]
        assert hits, "a served row came from no dispatched batch"
        max_served_err = max(max_served_err,
                             float(np.abs(got - hits[0]).max()))
    assert max_served_err <= 1e-6, max_served_err
    breakdown = output_breakdown(lm, batches[0][0], n_batches, wall)
    del batches, served

    # f32 on the card against the same weights on the CPU (plain twin)
    c32 = dataclasses.replace(conf, compute_dtype=None)
    lm32 = TransformerLM(c32, device=DEVICE)
    lm32.params = lm.params
    cpu = TransformerLM(c32, device="cpu")
    cpu.params = params_from_numpy(_numpy_tree(lm.params), "cpu")
    row = rows[0][None]
    gpu_logits = lm32.output(row)
    cpu_logits = cpu.output(row)
    cpu_gpu_err = float(np.abs(gpu_logits - cpu_logits).max())
    assert np.isfinite(gpu_logits).all() and cpu_gpu_err <= CPU_GPU_TOL, \
        cpu_gpu_err

    rec = {"phase": "slice", "config": SLICE, "bucket": BUCKET,
           "requests": N_REQUESTS, "tokens_per_request": t,
           "batches": n_batches, "kernel_launches": launches,
           "launches_per_batch": launches / n_batches,
           "warm_start_s": warm_s, "wall_s": wall,
           "requests_per_s": N_REQUESTS / wall,
           "tokens_per_s": N_REQUESTS * t / wall,
           "request_seconds_p50": lat.quantile(0.5),
           "request_seconds_p99": lat.quantile(0.99),
           "request_seconds_max": lat.summary().get("max"),
           # exact, from the clients' clocks (the histogram interpolates
           # within its buckets)
           "client_seconds_p50": float(np.percentile(client_s, 50)),
           "client_seconds_p99": float(np.percentile(client_s, 99)),
           "output_seconds": obs.metrics.histogram(
               "infer.output_seconds").summary(),
           "peak_memory_bytes": peak_bytes,
           "served_vs_output_max_abs_err": max_served_err,
           "f32_card_vs_cpu_max_abs_err": cpu_gpu_err,
           "output_breakdown": breakdown,
           "num_params": lm.num_params(), "card": card}
    emit(rec)
    return rec


def train_breakdown(lm, batch):
    """One more step of ``fit_batch``'s work, split by CUDA events into
    the forward (loss), the backward (``torch.autograd.grad``) and the
    update (clip, AdamW, EMA), with every attention kernel launch inside
    them timed by its own pair of events. Returns (breakdown, the
    step's gradients by leaf path)."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (_flatten,
                                                             _unflatten)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    spans = {"_kernel_forward": [], "_kernel_dq": [], "_kernel_dkv": []}
    real = {name: getattr(fa, name) for name in spans}

    def timed(name):
        def call(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = real[name](*a, **kw)
            e.record()
            spans[name].append((s, e))
            return out
        return call
    toks, tgts = batch[:, :-1], batch[:, 1:]
    leaves = _flatten(lm.params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for name in spans:
        setattr(fa, name, timed(name))
    try:
        torch.cuda.synchronize()
        ev[0].record()
        loss = lm._loss(lm.params, toks, tgts, None)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[2].record()
        lm._apply_update(_unflatten(dict(zip(leaves, grads))))
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(fa, name, fn)

    def total(name):
        return sum(s.elapsed_time(e) for s, e in spans[name])
    out = {"forward_ms": ev[0].elapsed_time(ev[1]),
           "attention_forward_ms": total("_kernel_forward"),
           "attention_forward_launches": len(spans["_kernel_forward"]),
           "backward_ms": ev[1].elapsed_time(ev[2]),
           "attention_backward_ms": total("_kernel_dq")
           + total("_kernel_dkv"),
           "attention_dq_ms": total("_kernel_dq"),
           "attention_dkv_ms": total("_kernel_dkv"),
           "attention_backward_launches": len(spans["_kernel_dq"])
           + len(spans["_kernel_dkv"]),
           "update_ms": ev[2].elapsed_time(ev[3]),
           "loss": float(loss.detach())}
    return out, dict(zip(leaves, grads))


def train_card_vs_cpu(conf, rng):
    """One f32 step's loss and gradients of a 2-layer copy of the model
    at full width, T ``CPU_CHECK_T``, batch 2: on the card (the kernels)
    and on the CPU (their twins), from the same weights."""
    import dataclasses
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerLM, _flatten, params_from_numpy)

    c2 = dataclasses.replace(conf, n_layers=2, compute_dtype=None)
    card = TransformerLM(c2, device=DEVICE).init()
    cpu = TransformerLM(c2, device="cpu")
    cpu.params = params_from_numpy(_numpy_tree(card.params), "cpu")
    toks = torch.from_numpy(rng.randint(0, c2.vocab_size,
                                        (2, CPU_CHECK_T + 1)))
    before = read_launches()
    got_loss, got = card._value_and_grad(toks[:, :-1].to(DEVICE),
                                         toks[:, 1:].to(DEVICE), None)
    torch.cuda.synchronize()
    after = read_launches()
    want_loss, want = cpu._value_and_grad(toks[:, :-1], toks[:, 1:], None)
    # each layer launched the forward and both backward kernels once
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2], \
        (before, after)
    got, want = _flatten(got), _flatten(want)
    rel = {k: ((got[k].cpu() - w).abs().max()
               / w.abs().max().clamp(min=1e-30)).item()
           for k, w in want.items()}
    loss_err = abs(float(got_loss) - float(want_loss))
    worst = max(rel, key=rel.get)
    assert loss_err <= TRAIN_LOSS_TOL and rel[worst] <= TRAIN_GRAD_RTOL, \
        (loss_err, worst, rel[worst])
    return {"config": {"n_layers": 2, "d_model": c2.d_model,
                       "T": CPU_CHECK_T, "batch": 2, "dtype": "float32"},
            "loss_card": float(got_loss), "loss_cpu": float(want_loss),
            "loss_abs_err": loss_err, "grad_max_rel_err": rel[worst],
            "grad_worst_leaf": worst}


def phase_train(card):
    import math
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import hw
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)

    conf = TransformerConfig(**SLICE)
    t = conf.max_len
    lm = TransformerLM(conf, device=DEVICE).init()
    rng = np.random.RandomState(SEED + 1)
    batch = torch.from_numpy(rng.randint(0, conf.vocab_size,
                                         (TRAIN_BATCH, t))).to(DEVICE)
    warm = [float(lm.fit_batch(batch)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # the main path starts here
    t0 = time.perf_counter()
    scores = [lm.fit_batch(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dq_launches, dkv_launches = read_launches()   # ... ends
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = warm + [float(x) for x in scores]

    per_step = conf.n_layers * TRAIN_STEPS
    assert (launches, dq_launches, dkv_launches) == (per_step,) * 3, \
        (launches, dq_launches, dkv_launches)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses     # one fixed batch: it falls
    breakdown, grads = train_breakdown(lm, batch)
    assert breakdown["attention_backward_launches"] == 2 * conf.n_layers
    zero = [k for k, g in grads.items()
            if not (bool(torch.isfinite(g).all()) and g.abs().max() > 0)]
    assert not zero, f"leaves with no gradient: {zero}"
    n_leaves = len(grads)
    del grads

    tokens = TRAIN_BATCH * (t - 1)             # next-token targets
    tokens_per_s = tokens * TRAIN_STEPS / wall
    flops_per_token = hw.TRAIN_FLOPS_MULTIPLIER * \
        hw.transformer_fwd_flops_per_token(t, conf.d_model, conf.n_layers,
                                           conf.d_ff, conf.vocab_size)
    rec = {"phase": "train", "config": SLICE, "batch": TRAIN_BATCH,
           "tokens_per_row": t, "warmup_steps": TRAIN_WARMUP,
           "timed_steps": TRAIN_STEPS, "losses": losses,
           "wall_s": wall, "step_ms": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token,
           "mfu_vs_bf16_peak": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S["bfloat16"],
           "kernel_launches": {"flash_attn_fwd": launches,
                               "flash_attn_dq": dq_launches,
                               "flash_attn_dkv": dkv_launches},
           "peak_memory_bytes": peak_bytes, "step_breakdown": breakdown,
           "leaves_with_nonzero_gradient": n_leaves,
           "num_params": lm.num_params(), "card": card}
    del lm, batch
    torch.cuda.empty_cache()
    rec["f32_card_vs_cpu"] = train_card_vs_cpu(conf, rng)
    emit(rec)
    return rec


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the port must be the checkout's own, beside this script, never a
    # copy found elsewhere on the path
    pkg = Path(__file__).resolve().parent / "deeplearning4j_tpu_torch"
    if not (pkg / "__init__.py").is_file():
        print(f"chip_smoke: the port package is missing beside this "
              f"script ({pkg})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pkg.parent))
    # parity phases compare in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    phase_build(card)
    kernels = phase_kernels(card)
    sl = phase_slice(card)
    tr = phase_train(card)

    # each kernel at the train path's shape (the main path of this slice)
    fwd = kernels[("train", "bfloat16")]
    bwd = kernels[("train", "bfloat16", "bwd")]
    src = "deeplearning4j_tpu_torch/csrc/"
    ref = "deeplearning4j_tpu/ops/pallas_kernels.py:"
    launches = tr["kernel_launches"]
    emit({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": src + "flash_attn_fwd.cu", "replaces": ref + "73",
         "launches": launches["flash_attn_fwd"],
         "launches_serve": sl["kernel_launches"],
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["kernel_ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"]},
        {"name": "flash_attn_dq", "route": "cuda",
         "source": src + "flash_attn_dq.cu", "replaces": ref + "185",
         "launches": launches["flash_attn_dq"],
         "max_abs_err": bwd["errors"]["dq"]["max_abs_err"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
         "library_ms": bwd["library_bwd_ms"]},
        {"name": "flash_attn_dkv", "route": "cuda",
         "source": src + "flash_attn_dkv.cu", "replaces": ref + "235",
         "launches": launches["flash_attn_dkv"],
         "max_abs_err": max(bwd["errors"][g]["max_abs_err"]
                            for g in ("dk", "dv")),
         "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["dkv_bound_ms"], "bound_by": bwd["dkv_bound_by"],
         "library_ms": bwd["library_bwd_ms"]},
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
