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
   edge shapes (T 1, T 65, d 36, a q view with a storage offset, and d
   256, the widest the kernels take, with GQA 2): the
   forward, and the two backward kernels (dQ, dK/dV) against the plain
   backward, each with its time, the twin's, one PyTorch library call's
   (a yardstick the port never calls) and the least time the card could
   take; and the public wrapper on bf16 q/k/v laid out as the model hands
   them over. In bf16 all three flash kernels run on the tensor cores
   (mma.sync, cp.async) and round P, Pᵀ, dSᵀ and dS to bf16 before their
   products: they are held to the bars of ``ops/flash_attention.py``
   (``BF16_O_BAR``, ``BF16_DKV_BAR``, ``BF16_DQ_BAR``) against the twin's
   unrounded f32 result, with the old one-bf16-step ratio and the error
   of PyTorch's ``scaled_dot_product_attention`` against the same f32
   twin printed beside (anchors, not gates); f32 keeps its 1e-5 bars. The
   build phase shows from ptxas that each flash source holds a
   tensor-core kernel per head dim and CUDA-core kernels for float only,
   and from the machine code (cuobjdump) that only the bf16 kernels issue
   tensor-core instructions (HMMA); then the LSTM kernels against their
   twins: the sequence kernel (a layer's whole tBPTT window in one
   launch) at the char-RNN's window (T 50, B 32, H 200, peepholes, f32)
   and at edge cases (no peepholes, B 1, T 7 x B 7 x H 37, T 8 x B 64 x
   H 1024, a masked window walked in reverse, and T 1 in f32 and bf16,
   the generation step), and the cell backward at each case's step, with
   cuDNN's LSTM over the same window (another function: no peepholes) as
   a yardstick; each call's CUDA kernels are counted by
   ``torch.profiler`` (one each), and both kernels are shown
   bit-identical from call to call and under CUDA-graph replay;
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
   card and on the CPU from the same weights, which must agree;
5. charrnn — ``zoo.char_rnn`` at full width (vocab 77, hidden 200, tBPTT
   50; rmsprop at lr 0.01) trains through ``MultiLayerNetwork.fit`` on
   batches of 32 x 200 characters of a seeded Markov chain: 2 warm-up and
   8 timed batches, in four turns from the same parameters: the fused
   loop at its default K 8 (the main path: the prefetcher stacks the 8
   batches into one group, and each tBPTT window's whole train step is
   one captured CUDA graph, replayed), the per-batch loop
   (``DL4J_TORCH_FUSE_STEPS=1``) twice, the fused loop again. The fused
   turns must capture one graph (one window signature), in the warm-up,
   and call no kernel wrapper in the timed run (every window a replay);
   the main path's timed run is profiled, and ``torch.profiler`` must
   count the LSTM sequence kernel 8 times a batch (2 layers x 4 windows)
   and the backward kernel 400 times (2 layers x 200 steps) in it, as
   the per-batch turns' wrapper calls and a profile of two more
   per-batch batches must; no flash kernel runs; every parameter leaf
   must get a finite, non-zero gradient in every window of the per-batch
   run and in the fused group's last window, and the loss must fall. It
   reports characters/s, ms per batch and per window of each turn, the
   parameters' largest difference between the turns after the same
   batches, the busy share of each path, a window graph's replay time, a
   per-batch window split by CUDA events, and peak memory. Then
   ``output()`` on a batch, 200 ``rnn_time_step`` calls generating
   characters (one sequence launch of T 1 a layer a character; their
   outputs must equal ``output()`` of the same sequence), and one f32
   window of a fresh copy on the card and on the CPU from the same
   weights, which must agree;
6. lenet — ``zoo.lenet_mnist`` at full width (28x28x1; conv 5x5x20,
   max-pool 2, conv 5x5x50, max-pool 2, dense 500, softmax 10; 431,080
   parameters; Nesterov momentum 0.9, lr 0.01) on real MNIST digits
   (``tests/fixtures/real_mnist`` through ``MnistDataSetIterator``):
   (1) the fixture's 320 training digits tiled to 160 batches of 128
   (bench.py's N) through ``fit()`` after 4 warm-up batches, in four
   turns from the same parameters: fused (K 8, the main path: one
   captured graph a whole batch step, replayed; its timed run is
   profiled, and the counts of the package's five kernels, set to 0
   just before it, must read 0 after: convolution, pooling and the GEMMs
   are PyTorch's), per-batch, per-batch, fused; images/s, ms a batch,
   graphs captured, the busy share and the top device ops, peak memory,
   the parameters' largest difference between the turns; and the fused
   loop against the per-batch loop over 16 batches, bitwise (under
   ``cudnn.deterministic`` if the defaults differ); (2) a fresh net, 40
   epochs at batch 64 (shuffle seed 5), must reach the reference's bars:
   held-out accuracy >= 0.90 and pooled >= 0.97; (3) a narrow LeNet with
   a BatchNormalization after each conv takes one f32 step on the card
   and on the CPU from the same weights (loss, gradients and running
   moments within the train phase's bars), and a max-pool over a blank
   image routes its tied gradients alike on both; (4) the learned net,
   written with ``write_model``, restored on the card gives the same
   output bits on the 64 held-out digits (on the CPU within
   CPU_GPU_TOL), and the reference's two committed archives restore on
   the card to their recorded outputs within 1e-5; (5) 2 epochs of 20
   batches with a checkpoint every 8 updates, and a fresh net resumed
   from the first checkpoint, must end with the same parameters, bitwise
   (under ``cudnn.deterministic`` if the defaults differ);
7. resnet50 — ``zoo.resnet50()`` at full width (224x224x3, 1000 classes,
   25,557,032 parameters; bf16 compute, f32 masters; nesterovs 0.9, lr
   0.1) as a ComputationGraph through ``fit(iterator)`` (per batch: the
   fused loop declines graphs), on seeded normal images and one-hot
   labels as bench.py's ``_resnet_throughput`` makes them (3 pre-made
   batches, cycled): at batch 128 and again at 256, 3 warm-up and 15
   timed batches each (host clock ending in a synchronise), with the
   package's kernel counts set to 0 just before the timed run and read
   just after (0: convolution, BatchNormalization, pooling and the dense
   head are PyTorch's); images/s, ms a batch, MFU on bench.py's basis
   (4.09 GFLOP an image forward, x3, against the 989 TFLOP/s bf16 peak),
   peak memory, every step's score (finite) and the guard's reverted
   steps (0); 4 more batches at 128 under ``torch.profiler`` give the
   busy share, the top device ops and the pageable host-to-device copies'
   device time. Then the net of batch 256, written and restored on the
   card, gives the same output bits; the narrow ResNet (two stages of one
   block, 32x32) and GoogLeNet (67x67, its head's dropout off) take 3
   ``fit`` steps on the card and on the CPU from the same f32 parameters,
   the ResNet in f32 (outputs, parameters and BN moments within
   CNN_CARD_CPU_RTOL), GoogLeNet, whose f32 gradient is not continuous
   (a ReLU input that rounds across 0, or a max-pool window's largest
   entry that changes, sends a gradient elsewhere), in
   float64 compute (within CNN_F64_STEPS_RTOL; its f32 forward within
   CNN_CARD_CPU_RTOL, its f32 steps printed beside with the ReLU units
   and max-pool windows that took another branch before each); the
   narrow ResNet resumed from a checkpoint equals its uninterrupted run
   bitwise (under ``cudnn.deterministic`` if the defaults differ, which
   it then prints); and the char-RNN's chain built with ``GraphBuilder``
   takes 4 batches by ``fit_batch`` against the MultiLayerNetwork's
   per-batch path from the same parameters: the same parameter bits and
   the same LSTM kernel launches (by ``torch.profiler`` and by the
   wrappers), which the ``kernels`` line carries as ``launches_cg``;
8. decode — generation serving, every program a captured CUDA graph:
   (1) bench.py's ``bench_serve`` uncut (V 2048, max_len 256, d 256, L 4,
   H 4, ff 1024, f32; 16 slots, chunk 8; 64 requests of 8/16/24/32
   tokens from ``default_rng(0)``, n_new 32, greedy): serial
   ``generate()`` after one warm call per prompt length, then
   ContinuousLM after ``warm_start`` and 2 warm requests; tokens/s of
   both and their ratio beside bench.py's 1.5 bar, request and TTFT
   p50/p99, mean occupancy, the graph inventory (it must equal
   3 x KV rungs + 2 x prefill rungs + 1) and the graphs captured in the
   timed runs (0), the package's kernel counts (0: decode attention is
   dense, as in the reference), and token equality between the arms;
   (2) its long-prompt arm uncut (max_len 512; 8 slots; 16 prompts of
   400 tokens sharing 256, ``default_rng(1)``; bursts at n_new 1 and
   32): ladders off without a prefix cache against the prefill ladder
   (16, 64) with the default cache: TTFT p50/p99, tokens/s, prefix hits
   and misses, the inventory against its budget; (3) the slice phase's
   LM at full width (bf16 compute, so a bf16 KV pool; 42,259,456
   parameters) behind ContinuousLM at 16 slots, chunk 8, 32 requests of
   64-token prompts, n_new 64: tokens/s, ms a decode dispatch, peak
   memory, a profile of 5 dispatches (busy share, top device ops), token
   equality with ``generate(temperature=0)`` on the card, and one
   ``beam_search(beams=4)`` (its first call captures, the second
   replays); (4) a narrow f32 model on the card against the same weights
   on the CPU: greedy tokens, and one decode step's logits from one
   state within CPU_GPU_TOL; (5) one sampled request (temperature 1,
   top_k 50, top_p 0.9, seed 7) alone and inside a mixed pool (one KV
   rung, so both attend over one window shape): the same tokens. Every
   greedy split between two paths is reported with the top-2 gap of the
   logits at its first differing position and the paths' logits
   difference there, and fails unless the gap lies under the bar
   (CPU_GPU_TOL for f32, BF16_LOGITS_BAR for bf16) and under that
   difference: a rounding tie;
9. serve_scale — bench.py's ``_bench_serve_scale_pinned`` uncut: two
   ContinuousLM replicas of the bench_serve model (8 slots, chunk 8)
   behind ``ReplicaRouter``, both warm-started (each captures its own
   inventory; the weights are shared, never copied): a steady 4-client
   open loop of 32 requests (n_new 16; tokens/s, p50/p99, graphs
   captured 0) and a profiled burst (kernel overlap between the
   replicas); three ``/v1/generate`` requests through ``ServingIngress``
   on 127.0.0.1, plain and streamed, equal to a direct submit; replica 0
   killed (``kill-replica[0]@0``) under a burst of 24: done and dead
   (``ServeReplicaDeadError``) counts, the resolved fraction against
   bench.py's bar 1.0, failover seconds, graphs captured in recovery 0,
   and no dead request submitted again; an overload past a 10 ms SLO
   through a second router with its heartbeat parked (429 count, the
   admitted p99); then the slice's LM in bf16 behind two replicas of 16
   slots, 32 requests and a burst of 32 with replica 0 killed. Every
   completed greedy row is held to ``generate()`` of its prompt on the
   card (rounding ties only), and no serving thread may be left;
10. word2vec — bench.py's ``bench_word2vec`` uncut (a 2M-word Zipf
   corpus over 30k words, d 100, window 5, negative 5, sampling 1e-3,
   min count 5, batch 32,768, seed 42) for each scatter route
   (``sorted``, ``fused``, ``two``): warm-up fits capture every chunk
   bucket, then two timed fits from the same seed: words/s against
   bench.py's bar (500,000), graphs captured 0, peak memory, syn0
   finite, the ``sorted`` route's tables the same bits; a profile of one
   ``sorted`` fit; and a small hierarchical-softmax fit on the card
   against the CPU (W2V_CARD_CPU_RTOL);
11. order_check — the narrow ResNet's f32 check of phase ``resnet50``
   again, after phases ``decode``, ``serve_scale`` and ``word2vec``.

Every line before the last is a JSON object or the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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
# The one-bf16-step bar: a bf16 result against the twin's result rounded to
# bf16, |err| <= BF16_ATOL + BF16_RTOL |want| element by element (two
# roundings of nearly equal f32 values land at most one bf16 step apart,
# and a step is at most 2^-7 |want|). The CUDA-core LSTM cell kernels are
# held to it. The bf16 flash kernels run on the tensor cores and round P,
# Pᵀ, dSᵀ and dS to bf16 before their products, so they are held to the
# bars derived in ops/flash_attention.py against the twin's unrounded f32
# result (BF16_O_BAR, BF16_DKV_BAR, BF16_DQ_BAR); their one-step ratio is
# printed beside, not gated.
BF16_ATOL, BF16_RTOL = 1e-5, 2.0 ** -7
CPU_GPU_TOL = 1e-4  # f32 logits, CPU vs card, eight layers deep
# backward kernels: f32 dq/dk/dv within 1e-5 of each gradient's max abs
# (summation order only); bf16 within one bf16 step at the gradient's scale
# of its unrounded f32 result (BF16_DQ_BAR, BF16_DKV_BAR)
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

# kernel cases: (name, n q-heads, kv-heads, T, d, causal, window, q with
# a storage offset)
KERNEL_CASES = [
    ("main", 64, 64, 512, 64, True, None, False),    # 8 requests x 8 heads
    ("gqa2_window24_T500", 64, 32, 500, 64, True, 24, False),
    ("d16", 64, 64, 512, 16, True, None, False),
    ("d128", 32, 32, 512, 128, True, None, False),
    # edges of the tensor-core kernels: one key, a second tile of one row,
    # rows of 72 bytes (not on 16-byte boundaries), a q view one element
    # into its storage
    ("t1", 8, 8, 1, 64, True, None, False),
    ("t65", 16, 16, 65, 64, True, None, False),
    ("d36", 16, 16, 300, 36, True, None, False),
    ("q_offset", 16, 16, 512, 64, True, None, True),
    # the train phase's attention: 32 rows x 8 heads, T = 512 - 1
    ("train", 256, 256, 511, 64, True, None, False),
    # the widest head dim the kernels take (their DP 256 instances), GQA 2
    ("d256", 16, 8, 512, 256, True, None, False),
]
# what the kernels line says of the bf16 flash kernels and the LSTM
# kernels
TC_DESIGN = "mma.sync bf16 tensor cores, cp.async"
LSTM_FWD_DESIGN = ("one persistent cooperative launch a tBPTT window: T steps "
                   "in a loop, RW slice resident in shared memory, c in "
                   "registers, h exchanged through L2 behind per-batch-tile "
                   "arrival counters")
LSTM_BWD_DESIGN = "one cooperative launch, two phases split by a grid sync"

# the char-RNN phase: bench.py's full-width sizing of zoo.char_rnn
CHARRNN = dict(vocab_size=77, hidden=200, tbptt_length=50, batch=32,
               seq_len=200, learning_rate=0.01)
CHARRNN_WARMUP = 2
CHARRNN_BATCHES = 8
CHARRNN_GENERATE = 200     # rnn_time_step calls
# LSTM kernel cases: (name, T, B, H, peepholes, dtype, masked, reverse);
# "main" is the char-RNN's layer window, "t1" its generation step; the
# backward kernel runs at each case's step (zx_t[0], h0, c0)
LSTM_CASES = [
    ("main", 50, 32, 200, True, "float32", False, False),
    ("no_peephole", 50, 32, 200, False, "float32", False, False),
    ("bf16", 1, 32, 200, True, "bfloat16", False, False),
    ("b1", 50, 1, 200, True, "float32", False, False),
    ("ragged", 7, 7, 37, True, "float32", False, False),
    ("wide", 8, 64, 1024, True, "float32", False, False),
    ("masked_reverse", 50, 32, 200, True, "float32", True, True),
    ("t1", 1, 32, 200, True, "float32", False, False),
]
# f32 h/c of one step within 1e-6 abs up to H 200 (summation order only),
# and 1e-6 sqrt(H / 200) beyond: the rounding of the H-term dot products
# grows with the square root of their length (c also reaches |c| ~ 4
# there); a window's out, h and c within F32_WINDOW_TOL (ops/lstm_cell.py,
# derived from the twin's own rounding over the window), with the same
# growth beyond H 200; f32 gradients within 1e-5 of each output's max abs
LSTM_FWD_TOL, LSTM_BWD_RTOL = 1e-6, 1e-5
# stepwise rnn_time_step against output() of the same sequence: f32
# probabilities, the input projection taken at another batch shape
RNN_STEP_TOL = 1e-5

# the LeNet phase: bench.py's bench_lenet sizing of zoo.lenet_mnist
# (batch 128, N 160 batches, 4 warm-up batches), on the fixture's real
# digits tiled to N; the learning run is the reference's real-MNIST gate
LENET_BATCH = 128
LENET_WARMUP = 4
LENET_BATCHES = 160
LENET_LEARN = dict(epochs=40, batch=64, shuffle_seed=5)
LENET_HELD_OUT_BAR, LENET_POOLED_BAR = 0.90, 0.97
LENET_RESUME = dict(epochs=2, batches=20, every=8)
MNIST_FIXTURE = ("tests", "fixtures", "real_mnist")
CKPT_FIXTURES = ("tests", "fixtures", "checkpoints")
ARCHIVE_TOL = 1e-5   # the reference archives' recorded outputs
# one f32 window, card against CPU: loss 1e-5 abs; each updated parameter
# leaf within 1e-4 of its max abs
CHARRNN_LOSS_TOL, CHARRNN_PARAM_RTOL = 1e-5, 1e-4

# the ResNet-50 phase: bench.py:_resnet_throughput's configuration
# (zoo.resnet50() at 224x224x3, 1000 classes, bf16 compute, f32 masters)
# through fit(iterator) at batches 128 and 256, on seeded normal images
# and one-hot labels (a few pre-made batches, cycled)
RESNET_FULL = dict(n_classes=1000, height=224, width=224, channels=3,
                   stages=(3, 4, 6, 3))        # zoo.resnet50()'s defaults
RESNET_BATCHES = (128, 256)
RESNET_WARMUP = 3
RESNET_TIMED = 15
RESNET_PREMADE = 3
RESNET_PROFILED = 4         # batches of a separate profiled turn (128)
RESNET_PARAMS = 25557032    # tests/test_zoo.py
RESNET_FWD_FLOPS = 4.09e9   # an image forward (bench.py's MFU basis)
# card against CPU, f32 with TF32 off, 3 fit steps from the same
# parameters: cuDNN and the CPU sum each conv's products in another order,
# and every BatchNormalization divides by its batch's spread, which
# carries a difference on to the layers above; outputs, parameters and
# running variances within 1e-4 of each leaf's max abs (the train phase's
# gradient bar), running means within 1e-4 of the larger of their max abs
# and the data's spread (the square root of the running variance)
CNN_CARD_CPU_RTOL = 1e-4
# GoogLeNet's gradient is not continuous in f32: a ReLU output that is a
# max-pool window's only positive entry can round to 0 on one device and
# not on the other, and the window's whole gradient then goes elsewhere;
# so can any ReLU unit whose input rounds across 0 (the phase counts both
# before each f32 step: ``f32_decision_flips_by_step``). So its 3 steps compute in float64 on both devices (through
# compute_dtype; f32 masters), where both take the same ReLU and
# max-pool decisions: the loss itself stays f32 (the preouts go back to
# f32, as under bf16), so each gradient is a few f32 steps apart, and so
# is the f32 nesterovs update (FMA contraction on the card); after 3
# updates within 1e-6 of each leaf's max abs. Its f32 forward is held to
# CNN_CARD_CPU_RTOL, and its f32 steps are run and printed beside, not
# gated.
CNN_F64_STEPS_RTOL = 1e-6
RESNET_NARROW = dict(n_classes=5, height=32, width=32, stages=(1, 1))
GOOGLENET_NARROW = dict(n_classes=4, height=67, width=67)
RESNET_RESUME = dict(epochs=2, batches=6, batch=16, every=4)
CG_RNN_BATCHES = 4
# the decode phase: bench.py's bench_serve (bench.py:865-866) and its
# long-prompt arm (bench.py:763-764), uncut; the slice phase's LM behind
# ContinuousLM; a narrow f32 model on the card and the CPU
SERVE_BENCH = dict(model=dict(vocab_size=2048, max_len=256, d_model=256,
                              n_layers=4, n_heads=4, d_ff=1024, seed=SEED),
                   slots=16, chunk=8, requests=64, n_new=32,
                   prompts=(8, 16, 24, 32))
SERVE_LONG = dict(model=dict(vocab_size=2048, max_len=512, d_model=256,
                             n_layers=4, n_heads=4, d_ff=1024, seed=SEED),
                  slots=8, chunk=8, requests=16, n_new=32, prompt=400,
                  shared=256, prefill_ladder=(16, 64))
SERVE_FULL = dict(slots=16, chunk=8, requests=32, prompt=64, n_new=64)
SERVE_NARROW = dict(model=dict(vocab_size=512, max_len=64, d_model=64,
                               n_layers=2, n_heads=4, d_ff=256, seed=SEED),
                    rows=4, prompt=12, n_new=24)
SERVE_BASE = 1.5          # bench.py's BASES["serve"]
SLICE_PARAMS = 42259456
# a greedy split between a one-row and a slot-pool bf16 run counts as a
# rounding tie when the top-2 gap is under this: bf16 rounds a logit of
# ~0.3 to ~1e-3, and eight layers of 1-ulp activation differences move
# the logits by ~1e-2
BF16_LOGITS_BAR = 0.05
# the serve_scale phase: bench.py:_bench_serve_scale_pinned uncut
# (bench.py:1000-1002): two ContinuousLM replicas of the bench_serve model
# behind ReplicaRouter, a 4-client open loop, a kill under a burst of 24,
# an overload past a 10 ms SLO; then the slice's LM at full width behind
# two replicas of 16 slots
SERVE_SCALE = dict(model=dict(vocab_size=2048, max_len=256, d_model=256,
                              n_layers=4, n_heads=4, d_ff=1024, seed=SEED),
                   slots=8, chunk=8, replicas=2, clients=4, per_client=8,
                   n_new=16, prompts=(8, 16), heartbeat_s=0.1, slo_ms=10.0)
SERVE_SCALE_BASE = 1.0     # bench.py's BASES["serve_scale"]
SERVE_SCALE_FULL = dict(slots=16, chunk=8, requests=32, prompt=64, n_new=32,
                        heartbeat_s=0.1)
# the word2vec phase: bench.py:bench_word2vec uncut (bench.py:623-690): a
# 2M-word Zipf corpus over a 30k vocabulary, skip-gram with negative
# sampling; every scatter route
W2V = dict(vocab=30_000, total=2_000_000, sent_len=1000, corpus_seed=0,
           layer_size=100, window=5, negative=5, sampling=1e-3,
           min_word_frequency=5, batch_size=32_768, seed=42,
           warm_sentences=(300, 10, 1))
W2V_BASE = 500_000.0       # bench.py's BASES["word2vec"], words/s
W2V_ROUTES = ("sorted", "fused", "two")
# card against CPU: a small hierarchical-softmax skip-gram fit (no device
# randomness) in f32, within the CPU test's bar against the reference
# (tests/test_torch_word2vec.py FIT_RTOL): 1e-5 of each table's max abs
W2V_SMALL = dict(vocab=500, total=40_000, sent_len=100, layer_size=32,
                 window=5, batch_size=1024, seed=7, min_word_frequency=2,
                 sampling=1e-3)
W2V_CARD_CPU_RTOL = 1e-5


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


def captured(fn, iters=1):
    """A CUDA graph of ``iters`` calls of ``fn`` (after three warm-up calls
    on a side stream), and the last captured call's outputs."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    return graph, out


def graph_ms(fn, iters=50, reps=5):
    """Device time of one ``fn`` call with the host taken out: ``iters``
    calls captured into one CUDA graph, replayed ``reps`` times between
    CUDA events. A small kernel behind a Python wrapper is otherwise timed
    at the host's pace (``time_ms`` then reads the wrapper's cost)."""
    import torch
    graph, _ = captured(fn, iters)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


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


# the flash kernels: entry point -> (the tensor-core kernel's name, the
# CUDA-core kernel's name)
TC_KERNELS = {"flash_attn_fwd": ("flash_fwd_mma_kernel", "flash_fwd_kernel"),
              "flash_attn_dq": ("flash_dq_mma_kernel", "flash_dq_kernel"),
              "flash_attn_dkv": ("flash_dkv_mma_kernel", "flash_dkv_kernel")}


def kernel_routes(name, log):
    """From ptxas's entry functions of a flash source: the tensor-core
    kernels (one per head-dim instance) and the CUDA-core ones, which must
    all be the float instances (mangled ``...kernelIf...``), so no bf16
    call can reach the CUDA cores; and from the library's machine code,
    each entry's count of tensor-core instructions (HMMA), which must be
    non-zero in every tensor-core kernel and zero in every CUDA-core one.
    None for another source or a library that was already built (no
    log)."""
    import re
    if name not in TC_KERNELS or not log:
        return None
    tc, cc = TC_KERNELS[name]
    entries = re.findall(r"entry function '([^']+)'", log)
    routes = {"bfloat16": [e for e in entries if tc in e],
              "float32": [e for e in entries if cc + "I" in e]}
    assert len(routes["bfloat16"]) == 5, (name, entries)   # DP 16 .. 256
    assert routes["float32"] and all(cc + "If" in e
                                     for e in routes["float32"]), \
        (name, entries)
    hmma = sass_hmma_counts(name)
    routes["hmma_per_entry"] = hmma
    if hmma is not None:
        assert all(hmma.get(e, 0) > 0 for e in routes["bfloat16"]), \
            (name, hmma)
        assert all(hmma.get(e, 0) == 0 for e in routes["float32"]), \
            (name, hmma)
    return routes


def sass_hmma_counts(name):
    """{entry function: HMMA instructions in its machine code} of kernel
    library ``name``, by ``cuobjdump -sass``; None where the toolkit has
    no cuobjdump."""
    import os
    import shutil
    from deeplearning4j_tpu_torch.ops import _build
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = 0
        elif current is not None and "HMMA" in line:
            counts[current] += 1
    return counts


def ptxas_usage(log):
    """{entry function: {"registers": n, "spill_store_bytes": n,
    "spill_load_bytes": n}} from ptxas's ``-v`` report of one source."""
    import re
    usage, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            usage[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            usage[entry]["spill_store_bytes"] = int(m.group(1))
            usage[entry]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage[entry]["registers"] = int(m.group(1))
    return usage


def d256_usage(logs):
    """{flash kernel: {"bfloat16": usage, "float32": usage}} of the DP 256
    instances (the tensor-core kernel and the CUDA-core float one), from
    the build's ptxas report; None where the library was already built."""
    out = {}
    for name, (tc, cc) in TC_KERNELS.items():
        usage = ptxas_usage(logs.get(name, ""))
        if not usage:
            out[name] = None
            continue
        out[name] = {dt: next(u for e, u in usage.items()
                              if kern + "I" in e and tag in e)
                     for dt, kern, tag in (("bfloat16", tc, "ILi256E"),
                                           ("float32", cc, "IfLi256E"))}
    return out


def phase_build(card):
    from deeplearning4j_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        emit({"phase": "build", "kernel": name, "ptxas": usage,
              "routes": kernel_routes(name, log)})
    d256 = d256_usage(logs)
    emit({"phase": "build", "seconds": seconds, "d256_instances": d256,
          "card": card})
    return d256


def check_o(got, want, want_f32, v, kv_group):
    """Kernel O against the twin's: (max abs error against the twin's O in
    the same dtype, the largest error over the kernel's limit, the same
    over the one-bf16-step limit, ok). f32: 1e-5 abs. bf16 (tensor
    cores): |O - O_f32| <= BF16_O_BAR (max|V| of the kv head + |O_f32|)
    against the twin's unrounded f32 O, element by element; the one-step
    ratio (BF16_ATOL + BF16_RTOL |want|) is reported, not gated."""
    import torch
    from deeplearning4j_tpu_torch.ops.flash_attention import bf16_o_limit
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        ratio = one_step = (err / F32_TOL).max().item()
    else:
        ratio = ((got.float() - want_f32).abs()
                 / bf16_o_limit(v, want_f32, kv_group)).max().item()
        one_step = (err / (BF16_ATOL + BF16_RTOL * want.float().abs())) \
            .max().item()
    return err.max().item(), ratio, one_step, ratio <= 1.0 and \
        bool(torch.isfinite(got).all())


def _offset_view(x):
    """x's values in a tensor whose data start one element into its
    storage: contiguous, but its rows are off 16-byte boundaries."""
    buf = x.new_empty(x.numel() + 1)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def sdpa(q, k, v, causal, window):
    """A call, with no arguments, of PyTorch's
    ``scaled_dot_product_attention`` on [n, T, d] q and [kv_n, T, d] k/v
    (a window as a mask built once here): the library yardstick and error
    anchor, which the port never calls. Returns O [1, n, T, d]."""
    import torch
    import torch.nn.functional as F
    n, t, _ = q.shape
    # the library's kernels assume aligned rows: a view one element into
    # its storage goes in as an aligned copy of the same values
    q4, k4, v4 = (x.clone()[None] if x.storage_offset() else x[None]
                  for x in (q, k, v))
    gqa = k.shape[0] != n
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=gqa)
    pos = torch.arange(t, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & \
        (pos[:, None] - pos[None, :] < window)
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=gqa)


def phase_kernels(card):
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, n, kv_n, t, d, causal, window, offset in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            # unit normals in f32; in bf16 the size of the serving path's
            # q/k/v (std ~0.45 after LayerNorm and a std-0.02 projection)
            std = 1.0 if dtype == torch.float32 else 0.5
            q, k, v = (std * torch.randn(s, generator=g, device=dev)
                       for s in ((n, t, d), (kv_n, t, d), (kv_n, t, d)))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            if offset:
                q = _offset_view(q)
            kw = dict(causal=causal, window=window, kv_group=n // kv_n)
            out, lse = fa._flash_forward(q, k, v, **kw)
            torch.cuda.synchronize()
            want_o, want_lse = fa.flash_attention_plain(q, k, v, **kw)
            # the twin's f32 O before its rounding to the input dtype
            want_f32, _ = fa._plain_forward(q, k, v, **kw)
            err_o, limit_ratio, one_step, ok = check_o(
                out, want_o, want_f32, v, n // kv_n)
            err_f32 = (out.float() - want_f32).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            ok = ok and err_lse <= F32_TOL
            # the anchor: the library's O against the same f32 twin
            library = sdpa(q, k, v, causal, window)
            lib_o = library()[0]
            _, lib_ratio, _, _ = check_o(lib_o, want_o, want_f32, v,
                                         n // kv_n)
            lib_err = (lib_o.float() - want_f32).abs().max().item()
            del lib_o

            kernel_ms = time_ms(lambda: fa._flash_forward(q, k, v, **kw))
            plain_ms = time_ms(lambda: fa._plain_forward(q, k, v, **kw))
            library_ms = time_ms(library)
            bound_ms, bound_by, nbytes, ops = attention_bound(
                n, kv_n, t, d, window, causal, dname)
            rec = {"phase": "kernel", "case": name, "dtype": dname,
                   "shape": {"n": n, "kv_heads": kv_n, "T": t, "d": d,
                             "causal": causal, "window": window,
                             "q_storage_offset": q.storage_offset()},
                   "design": "cuda cores" if dtype == torch.float32
                   else TC_DESIGN,
                   "max_abs_err": err_o, "err_over_limit": limit_ratio,
                   "err_over_one_step_limit": one_step,
                   "max_abs_err_vs_f32_twin": err_f32,
                   "lse_max_abs_err": err_lse,
                   "sdpa_max_abs_err_vs_f32_twin": lib_err,
                   "sdpa_err_over_limit": lib_ratio,
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


def check_grad(got, want, want_f32, bar, size):
    """A backward kernel's gradient against the plain backward's on the
    same inputs: (max abs error, the largest error over its limit, the
    same over the one-bf16-step limit, max abs error against the unrounded
    f32 result, ok). f32: 1e-5 of the gradient's max abs. bf16 (tensor
    cores): max|g - g_f32| <= ``bar`` max|g_f32| (BF16_DQ_BAR for dQ,
    BF16_DKV_BAR for dK and dV); the one-step ratio is reported, not gated.
    A gradient that cancels to f32 rounding (one key a row: its max abs at
    most GRAD_CANCEL of ``size``, its terms' size) is held to |g - g_f32|
    <= GRAD_CANCEL size instead."""
    import torch
    from deeplearning4j_tpu_torch.ops.flash_attention import GRAD_CANCEL
    scale = max(want_f32.abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs()
    err_f32 = (got.float() - want_f32).abs().max().item()
    if scale <= GRAD_CANCEL * size:
        ratio = err_f32 / (GRAD_CANCEL * size)
        one_step = (err / (BWD_F32_RTOL * scale + BF16_RTOL
                           * want.float().abs())).max().item()
    elif got.dtype == torch.float32:
        ratio = one_step = (err / (BWD_F32_RTOL * scale)).max().item()
    else:
        one_step = (err / (BWD_F32_RTOL * scale + BF16_RTOL
                           * want.float().abs())).max().item()
        ratio = err_f32 / (bar * scale)
    return err.max().item(), ratio, one_step, err_f32, ratio <= 1.0 and \
        bool(torch.isfinite(got).all())


def backward_case(card, g, name, q, k, v, out, lse, causal, window, std):
    """dQ and dK/dV kernels against ``flash_attention_bwd_plain`` on the
    same q, k, v, the forward kernel's O and lse, and a random dO; with
    their times, the plain backward's, and the backward of PyTorch's
    ``scaled_dot_product_attention`` (the forward outside the timed
    region) as the library yardstick, whose gradients' errors against the
    same f32 twin are reported as anchors."""
    import torch
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
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    o4 = sdpa(q4[0], k4[0], v4[0], causal, window)()
    lib = [x[0] for x in torch.autograd.grad(o4, (q4, k4, v4), do[None],
                                             retain_graph=True)]
    sizes = fa.bwd_term_sizes(q, k, v, out, lse, do, **kw)
    bars = {"dq": fa.BF16_DQ_BAR, "dk": fa.BF16_DKV_BAR,
            "dv": fa.BF16_DKV_BAR}
    errs = {}
    ok = True
    for gname, got, w, w32, gl, size in zip(
            ("dq", "dk", "dv"), (dq, dk, dv), want, want_f32, lib, sizes):
        err, ratio, one_step, err_f32, good = check_grad(
            got, w, w32, bars[gname], size)
        scale = w32.abs().max().item()
        lib_err = (gl.float() - w32).abs().max().item()
        errs[gname] = {"max_abs_err": err, "err_over_limit": ratio,
                       "err_over_one_step_limit": one_step,
                       "max_abs_err_vs_f32_twin": err_f32, "scale": scale,
                       "term_size": size,
                       "cancels": scale <= fa.GRAD_CANCEL * size,
                       "sdpa_max_abs_err_vs_f32_twin": lib_err,
                       "sdpa_err_over_bf16_bar": lib_err
                       / (bars[gname] * max(scale, 1e-30))}
        ok = ok and good and got.shape == w.shape and got.dtype == dtype
    del want, want_f32, lib

    dq_ms = time_ms(lambda: fa._kernel_dq(q, k, v, do, lse, delta, **kw))
    dkv_ms = time_ms(lambda: fa._kernel_dkv(q, k, v, do, lse, delta, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=5, warmup=1)
    library_ms = time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do[None], retain_graph=True))
    del o4, q4, k4, v4
    (dq_bound, dq_by, dq_bytes, dq_ops), (dkv_bound, dkv_by, dkv_bytes,
                                          dkv_ops) = backward_bounds(
        n, kv_n, t, d, window, causal, dname)
    rec = {"phase": "kernel_bwd", "case": name, "dtype": dname,
           "shape": {"n": n, "kv_heads": kv_n, "T": t, "d": d,
                     "causal": causal, "window": window,
                     "q_storage_offset": q.storage_offset()},
           "design": "cuda cores" if dtype == torch.float32 else TC_DESIGN,
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
    q3, k3, v3 = (x.reshape(-1, t, hd) for x in (q, k, v))
    want, _ = fa.flash_attention_plain(q3, k3, v3, causal=True)
    want_f32, _ = fa._plain_forward(q3, k3, v3, causal=True, window=None,
                                    kv_group=1)
    err_o, limit_ratio, one_step, ok = check_o(out.reshape(-1, t, hd), want,
                                               want_f32, v3, 1)
    ok = ok and out.shape == q.shape and out.dtype == torch.bfloat16
    wrapper_ms = time_ms(lambda: fa.flash_attention(
        q, k, v, causal=True, block_q=blk, block_k=blk))
    rec = {"phase": "kernel", "case": "main_model_views", "dtype": "bfloat16",
           "shape": {"B": b, "H": h, "T": t, "hd": hd, "causal": True,
                     "layout": "[B, T, H, hd] viewed [B, H, T, hd]"},
           "max_abs_err": err_o, "err_over_limit": limit_ratio,
           "err_over_one_step_limit": one_step, "wrapper_ms": wrapper_ms, "card": card, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"flash_attention on the model's views "
                             f"disagrees with its twin: {rec}")
    return rec


def reset_launches():
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
    from deeplearning4j_tpu_torch.ops.lstm_cell import (lstm_cell,
                                                        lstm_sequence)
    flash_attention.launches = 0
    flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0
    lstm_sequence.launches = 0
    lstm_cell.bwd_launches = 0


def read_launches():
    """(forward, dQ, dK/dV) flash-attention launch counts."""
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches)


def read_lstm_launches():
    """(sequence forward, cell backward) LSTM kernel launches."""
    from deeplearning4j_tpu_torch.ops.lstm_cell import (lstm_cell,
                                                        lstm_sequence)
    return lstm_sequence.launches, lstm_cell.bwd_launches


def lstm_bounds(t, b, h, peep, dtype_name, kept_rows):
    """Least times of one sequence call over a window of t steps and of one
    cell step's backward: each input read once and each output written
    once at the memory rate (the window reads zx_t, h0, c0, RW, P and the
    keep mask, and writes out and every step's (h, c)), against the
    products at the type's peak (2 ops per multiply-add: h_prev·RW for
    each row a step keeps, ``kept_rows`` over the window; the backward's
    recomputed z, dz·RWᵀ and h_prevᵀ·dz). Both take f32 CUDA-core rates
    for f32."""
    es = 4 if dtype_name == "float32" else 2
    p = 3 * h if peep else 0
    fwd_in = t * b * 4 * h + 2 * b * h + h * 4 * h + p
    fwd_out = t * b * h + 2 * (t + 1) * b * h
    keep_bytes = t * b if kept_rows < t * b else 0
    fwd = _bound((fwd_in + fwd_out) * es + keep_bytes,
                 kept_rows * 2 * h * 4 * h, dtype_name)
    step_in = b * 4 * h + 2 * b * h + h * 4 * h + p
    bwd_in = step_in + 2 * b * h                      # + dh, dc
    bwd_out = b * 4 * h + 2 * b * h + h * 4 * h + p   # dzx, dh, dc, dRW, dP
    bwd = _bound((bwd_in + bwd_out) * es, 3 * 2 * b * h * 4 * h, dtype_name)
    return fwd, bwd


def check_lstm(got, want, want_f32, dtype, scale_rel, fwd_tol):
    """A cell output against the twin's on the same inputs: (max abs error,
    the largest error over its limit, ok). f32: ``scale_rel`` times the
    output's max abs (forward: the absolute ``fwd_tol``, scale_rel None);
    bf16: one bf16 step of the twin's bf16 result, element by element, and
    2^-7 of the output's max abs against the twin's unrounded f32 result."""
    import torch
    scale = want_f32.abs().max().item()
    err = (got.float() - want.float()).abs()
    base = fwd_tol if scale_rel is None else scale_rel * scale
    ok_f32 = True
    if dtype == torch.float32:
        limit = torch.full_like(err, base)
    else:
        limit = base + BF16_RTOL * want.float().abs()
        ok_f32 = (got.float() - want_f32).abs().max().item() <= \
            BF16_RTOL * max(scale, 1e-30)
    ratio = (err / limit).max().item()
    return err.max().item(), ratio, ratio <= 1.0 and ok_f32 and \
        bool(torch.isfinite(got).all())


def cuda_kernels_of_one_call(fn, tries=5):
    """Names of the CUDA kernels one ``fn()`` call launches, by
    ``torch.profiler`` (after a warm-up call outside the profile). A
    profile that recorded no device event at all saw nothing (its device
    tracing did not start, as seen in a run of the card tests) and is
    taken again, up to ``tries`` times; [] if none recorded anything."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            return names
    return []


def graph_replayed(fn):
    """``fn()``'s outputs from a CUDA graph that captured one call,
    replayed twice."""
    import torch
    graph, out = captured(fn)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return out


def lstm_case(card, g, name, t, b, h, peep, dtype, masked, reverse):
    """The sequence kernel over one window and the backward kernel at the
    window's first step against their twins, with times (CUDA-graph
    replay: the kernels' device time; and a wrapper call back to back,
    host included), the twins' and bounds; the CUDA kernels one call of
    each launches (torch.profiler), and whether each gives bit-identical
    results on a second call and from a replayed CUDA graph. bf16 cases
    run at T 1, where the one-step bars hold."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm_cell as lc

    dev = torch.device(DEVICE)
    dname = str(dtype).split(".")[1]

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=dev)).to(dtype)
    zx_t, hp, cp = rnd(t, b, 4 * h), rnd(b, h, std=0.5), rnd(b, h)
    rw = rnd(h, 4 * h, std=h ** -0.5)
    p = rnd(3, h, std=0.1) if peep else None
    keep = None
    if masked:   # two rows pre-padded by 10 steps, then a sixth at random
        keep = torch.rand((t, b), generator=g, device=dev) > 1 / 6
        keep[:min(t, 10), :2] = False
    dh, dc = rnd(b, h), rnd(b, h)
    seq = (zx_t, hp, cp, rw, p, keep, reverse)
    step = (zx_t[0], hp, cp, rw, p)
    got_f = lc._kernel_sequence(*seq)
    got_b = lc._kernel_backward(*step, dh, dc)
    torch.cuda.synchronize()
    want_f = lc.lstm_sequence_plain(*seq, with_states=True)
    want_b = lc.lstm_cell_bwd_plain(*step, dh, dc)

    def up(x):
        return x if x is None or not x.is_floating_point() else x.float()
    want_f32_f = want_f if dtype == torch.float32 else \
        lc.lstm_sequence_plain(*map(up, seq[:6]), reverse, with_states=True)
    want_f32_b = want_b if dtype == torch.float32 else \
        lc.lstm_cell_bwd_plain(*map(up, (*step, dh, dc)))
    fwd_tol = (LSTM_FWD_TOL if t == 1 else lc.F32_WINDOW_TOL) * \
        max(1.0, (h / 200) ** 0.5)
    errs, ok = {}, dtype == torch.float32 or t == 1
    for gname, got, want, w32, rel in (
            *[(n, a, w, w2, None) for n, a, w, w2 in zip(
                ("out", "h", "c"), got_f, want_f, want_f32_f)],
            *[(n, a, w, w2, LSTM_BWD_RTOL) for n, a, w, w2 in zip(
                ("dzx", "dh_prev", "dc_prev", "dRW", "dP"), got_b, want_b,
                want_f32_b) if w is not None]):
        err, ratio, good = check_lstm(got, want, w32.float(), dtype, rel,
                                      fwd_tol)
        errs[gname] = {"max_abs_err": err, "err_over_limit": ratio}
        ok = ok and good and got.shape == want.shape and got.dtype == \
            want.dtype
    ok = ok and (got_b[4] is None) == (p is None)
    if keep is not None:   # dropped steps emit exactly 0
        ok = ok and bool((got_f[0][~keep] == 0).all())
    del want_f, want_b, want_f32_f, want_f32_b

    def fwd():
        return lc._kernel_sequence(*seq)

    def bwd():
        return lc._kernel_backward(*step, dh, dc)

    def same(outs, ref):
        return all(torch.equal(a, o) for a, o in zip(ref, outs)
                   if a is not None)
    identical = {"fwd_repeat": same(fwd(), got_f),
                 "fwd_graph_replay": same(graph_replayed(fwd), got_f),
                 "bwd_repeat": same(bwd(), got_b),
                 "bwd_graph_replay": same(graph_replayed(bwd), got_b)}
    fwd_kernels = cuda_kernels_of_one_call(fwd)
    bwd_kernels = cuda_kernels_of_one_call(bwd)
    ok = ok and all(identical.values()) and len(fwd_kernels) == 1 and \
        len(bwd_kernels) == 1
    # the kernels' and twins' device time (graph replay), and a wrapper
    # call's cost back to back, host included
    fwd_ms = graph_ms(fwd)
    bwd_ms = graph_ms(bwd)
    fwd_call_ms = time_ms(fwd, iters=200, warmup=10)
    bwd_call_ms = time_ms(bwd, iters=200, warmup=10)
    plain_fwd_ms = graph_ms(
        lambda: lc.lstm_sequence_plain(*seq, with_states=True),
        iters=max(2, 50 // t))
    plain_bwd_ms = graph_ms(lambda: lc.lstm_cell_bwd_plain(*step, dh, dc))
    kept = t * b if keep is None else int(keep.sum())
    (fb, fby, fbytes, fops), (bb, bby, bbytes, bops) = lstm_bounds(
        t, b, h, peep, dname, kept)
    rec = {"phase": "kernel_lstm", "case": name, "dtype": dname,
           "shape": {"T": t, "B": b, "H": h, "peephole": peep,
                     "masked": masked, "reverse": reverse},
           "kept_rows": kept, "errors": errs,
           "fwd_ms": fwd_ms, "fwd_step_ms": fwd_ms / t, "bwd_ms": bwd_ms,
           "fwd_call_ms": fwd_call_ms, "bwd_call_ms": bwd_call_ms,
           "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
           "fwd_bound_ms": fb, "fwd_bound_by": fby, "fwd_bytes": fbytes,
           "fwd_ops": fops, "bwd_bound_ms": bb, "bwd_bound_by": bby,
           "bwd_bytes": bbytes, "bwd_ops": bops,
           "fwd_launches_per_call": len(fwd_kernels),
           "bwd_launches_per_call": len(bwd_kernels),
           "fwd_kernels": fwd_kernels, "bwd_kernels": bwd_kernels,
           "bit_identical": identical, "card": card, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"LSTM kernels disagree with their twins, or a "
                             f"call is not one launch or not reproducible: "
                             f"{rec}")
    return rec


def cudnn_lstm_yardstick(card):
    """The library yardstick, a different function (no peepholes, and it
    includes its own input projection): ``torch.nn.LSTM`` (cuDNN) over one
    50-step window of one layer at the char-RNN's width, forward and
    forward + backward, per step. The port never calls it."""
    import torch
    b, t, h = CHARRNN["batch"], CHARRNN["tbptt_length"], CHARRNN["hidden"]
    torch.manual_seed(SEED)
    rnn = torch.nn.LSTM(h, h, batch_first=True).to(DEVICE)
    x = torch.randn((b, t, h), device=DEVICE, requires_grad=True)
    with torch.no_grad():
        fwd = time_ms(lambda: rnn(x), iters=50, warmup=5)

    def fwd_bwd():
        out, _ = rnn(x)
        out.sum().backward()
    both = time_ms(fwd_bwd, iters=50, warmup=5)
    rec = {"phase": "kernel_lstm_library", "what": "torch.nn.LSTM (cuDNN), "
           "no peepholes, input projection included",
           "shape": {"B": b, "T": t, "n_in": h, "H": h, "dtype": "float32"},
           "window_fwd_ms": fwd, "window_fwd_bwd_ms": both,
           "per_step_fwd_ms": fwd / t, "per_step_bwd_ms": (both - fwd) / t,
           "card": card}
    emit(rec)
    return rec


def phase_lstm_kernels(card):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    results = {}
    for name, t, b, h, peep, dtype_name, masked, reverse in LSTM_CASES:
        results[name] = lstm_case(card, g, name, t, b, h, peep,
                                  getattr(torch, dtype_name), masked, reverse)
    results["library"] = cudnn_lstm_yardstick(card)
    return results


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


def markov_batches(n_batches, rng):
    """One-hot [B, T, V] batches of a seeded first-order Markov chain over
    V symbols: each symbol has three likely successors (0.6, 0.25, 0.1),
    and 5% of the mass is spread over all symbols. Returns (DataSets, the
    chain's entropy rate in nats per character: the loss floor)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    v, b, t = CHARRNN["vocab_size"], CHARRNN["batch"], CHARRNN["seq_len"]
    trans = np.full((v, v), 0.05 / v)
    for sym in range(v):
        trans[sym, rng.choice(v, 3, replace=False)] += [0.6, 0.25, 0.1]
    trans /= trans.sum(1, keepdims=True)
    cdf = trans.cumsum(1)
    eye = np.eye(v, dtype=np.float32)
    out = []
    for _ in range(n_batches):
        ids = np.empty((b, t + 1), np.int64)
        ids[:, 0] = rng.randint(0, v, b)
        for j in range(1, t + 1):
            u = rng.rand(b)[:, None]
            ids[:, j] = np.minimum((u > cdf[ids[:, j - 1]]).sum(1), v - 1)
        out.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    # stationary distribution by power iteration, then the entropy rate
    pi = np.full(v, 1.0 / v)
    for _ in range(500):
        pi = pi @ trans
    rate = float(-(pi[:, None] * trans * np.log(trans)).sum())
    return out, rate


class _WindowRecorder:
    """Keeps each window's device score and gradients (no host read)."""

    def __init__(self):
        self.scores, self.grads = [], []

    def iteration_done(self, model, iteration):
        self.scores.append(model._score)
        self.grads.append(model._last_gradients)


def charrnn_window_breakdown(net, ds):
    """One more tBPTT window (the batch's first) split by CUDA events into
    the forward (loss), the backward (``torch.autograd.grad``) and the
    update, with every LSTM kernel call inside (a sequence launch a layer
    forward, a backward launch a step) timed by its own events."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm_cell as lc

    seg = CHARRNN["tbptt_length"]
    x = net._tensor(ds.features[:, :seg])
    y = net._tensor(ds.labels[:, :seg])
    spans = {"_kernel_sequence": [], "_launch_backward": []}
    real = {name: getattr(lc, name) for name in spans}

    def timed(name):
        def call(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = real[name](*a, **kw)
            e.record()
            spans[name].append((s, e))
            return out
        return call
    carries = [l.initial_carry(x.shape[0], x.dtype, x.device)
               if hasattr(l, "initial_carry") else None for l in net.layers]
    leaves = [(i, k, v) for i, p in enumerate(net.params_list)
              for k, v in p.items()]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for name in spans:
        setattr(lc, name, timed(name))
    try:
        torch.cuda.synchronize()
        ev[0].record()
        with torch.enable_grad():
            score, (states, new_carries) = net._loss_fn(
                net.params_list, net.states_list, x, y, None, None, None,
                True, carries)
            ev[1].record()
            flat = torch.autograd.grad(score, [v for _, _, v in leaves])
        ev[2].record()
        grads = [{} for _ in net.params_list]
        for (i, k, _), g in zip(leaves, flat):
            grads[i][k] = g
        net._apply_update(score.detach(), grads, states, new_carries,
                          carries, guard=True)
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(lc, name, fn)

    def total(name):
        return sum(s.elapsed_time(e) for s, e in spans[name])
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "lstm_forward_kernel_ms": total("_kernel_sequence"),
            "lstm_forward_calls": len(spans["_kernel_sequence"]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "lstm_backward_kernel_ms": total("_launch_backward"),
            "lstm_backward_calls": len(spans["_launch_backward"]),
            "update_ms": ev[2].elapsed_time(ev[3])}


def profiled(fn, aten_rows=None):
    """``fn()`` once under ``torch.profiler``: (its wall seconds, the names
    of the run's device-side events, and ``(name, calls, device µs)`` of
    each device-side op with device time: kernels, copies, memsets). A
    CPU op's entry repeats the time of the kernels it launched, so only
    the device-side entries count. ``aten_rows``, a list, receives
    ``(aten op, calls, self device µs)`` of each host op that launched
    device work: the same time by the op that asked for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    averages = prof.key_averages()
    ops = [(e.key, e.count, device_us(e)) for e in averages
           if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    if aten_rows is not None:
        aten_rows.extend((e.key, e.count, device_us(e)) for e in averages
                         if e.key.startswith("aten::") and device_us(e) > 0
                         and not str(e.device_type).endswith("CUDA"))
    return wall, names, ops


def lstm_kernels(names):
    """(sequence, backward) LSTM kernels among a profile's device events
    (a replayed CUDA graph's kernels included)."""
    return (sum("lstm_seq_kernel" in n for n in names),
            sum("lstm_bwd_kernel" in n for n in names))


def device_share(names, ops, n_batches, ms_per_batch):
    """The card's share of a profiled run of ``n_batches`` batches: the
    device time of its ops a batch (one stream, so they do not overlap)
    against ``ms_per_batch``, the LSTM kernels and all device events a
    batch, and the ops ranked by device time."""
    busy_ms = sum(us for _, _, us in ops) / 1e3 / n_batches
    seq, bwd = lstm_kernels(names)
    top = sorted(ops, key=lambda o: o[2], reverse=True)[:8]
    return {"device_busy_ms_per_batch": busy_ms,
            "busy_share_of_timed_batch": busy_ms / ms_per_batch,
            "cuda_kernels_per_batch": {"lstm_seq_kernel": seq / n_batches,
                                       "lstm_bwd_kernel": bwd / n_batches,
                                       "all": len(names) / n_batches},
            "top_device_ops": [{"name": name[:80], "calls": calls,
                                "device_ms": us / 1e3}
                               for name, calls, us in top]}


def fused_window_graph_ms(net, reps=20):
    """Device time of one replay of the net's captured window graph, by
    CUDA events over ``reps`` replays with an all-zero example weight (the
    padding-step revert: every state stays as it was)."""
    import torch
    (win,) = net._fused.graphs.values()
    win.ew.zero_()
    win.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        win.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def charrnn_generate(net, rng):
    """``rnn_time_step`` one character at a time, sampling each next
    character from the step's output, then ``output()`` of the same
    sequence: the stepwise distributions must equal it."""
    import numpy as np
    v = CHARRNN["vocab_size"]
    eye = np.eye(v, dtype=np.float32)
    net.rnn_clear_previous_state()
    before = read_lstm_launches()
    seq, steps = [int(rng.randint(v))], []
    t0 = time.perf_counter()
    for _ in range(CHARRNN_GENERATE):
        p = net.rnn_time_step(eye[seq[-1]][None])[0]
        steps.append(p)
        seq.append(int(rng.choice(v, p=p / p.sum())))
    gen_s = time.perf_counter() - t0
    fwd, bwd = (a - b for a, b in zip(read_lstm_launches(), before))
    whole = net.output(eye[seq[:-1]][None])[0]
    err = float(np.abs(whole - np.stack(steps)).max())
    n_layers = sum(hasattr(l, "initial_carry") for l in net.layers)
    # one sequence launch of T 1 a layer a character, no backward
    assert (fwd, bwd) == (n_layers * CHARRNN_GENERATE, 0), (fwd, bwd)
    assert np.isfinite(whole).all() and err <= RNN_STEP_TOL, err
    return {"steps": CHARRNN_GENERATE, "seconds": gen_s,
            "chars_per_s": CHARRNN_GENERATE / gen_s,
            "lstm_forward_calls": fwd, "lstm_backward_calls": bwd,
            "stepwise_vs_output_max_abs_err": err,
            "distinct_chars": len(set(seq))}


def charrnn_card_vs_cpu(conf, ds):
    """One f32 tBPTT window (2 rows x 50 steps) of a fresh full-width
    char-RNN on the card (the kernels) and on the CPU (their twins) from
    the same weights: the loss and every updated parameter leaf."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    seg = CHARRNN["tbptt_length"]
    card = MultiLayerNetwork(conf, device=DEVICE).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.set_params(card.params())
    x, y = ds.features[:2, :seg], ds.labels[:2, :seg]
    before = read_lstm_launches()
    got = float(card.fit_batch(x, y))
    after = read_lstm_launches()
    want = float(cpu.fit_batch(x, y))
    n_layers = sum(hasattr(l, "initial_carry") for l in conf.layers)
    # a sequence launch a layer, a backward launch a layer a step
    assert [a - b for a, b in zip(after, before)] == \
        [n_layers, n_layers * seg], (before, after)
    rel = {}
    for i, (pg, pc) in enumerate(zip(card.params_list, cpu.params_list)):
        for k in pg:
            w = pc[k].detach().numpy()
            rel[f"{i}.{k}"] = float(np.abs(pg[k].detach().cpu().numpy() - w)
                                    .max() / max(np.abs(w).max(), 1e-30))
    worst = max(rel, key=rel.get)
    loss_err = abs(got - want)
    assert loss_err <= CHARRNN_LOSS_TOL and rel[worst] <= CHARRNN_PARAM_RTOL, \
        (loss_err, worst, rel[worst])
    return {"rows": 2, "steps": seg, "dtype": "float32", "loss_card": got,
            "loss_cpu": want, "loss_abs_err": loss_err,
            "param_max_rel_err": rel[worst], "param_worst_leaf": worst}


def _fit_path(fused):
    """Select the path of ``fit()``: the fused loop at its default K
    (``DL4J_TORCH_FUSE_STEPS`` unset) or the per-batch loop (1)."""
    import os
    if fused:
        os.environ.pop("DL4J_TORCH_FUSE_STEPS", None)
    else:
        os.environ["DL4J_TORCH_FUSE_STEPS"] = "1"


def charrnn_turn(conf, data, fused, main=False, tries=5):
    """One turn of the phase: a fresh net from the configuration's seed
    (every turn starts from the same parameters), CHARRNN_WARMUP batches,
    then CHARRNN_BATCHES timed batches through ``fit()`` on the fused or
    the per-batch path. ``main``: this turn drives the main path, so the
    launch counts are set to 0 just before its timed run, and that run is
    profiled: a replay of a captured window calls no wrapper, so the
    LSTM kernels it launched are counted by name in its profile. A
    profile that recorded no device event at all saw nothing (its device
    tracing did not start), and the turn runs again, up to ``tries``
    times; the phase fails if none recorded anything."""
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    _fit_path(fused)
    try:
        for _ in range(tries if main else 1):
            net = MultiLayerNetwork(conf, device=DEVICE).init()
            rec = _WindowRecorder()
            net.set_listeners(rec)
            net.fit(ListDataSetIterator(data[:CHARRNN_WARMUP]))
            torch.cuda.synchronize()
            captures_warm = net._fused.captures if net._fused else 0
            torch.cuda.reset_peak_memory_stats()
            start_bytes = torch.cuda.memory_allocated()

            def timed():
                net.fit(ListDataSetIterator(data[CHARRNN_WARMUP:]))
            if main:
                reset_launches()              # the main path starts here
            before = read_lstm_launches()
            if main:
                wall, names, ops = profiled(timed)
            else:
                t0 = time.perf_counter()
                timed()
                torch.cuda.synchronize()
                wall, names, ops = time.perf_counter() - t0, None, None
            calls = tuple(a - b for a, b in zip(read_lstm_launches(), before))
            flash = read_launches()           # ... and ends here
            peak_bytes = torch.cuda.max_memory_allocated()
            net.set_listeners([])
            if names is None or names:
                break
        else:
            raise AssertionError(f"torch.profiler recorded no device event "
                                 f"in {tries} runs of the main path")
    finally:
        _fit_path(True)
    seg, t = CHARRNN["tbptt_length"], CHARRNN["seq_len"]
    windows = t // seg
    n_layers = sum(hasattr(l, "initial_carry") for l in conf.layers)
    # a batch: a sequence launch a layer a window, a backward launch a
    # layer a step
    want = (n_layers * windows * CHARRNN_BATCHES,
            n_layers * t * CHARRNN_BATCHES)
    # the per-batch loop calls the wrappers for every launch; the fused
    # loop calls none in the timed run, whose every window is a replay
    # of the graph captured in the warm-up
    assert calls == ((0, 0) if fused else want), (fused, calls)
    chars = CHARRNN["batch"] * t * CHARRNN_BATCHES
    ms_per_batch = wall / CHARRNN_BATCHES * 1e3
    share = None
    if main:
        launches = lstm_kernels(names)
        assert launches == want, (fused, launches, want)
        assert flash == (0, 0, 0), flash
        share = {"profiled_batches": CHARRNN_BATCHES,
                 **device_share(names, ops, CHARRNN_BATCHES, ms_per_batch)}
    scores = [float(s) for s in rec.scores]
    per_char = [sum(scores[i:i + windows]) / (windows * seg)
                for i in range(0, len(scores), windows)]
    assert len(per_char) == CHARRNN_WARMUP + CHARRNN_BATCHES
    assert all(math.isfinite(x) for x in scores), scores
    assert sum(per_char[-2:]) < sum(per_char[:2]), per_char
    captures = net._fused.captures if net._fused else 0
    if fused:
        # one window signature (T 200 in windows of 50): captured once, in
        # the warm-up
        assert captures_warm == captures == len(net._fused.graphs) == 1, \
            (captures_warm, captures)
        assert net._last_fuse_stats["fused_groups"] == 1
    else:
        assert net._fused is None and captures == 0
    out = {"net": net, "recorder": rec, "path":
           "fused" if fused else "per_batch", "profiled": main,
           "wall_s": wall, "chars_per_s": chars / wall,
           "ms_per_batch": ms_per_batch,
           "ms_per_window": ms_per_batch / windows,
           "loss_per_char_by_batch": per_char,
           "wrapper_calls_per_batch": {
               "lstm_cell_fwd": calls[0] / CHARRNN_BATCHES,
               "lstm_cell_bwd": calls[1] / CHARRNN_BATCHES},
           "graphs_captured_in_warmup": captures_warm,
           "graphs_captured": captures,
           "fuse_stats": net._last_fuse_stats,
           "peak_memory_bytes": peak_bytes,
           "peak_above_start_bytes": peak_bytes - start_bytes,
           "device_share": share}
    if main:
        out["kernel_launches"] = {
            "lstm_cell_fwd": launches[0], "lstm_cell_bwd": launches[1],
            "counted_by": "torch.profiler, the timed run",
            "flash_attention": list(flash)}
    return out


def _leaf_flags(grads):
    """Per leaf of each window's gradients: finite and not all zero."""
    import torch
    return torch.stack([torch.isfinite(g).all() & (g.abs().max() > 0)
                        for w in grads for layer in w
                        for g in layer.values()]).cpu().numpy()


def phase_charrnn(card):
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo

    conf = zoo.char_rnn(vocab_size=CHARRNN["vocab_size"],
                        hidden=CHARRNN["hidden"],
                        tbptt_length=CHARRNN["tbptt_length"],
                        learning_rate=CHARRNN["learning_rate"])
    rng = np.random.RandomState(SEED + 3)
    data, floor = markov_batches(CHARRNN_WARMUP + CHARRNN_BATCHES, rng)
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    # in turns, each from the same parameters: fused (the main path),
    # per-batch, per-batch, fused
    turns = [charrnn_turn(conf, data, True, main=True),
             charrnn_turn(conf, data, False),
             charrnn_turn(conf, data, False),
             charrnn_turn(conf, data, True)]
    fused, plain = turns[0], turns[1]
    net = fused["net"]
    # every window of the per-batch run hands its own gradients to the
    # listeners; a fused group hands its last window's, for every update
    flags = _leaf_flags(plain["recorder"].grads[CHARRNN_WARMUP * windows:])
    assert flags.all(), f"{int((~flags).sum())} leaf gradients zero or " \
        "not finite (per-batch run)"
    group_flags = _leaf_flags([net._last_gradients])
    assert group_flags.all(), "the fused group's last gradients"
    n_leaves = len(group_flags)
    params = [t["net"].params() for t in turns]

    def diff(a, b):
        return float(np.abs(params[a] - params[b]).max())
    same = {"fused_vs_per_batch": diff(0, 1),
            "fused_vs_fused": diff(0, 3),
            "per_batch_vs_per_batch": diff(1, 2)}
    bitwise = {k: v == 0.0 for k, v in same.items()}
    for t in turns:
        t["net"].set_listeners([])
        del t["recorder"]

    seg = CHARRNN["tbptt_length"]
    window_graph_ms = fused_window_graph_ms(net)

    def fit_last_two():
        _fit_path(False)
        try:
            plain["net"].fit(ListDataSetIterator(data[-2:]))
        finally:
            _fit_path(True)
    # the per-batch path's share: two more batches under the profiler,
    # against the unprofiled turn's ms per batch
    for _ in range(5):
        wall, names, ops = profiled(fit_last_two)
        if names:
            break
    else:
        raise AssertionError("torch.profiler recorded no device event in "
                             "five profiles of the per-batch fit")
    plain_share = {"profiled_batches": 2,
                   "profiled_wall_ms_per_batch": wall / 2 * 1e3,
                   **device_share(names, ops, 2, plain["ms_per_batch"])}
    n_layers = sum(hasattr(l, "initial_carry") for l in conf.layers)
    assert lstm_kernels(names) == (2 * n_layers * windows,
                                   2 * n_layers * CHARRNN["seq_len"]), \
        plain_share["cuda_kernels_per_batch"]
    breakdown = charrnn_window_breakdown(plain["net"], data[-1])
    out = net.output(data[0].features)
    assert out.shape == (CHARRNN["batch"], CHARRNN["seq_len"],
                         CHARRNN["vocab_size"]) and np.isfinite(out).all()
    keys = ("profiled", "chars_per_s", "ms_per_batch", "ms_per_window",
            "wall_s", "wrapper_calls_per_batch", "graphs_captured_in_warmup",
            "graphs_captured", "loss_per_char_by_batch")
    result = {"phase": "charrnn", "config": CHARRNN,
              "params": net.num_params(), "warmup_batches": CHARRNN_WARMUP,
              "timed_batches": CHARRNN_BATCHES, "path": "fused",
              **{k: fused[k] for k in (
                  "wall_s", "chars_per_s", "ms_per_batch", "ms_per_window",
                  "loss_per_char_by_batch", "kernel_launches",
                  "wrapper_calls_per_batch", "graphs_captured_in_warmup",
                  "graphs_captured", "fuse_stats", "peak_memory_bytes",
                  "peak_above_start_bytes", "device_share")},
              "loss_floor_per_char": floor,
              "uniform_loss_per_char": math.log(CHARRNN["vocab_size"]),
              "window_graph_replay_ms": window_graph_ms,
              "window_steps": seg,
              "leaves_with_nonzero_gradient": n_leaves,
              "turns": [{k: t[k] for k in ("path",) + keys} | {
                  "busy_share": (fused["device_share"] if i == 0 else
                                 plain_share if i == 1 else {}).get(
                                     "busy_share_of_timed_batch")}
                        for i, t in enumerate(turns)],
              "param_max_abs_diff": same, "param_bitwise": bitwise,
              "per_batch_device_share": plain_share,
              "per_batch_window_breakdown": breakdown,
              "generate": charrnn_generate(net, rng),
              "card": card}
    del net, fused, plain, turns
    result["f32_card_vs_cpu"] = charrnn_card_vs_cpu(conf, data[0])
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase lenet: zoo.lenet_mnist through fit() on real MNIST digits, then
# learning, card against CPU, save and restore, resume
# ---------------------------------------------------------------------------
def _repo_path(*parts):
    return str(Path(__file__).resolve().parent.joinpath(*parts))


def lenet_images():
    """The fixture's real MNIST digits (320 training, 64 held out) through
    the port's ``MnistDataSetIterator``, and the training set tiled to
    LENET_BATCHES batches of LENET_BATCH (bench.py's N)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    fixture = _repo_path(*MNIST_FIXTURE)
    train = MnistDataSetIterator(LENET_BATCH, data_dir=fixture)
    test = MnistDataSetIterator(LENET_BATCH, train=False, data_dir=fixture)
    assert not train.synthetic and train.features.shape == (320, 28, 28, 1)
    n = LENET_BATCH * LENET_BATCHES
    reps = -(-n // len(train.features))
    return (train, test, np.tile(train.features, (reps, 1, 1, 1))[:n],
            np.tile(train.labels, (reps, 1))[:n])


class _ScoreRecorder:
    """Keeps each update's device score (no host read)."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(model._score)


def lenet_turn(conf, feats, labels, fused, main=False, tries=5):
    """One throughput turn: a fresh net from the configuration's seed (the
    same parameters every turn), LENET_WARMUP batches, then the
    LENET_BATCHES timed batches through ``fit()`` on the fused or the
    per-batch path. ``main``: the counts of the package's kernels are set
    to 0 just before the timed run and read just after (the LeNet path
    runs none of them: convolution, pooling and the GEMMs are PyTorch's),
    and the timed run is profiled; a profile that recorded no device
    event runs the turn again, up to ``tries`` times."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.config import env_int
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    warm = LENET_WARMUP * LENET_BATCH
    _fit_path(fused)
    try:
        for _ in range(tries if main else 1):
            net = MultiLayerNetwork(conf, device=DEVICE).init()
            rec = _ScoreRecorder()
            net.set_listeners(rec)
            net.fit(ArrayDataSetIterator(feats[:warm], labels[:warm],
                                         LENET_BATCH))
            torch.cuda.synchronize()
            captures_warm = net._fused.captures if net._fused else 0
            torch.cuda.reset_peak_memory_stats()
            start_bytes = torch.cuda.memory_allocated()

            def timed():
                net.fit(ArrayDataSetIterator(feats, labels, LENET_BATCH))
            if main:
                reset_launches()              # the main path starts here
                wall, names, ops = profiled(timed)
            else:
                t0 = time.perf_counter()
                timed()
                torch.cuda.synchronize()
                wall, names, ops = time.perf_counter() - t0, None, None
            package_kernels = read_launches() + read_lstm_launches()
            peak_bytes = torch.cuda.max_memory_allocated()
            net.set_listeners([])
            if names is None or names:
                break
        else:
            raise AssertionError(f"torch.profiler recorded no device event "
                                 f"in {tries} runs of the main path")
    finally:
        _fit_path(True)
    if main:
        assert package_kernels == (0,) * 5, package_kernels
    scores = np.array([float(s) for s in rec.scores])
    assert len(scores) == LENET_WARMUP + LENET_BATCHES
    assert np.isfinite(scores).all()
    assert scores[-8:].mean() < scores[:8].mean(), scores
    captures = net._fused.captures if net._fused else 0
    if fused:
        # one window signature (a whole 128-row batch), captured in the
        # warm-up and replayed for every timed batch
        assert captures_warm == captures == len(net._fused.graphs) == 1, \
            (captures_warm, captures)
        k = env_int("DL4J_TORCH_FUSE_STEPS")   # the default K
        assert net._last_fuse_stats["fused_groups"] == \
            -(-LENET_BATCHES // k), net._last_fuse_stats
    else:
        assert net._fused is None
    ms_per_batch = wall / LENET_BATCHES * 1e3
    out = {"net": net, "path": "fused" if fused else "per_batch",
           "profiled": main, "wall_s": wall,
           "images_per_s": LENET_BATCH * LENET_BATCHES / wall,
           "ms_per_batch": ms_per_batch,
           "loss_first_8": float(scores[:8].mean()),
           "loss_last_8": float(scores[-8:].mean()),
           "graphs_captured_in_warmup": captures_warm,
           "graphs_captured": captures,
           "peak_memory_bytes": peak_bytes,
           "peak_above_start_bytes": peak_bytes - start_bytes}
    if main:
        out["package_kernel_launches"] = {
            "flash_attention": list(package_kernels[:3]),
            "lstm": list(package_kernels[3:]),
            "counted_by": "the wrappers, the timed run"}
        # no LSTM kernel on this path: device_share's LSTM counts read 0
        out["device_share"] = {"profiled_batches": LENET_BATCHES,
                               **device_share(names, ops, LENET_BATCHES,
                                              ms_per_batch)}
    return out


def _bitwise_or_deterministic(run):
    """``run()`` gives two parameter vectors that a contract says are
    equal. Held bitwise under cuDNN's default algorithms; where that
    fails, again under ``torch.backends.cudnn.deterministic``, which then
    must hold. Returns what was needed and the differences seen."""
    import numpy as np
    import torch
    a, b = run()
    default_diff = float(np.abs(a - b).max())
    out = {"default_max_abs_diff": default_diff,
           "bitwise_under_defaults": default_diff == 0.0}
    if default_diff == 0.0:
        return out | {"needed": "defaults"}
    torch.backends.cudnn.deterministic = True
    try:
        a, b = run()
    finally:
        torch.backends.cudnn.deterministic = False
    det_diff = float(np.abs(a - b).max())
    assert det_diff == 0.0, (default_diff, det_diff)
    return out | {"needed": "torch.backends.cudnn.deterministic",
                  "deterministic_max_abs_diff": det_diff}


def lenet_fused_equals_per_batch(conf, feats, labels):
    """The fused loop against the per-batch loop, 16 batches from the same
    parameters: bitwise, as on the CPU."""
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    n = 16 * LENET_BATCH

    def run():
        params = []
        for fused in (True, False):
            _fit_path(fused)
            try:
                net = MultiLayerNetwork(conf, device=DEVICE).init()
                net.fit(ArrayDataSetIterator(feats[:n], labels[:n],
                                             LENET_BATCH))
                params.append(net.params())
            finally:
                _fit_path(True)
        return params
    return _bitwise_or_deterministic(run)


def lenet_learn(conf, train, test):
    """A fresh net, 40 epochs on the fixture at batch 64, shuffle seed 5
    (the reference's real-MNIST accuracy gate): held-out and pooled
    accuracy against the reference's bars."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    it = MnistDataSetIterator(LENET_LEARN["batch"], shuffle=True,
                              seed=LENET_LEARN["shuffle_seed"],
                              data_dir=_repo_path(*MNIST_FIXTURE))
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    t0 = time.perf_counter()
    net.fit(it, epochs=LENET_LEARN["epochs"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tr = float((np.argmax(net.output(it.features), 1) == it.label_ids).mean())
    te = float((np.argmax(net.output(test.features), 1)
                == test.label_ids).mean())
    pooled = (tr * len(it.label_ids) + te * len(test.label_ids)) \
        / (len(it.label_ids) + len(test.label_ids))
    assert te >= LENET_HELD_OUT_BAR and pooled >= LENET_POOLED_BAR, \
        (te, pooled)
    return net, {"epochs": LENET_LEARN["epochs"],
                 "batch": LENET_LEARN["batch"],
                 "updates": net.iteration, "seconds": seconds,
                 "train_accuracy": tr, "held_out_accuracy": te,
                 "pooled_accuracy": pooled,
                 "bars": {"held_out": LENET_HELD_OUT_BAR,
                          "pooled": LENET_POOLED_BAR}}


def narrow_bn_lenet():
    """LeNet's shape at 12x12 with a BatchNormalization after each conv:
    conv 3x3x4 (relu, no bias), BN, max-pool 2, conv 3x3x6 (relu, no bias),
    BN, max-pool 2, dense 16, softmax 10."""
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, DenseLayer, OutputLayer,
        SubsamplingLayer)
    b = (NeuralNetConfiguration.Builder().seed(SEED).learning_rate(0.01)
         .updater("nesterovs").momentum(0.9).weight_init("xavier")
         .activation("identity").list())
    for n in (4, 6):
        b = (b.layer(ConvolutionLayer(n_out=n, kernel_size=(3, 3),
                                      activation="relu", has_bias=False))
             .layer(BatchNormalization())
             .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                     stride=(2, 2))))
    return (b.layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(12, 12, 1)).build())


def lenet_card_vs_cpu(train):
    """One f32 step of the narrow BN LeNet (per batch: BN declines the
    fused loop) on the card and on the CPU from the same weights: loss,
    every gradient leaf and the running moments; then a max-pool over a
    blank image, whose ties must route the gradient to the same element
    on both."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer
    conf = narrow_bn_lenet()
    assert not fuse_allowed(conf, conf.layers)
    card = MultiLayerNetwork(conf, device=DEVICE).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.set_params(card.params())
    x = np.ascontiguousarray(train.features[:32, 8:20, 8:20])
    y = train.labels[:32]
    got_loss = float(card.fit_batch(x, y))
    want_loss = float(cpu.fit_batch(x, y))
    rel = {}
    for i, (g, w) in enumerate(zip(card.gradient(), cpu.gradient())):
        for k in w:
            rel[f"{i}.{k}"] = ((g[k].cpu() - w[k]).abs().max()
                               / w[k].abs().max().clamp(min=1e-30)).item()
    for i, (g, w) in enumerate(zip(card.states_list, cpu.states_list)):
        for k in w:
            rel[f"{i}.{k}"] = ((g[k].cpu() - w[k]).abs().max()
                               / w[k].abs().max().clamp(min=1e-30)).item()
    loss_err = abs(got_loss - want_loss)
    worst = max(rel, key=rel.get)
    assert loss_err <= TRAIN_LOSS_TOL and rel[worst] <= TRAIN_GRAD_RTOL, \
        (loss_err, worst, rel[worst])
    pool = SubsamplingLayer(pooling_type="max")
    blank = np.zeros((4, 24, 24, 20), np.float32)
    blank[:, 5, 7] = 0.25
    g = np.random.RandomState(SEED).rand(4, 12, 12, 20).astype(np.float32)
    dx = []
    for dev in (DEVICE, "cpu"):
        xt = torch.tensor(blank, device=dev, requires_grad=True)
        out, _ = pool.forward({}, xt, {})
        (d,) = torch.autograd.grad((out * torch.tensor(g, device=dev)).sum(),
                                   xt)
        dx.append(d.cpu())
    assert torch.equal(dx[0], dx[1]), "max-pool ties routed differently"
    return {"config": "12x12x1, conv 3x3x4 + BN, conv 3x3x6 + BN, dense 16",
            "batch": 32, "dtype": "float32", "loss_card": got_loss,
            "loss_cpu": want_loss, "loss_abs_err": loss_err,
            "grad_and_state_max_rel_err": rel[worst],
            "worst_leaf": worst, "max_pool_ties_same_routing": True}


def lenet_archives(net, test, tmp):
    """The learned net written with ``write_model`` and restored on the
    card (``output()`` bit-identical on the held-out digits) and on the
    CPU (within CPU_GPU_TOL); the reference's two committed archives
    restored on the card against their recorded outputs (the LSTM one
    through the sequence kernel)."""
    import os
    import numpy as np
    from deeplearning4j_tpu_torch.utils import model_serializer
    path = os.path.join(tmp, "lenet.zip")
    t0 = time.perf_counter()
    model_serializer.write_model(net, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = model_serializer.restore_multi_layer_network(path)
    restore_s = time.perf_counter() - t0
    want = net.output(test.features)
    got = card.output(test.features)
    assert card.device == net.device and np.array_equal(got, want)
    cpu = model_serializer.restore_multi_layer_network(path, device="cpu")
    cpu_err = float(np.abs(cpu.output(test.features) - want).max())
    assert cpu_err <= CPU_GPU_TOL, cpu_err
    fixtures = {}
    for name in ("convbn_r3", "lstm_r3"):
        before = read_lstm_launches()
        restored = model_serializer.restore_model(
            _repo_path(*CKPT_FIXTURES, f"{name}.zip"))
        with np.load(_repo_path(*CKPT_FIXTURES,
                                f"{name}_expected.npz")) as z:
            probe, expected = z["probe"], z["out"]
        err = float(np.abs(restored.output(probe) - expected).max())
        seq = read_lstm_launches()[0] - before[0]
        assert restored.device == net.device and err <= ARCHIVE_TOL, \
            (name, err)
        assert (seq > 0) == (name == "lstm_r3"), (name, seq)
        fixtures[name] = {"max_abs_err": err, "lstm_sequence_launches": seq}
    return {"archive_bytes": os.path.getsize(path), "write_s": write_s,
            "restore_s": restore_s, "card_output_bit_identical": True,
            "cpu_restore_max_abs_err": cpu_err, "reference_archives":
            fixtures, "tolerance": ARCHIVE_TOL}


def lenet_resume(conf, feats, labels, tmp):
    """LENET_RESUME's epochs of its batches with a checkpoint every
    ``every`` updates (one a group of K 8), uninterrupted; then a fresh
    net resumed from the checkpoint written after the first group must
    end with the same parameters."""
    import os
    import shutil
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.utils import training_checkpoint
    n = LENET_RESUME["batches"] * LENET_BATCH
    every, epochs = LENET_RESUME["every"], LENET_RESUME["epochs"]
    seen = {}
    # keep every checkpoint of the run: the first is the one resumed from
    os.environ["DL4J_TORCH_CKPT_KEEP"] = "100"

    def run():
        full_dir = os.path.join(tmp, "full")
        resume_dir = os.path.join(tmp, "resume")
        for d in (full_dir, resume_dir):
            shutil.rmtree(d, ignore_errors=True)
        full = MultiLayerNetwork(conf, device=DEVICE).init()
        full.fit(ArrayDataSetIterator(feats[:n], labels[:n], LENET_BATCH),
                 epochs=epochs, checkpoint_every=every,
                 checkpoint_dir=full_dir)
        files = training_checkpoint.checkpoint_files(full_dir)
        assert files[0][0] == every, files
        os.makedirs(resume_dir)
        shutil.copy(os.path.join(full_dir, files[0][1]), resume_dir)
        net = MultiLayerNetwork(conf, device=DEVICE).init()
        t0 = time.perf_counter()
        net.fit(ArrayDataSetIterator(feats[:n], labels[:n], LENET_BATCH),
                epochs=epochs, checkpoint_every=every,
                resume_from=resume_dir)
        seen.update(checkpoints=[it for it, _ in files],
                    resumed_from=files[0][0],
                    resumed_fit_s=time.perf_counter() - t0,
                    iterations=(full.iteration, net.iteration))
        assert full.iteration == net.iteration == epochs * \
            LENET_RESUME["batches"]
        return net.params(), full.params()
    try:
        out = _bitwise_or_deterministic(run)
    finally:
        os.environ.pop("DL4J_TORCH_CKPT_KEEP", None)
    return {**LENET_RESUME, **seen, **out}


def phase_lenet(card):
    import tempfile
    import numpy as np
    from deeplearning4j_tpu_torch.models import zoo

    conf = zoo.lenet_mnist()
    train, test, feats, labels = lenet_images()
    seconds = {}
    t0 = time.perf_counter()
    # in turns, each from the same parameters: fused (the main path),
    # per-batch, per-batch, fused
    turns = [lenet_turn(conf, feats, labels, True, main=True),
             lenet_turn(conf, feats, labels, False),
             lenet_turn(conf, feats, labels, False),
             lenet_turn(conf, feats, labels, True)]
    params = [t.pop("net").params() for t in turns]
    seconds["turns"] = time.perf_counter() - t0

    def diff(a, b):
        return float(np.abs(params[a] - params[b]).max())
    same = {"fused_vs_per_batch": diff(0, 1), "fused_vs_fused": diff(0, 3),
            "per_batch_vs_per_batch": diff(1, 2)}
    main_turn = turns[0]
    result = {"phase": "lenet", "config": "zoo.lenet_mnist (28x28x1; conv "
              "5x5x20, max-pool 2, conv 5x5x50, max-pool 2, dense 500, "
              "softmax 10; nesterovs 0.9, lr 0.01)",
              "params": int(params[0].size), "batch": LENET_BATCH,
              "warmup_batches": LENET_WARMUP,
              "timed_batches": LENET_BATCHES, "path": "fused",
              **{k: main_turn[k] for k in (
                  "images_per_s", "ms_per_batch", "wall_s",
                  "graphs_captured_in_warmup", "graphs_captured",
                  "peak_memory_bytes", "peak_above_start_bytes",
                  "package_kernel_launches", "device_share")},
              "turns": [{k: t[k] for k in (
                  "path", "profiled", "images_per_s", "ms_per_batch",
                  "wall_s", "graphs_captured", "loss_first_8",
                  "loss_last_8", "peak_memory_bytes")} for t in turns],
              "param_max_abs_diff_between_turns": same, "card": card}
    steps = [("fused_equals_per_batch",
              lambda: lenet_fused_equals_per_batch(conf, feats, labels)),
             ("learning", lambda: lenet_learn(conf, train, test)),
             ("f32_card_vs_cpu", lambda: lenet_card_vs_cpu(train))]
    for key, step in steps:
        t0 = time.perf_counter()
        result[key] = step()
        seconds[key] = time.perf_counter() - t0
    net, result["learning"] = result["learning"]
    with tempfile.TemporaryDirectory() as tmp:
        for key, step in (
                ("save_restore", lambda: lenet_archives(net, test, tmp)),
                ("resume", lambda: lenet_resume(conf, feats, labels, tmp))):
            t0 = time.perf_counter()
            result[key] = step()
            seconds[key] = time.perf_counter() - t0
    result["seconds"] = seconds
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase resnet50: zoo.resnet50() at full width through fit() as a
# ComputationGraph, then card against CPU, archive, resume, and a
# recurrent graph through the LSTM kernels
# ---------------------------------------------------------------------------
def resnet_images(batch, n, seed=0):
    """``n`` pre-made batches of seeded normal 224x224x3 images and one-hot
    labels over 1000 classes, as bench.py's ``_resnet_throughput`` makes
    its batch (``np.random.default_rng(0)``)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rng = np.random.default_rng(seed)
    k = RESNET_FULL["n_classes"]
    shape = (batch, RESNET_FULL["height"], RESNET_FULL["width"],
             RESNET_FULL["channels"])
    eye = np.eye(k, dtype=np.float32)
    return [DataSet(rng.normal(size=shape).astype(np.float32),
                    eye[rng.integers(0, k, batch)]) for _ in range(n)]


def _cycled(batches, n):
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    return ListDataSetIterator([batches[i % len(batches)] for i in range(n)])


def resnet_turn(batch):
    """ResNet-50 at full width in bf16 on the card: RESNET_WARMUP batches,
    then RESNET_TIMED timed batches through ``fit(iterator)`` (host clock,
    ending in a synchronise). The package's kernel counts are set to 0
    just before the timed run and read just after: the path runs none of
    them (convolution, BatchNormalization, pooling and the dense head
    are PyTorch's). Every step's score must be finite, and the guard must
    revert none."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    conf = zoo.resnet50(**RESNET_FULL)
    conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf, device=DEVICE).init()
    assert net.num_params() == RESNET_PARAMS, net.num_params()
    batches = resnet_images(batch, RESNET_PREMADE)
    rec = _ScoreRecorder()
    net.set_listeners(rec)
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    net.fit(_cycled(batches, RESNET_WARMUP))
    torch.cuda.synchronize()
    reset_launches()                          # the main path starts here
    t0 = time.perf_counter()
    net.fit(_cycled(batches, RESNET_TIMED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    package_kernels = read_launches() + read_lstm_launches()   # ... ends
    assert package_kernels == (0,) * 5, package_kernels
    peak = torch.cuda.max_memory_allocated()
    net.set_listeners([])
    scores = [float(s) for s in rec.scores]
    assert len(scores) == RESNET_WARMUP + RESNET_TIMED
    assert all(math.isfinite(x) for x in scores), scores
    assert net.nan_skipped_steps == 0
    ms = wall / RESNET_TIMED * 1e3
    ips = batch * RESNET_TIMED / wall
    from deeplearning4j_tpu_torch.hw import TRAIN_FLOPS_MULTIPLIER
    return net, batches, {
        "batch": batch, "warmup_batches": RESNET_WARMUP,
        "timed_batches": RESNET_TIMED, "wall_s": wall,
        "images_per_s": ips, "ms_per_batch": ms,
        "mfu": ips * TRAIN_FLOPS_MULTIPLIER * RESNET_FWD_FLOPS
        / PEAK_OPS_PER_S["bfloat16"],
        "peak_memory_bytes": peak,
        "peak_above_start_bytes": peak - start_bytes,
        "scores": scores, "reverted_steps": net.nan_skipped_steps,
        "package_kernel_launches": list(package_kernels),
        "fuse_stats": net._last_fuse_stats}


def resnet_profile(net, batches, ms_per_batch, tries=5):
    """RESNET_PROFILED more batches of the same net under
    ``torch.profiler``: the busy share against the unprofiled turn's ms a
    batch, the top device ops, device events a batch, and the pageable
    host-to-device copies' device time."""
    for _ in range(tries):
        aten = []
        wall, names, ops = profiled(
            lambda: net.fit(_cycled(batches, RESNET_PROFILED)),
            aten_rows=aten)
        if names:
            break
    else:
        raise AssertionError("torch.profiler recorded no device event in "
                             f"{tries} profiles of the ResNet-50 fit")
    h2d = [(n, c, us) for n, c, us in ops if "HtoD" in n]
    aten.sort(key=lambda o: o[2], reverse=True)
    conv_us = sum(us for n, _, us in aten if "convolution" in n)
    return {"profiled_batches": RESNET_PROFILED,
            "device_ms_per_batch_by_aten_op": [
                {"op": n, "calls_per_batch": c / RESNET_PROFILED,
                 "device_ms": us / 1e3 / RESNET_PROFILED}
                for n, c, us in aten[:12]],
            "convolution_device_ms_per_batch": conv_us / 1e3
            / RESNET_PROFILED,
            "profiled_wall_ms_per_batch": wall / RESNET_PROFILED * 1e3,
            "pageable_h2d_copies": [{"name": n, "calls": c,
                                     "device_ms": us / 1e3}
                                    for n, c, us in h2d],
            "h2d_device_ms_per_batch": sum(us for _, _, us in h2d) / 1e3
            / RESNET_PROFILED,
            **device_share(names, ops, RESNET_PROFILED, ms_per_batch)}


def resnet_archive(net, batches, tmp):
    """The full-width net written after its timed run and restored on the
    card: ``output()`` the same bits."""
    import os
    import numpy as np
    from deeplearning4j_tpu_torch.utils import model_serializer
    path = os.path.join(tmp, "resnet50.zip")
    t0 = time.perf_counter()
    model_serializer.write_model(net, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = model_serializer.restore_computation_graph(path)
    restore_s = time.perf_counter() - t0
    x = batches[0].features[:16]
    want, got = net.output(x), card.output(x)
    assert card.device == net.device and np.array_equal(got, want)
    assert np.array_equal(card.params(), net.params())
    return {"archive_bytes": os.path.getsize(path), "write_s": write_s,
            "restore_s": restore_s, "output_rows": 16,
            "card_output_bit_identical": True}


def _card_cpu_rel(card, cpu):
    """The largest relative difference, card against CPU, of the two
    graphs' parameters and BatchNormalization moments (each leaf against
    its own max abs; a running mean against the larger of its max abs and
    the square root of the running variance), with the leaf's name."""
    import numpy as np
    worst = (0.0, "")
    for name, g, w in zip(cpu.layer_names, card.params_list,
                          cpu.params_list):
        for k in w:
            want = w[k].detach().numpy()
            err = np.abs(g[k].detach().cpu().numpy() - want).max()
            worst = max(worst, (float(err / max(np.abs(want).max(), 1e-30)),
                                f"{name}.{k}"))
    for name, g, w in zip(cpu.layer_names, card.states_list,
                          cpu.states_list):
        if not w:
            continue
        var = w["var"].numpy()
        scales = {"var": np.abs(var).max(),
                  "mean": max(np.abs(w["mean"].numpy()).max(),
                              np.sqrt(var.max()))}
        for k, scale in scales.items():
            err = np.abs(g[k].cpu().numpy() - w[k].numpy()).max()
            worst = max(worst, (float(err / max(scale, 1e-30)),
                                f"{name}.{k}"))
    return worst


def f32_decision_flips(card, cpu, x):
    """Where the card's f32 forward takes another branch than the CPU's
    from the same parameters on ``x`` (each device's activations compared
    on the CPU): ReLU outputs that are 0 on one device and positive on
    the other, and max-pool windows whose largest entry is another one.
    Each sends a gradient elsewhere, so the f32 gradient is not
    continuous."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        LayerVertex
    from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer
    from deeplearning4j_tpu_torch.nn.layers.conv import _pair, _spatial_pads
    acts = []
    for net in (card, cpu):
        with torch.no_grad():
            a, _, _, _, _ = net._forward_graph(
                net.params_list, net.states_list, [net._tensor(x)],
                train=False, rngs=None, fmasks=None)
        acts.append({k: v.detach().cpu().double() for k, v in a.items()})
    relu = pool = 0
    for name in cpu.topological_order:
        v = cpu.conf.vertices[name]
        if not isinstance(v, LayerVertex):
            continue
        if (v.layer.activation or "").lower() == "relu":
            relu += int(((acts[0][name] > 0) != (acts[1][name] > 0)).sum())
        if isinstance(v.layer, SubsamplingLayer) and \
                v.layer.pooling_type == "max":
            idx = []
            for a in acts:
                xin = a[cpu.conf.vertex_inputs[name][0]]
                pt, pb, pl, pr = _spatial_pads(v.layer, xin)
                xc = F.pad(xin.permute(0, 3, 1, 2), (pl, pr, pt, pb),
                           value=float("-inf"))
                idx.append(F.max_pool2d(xc, _pair(v.layer.kernel_size),
                                        _pair(v.layer.stride),
                                        return_indices=True)[1])
            pool += int((idx[0] != idx[1]).sum())
    return {"relu_units": relu, "max_pool_windows": pool}


def cnn_graph_card_vs_cpu(build, kw, batch, seed, compute="float32"):
    """A narrow zoo graph, f32 parameters (TF32 off): the output and the
    loss on the CPU's parameters first, then 3 ``fit`` steps on the card
    and on the CPU from the same parameters in ``compute`` (float32, or
    float64 where the f32 gradient is not continuous), then outputs,
    parameters and BN moments. Within CNN_CARD_CPU_RTOL, or
    CNN_F64_STEPS_RTOL for float64 steps. GoogLeNet's head drops out: its
    masks come from each device's own generator, so it is off here."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    conf = getattr(zoo, build)(**kw)
    for v in conf.vertices.values():
        if getattr(v, "layer", None) is not None and v.layer.dropout:
            v.layer.dropout = 0.0
    r = np.random.RandomState(seed)
    size, classes = kw["height"], kw["n_classes"]
    data = [DataSet(r.randn(batch, size, size, 3).astype(np.float32),
                    np.eye(classes, dtype=np.float32)[
                        r.randint(0, classes, batch)]) for _ in range(3)]
    x = data[0].features

    def out_rel(card, cpu):
        want = cpu.output(x)
        return float(np.abs(card.output(x) - want).max()
                     / np.abs(want).max())

    def run(dtype):
        conf.compute_dtype = dtype
        card = ComputationGraph(conf, device=DEVICE).init()
        cpu = ComputationGraph(conf, device="cpu").init(params=card.params())
        before = out_rel(card, cpu)
        losses = [card.score(data[0]), cpu.score(data[0])]
        flips = []
        t0 = time.perf_counter()
        for ds in data:
            if dtype == "float32" and compute != "float32":
                flips.append(f32_decision_flips(card, cpu, ds.features))
            for net in (card, cpu):
                net.fit(ListDataSetIterator([ds]))
        rel, leaf = _card_cpu_rel(card, cpu)
        return {"compute": dtype, "output_max_rel_err_before": before,
                **({"f32_decision_flips_by_step": flips} if flips else {}),
                "loss_before_card_cpu": losses,
                "output_max_rel_err_after": out_rel(card, cpu),
                "param_and_state_max_rel_err": rel, "worst_leaf": leaf,
                "seconds": time.perf_counter() - t0}
    gated = run(compute)
    bar = CNN_CARD_CPU_RTOL if compute == "float32" else CNN_F64_STEPS_RTOL
    loss_rel = abs(gated["loss_before_card_cpu"][0]
                   - gated["loss_before_card_cpu"][1]) \
        / abs(gated["loss_before_card_cpu"][1])
    assert gated["output_max_rel_err_before"] <= CNN_CARD_CPU_RTOL and \
        loss_rel <= CNN_CARD_CPU_RTOL and \
        gated["output_max_rel_err_after"] <= CNN_CARD_CPU_RTOL and \
        gated["param_and_state_max_rel_err"] <= bar, (build, gated)
    out = {"config": f"zoo.{build}({kw})", "batch": batch, "steps": 3,
           "parameters": "float32", "tolerance": bar,
           "forward_tolerance": CNN_CARD_CPU_RTOL, **gated}
    if compute != "float32":
        out["float32_steps_not_gated"] = run("float32")
    return out


def resnet_resume(tmp):
    """The narrow ResNet: RESNET_RESUME's epochs with a checkpoint every
    ``every`` updates, uninterrupted; then a fresh graph resumed from the
    first checkpoint must end with the same parameters, bitwise (under
    ``cudnn.deterministic`` if cuDNN's defaults differ: then it says
    so)."""
    import os
    import shutil
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.utils import training_checkpoint
    cfg = RESNET_RESUME
    conf = zoo.resnet50(**RESNET_NARROW)
    r = np.random.RandomState(SEED + 5)
    data = [DataSet(r.randn(cfg["batch"], 32, 32, 3).astype(np.float32),
                    np.eye(5, dtype=np.float32)[r.randint(0, 5,
                                                          cfg["batch"])])
            for _ in range(cfg["batches"])]
    seen = {}
    os.environ["DL4J_TORCH_CKPT_KEEP"] = "100"

    def run():
        full_dir = os.path.join(tmp, "cg_full")
        resume_dir = os.path.join(tmp, "cg_resume")
        for d in (full_dir, resume_dir):
            shutil.rmtree(d, ignore_errors=True)
        full = ComputationGraph(conf, device=DEVICE).init()
        full.fit(ListDataSetIterator(data), epochs=cfg["epochs"],
                 checkpoint_every=cfg["every"], checkpoint_dir=full_dir)
        files = training_checkpoint.checkpoint_files(full_dir)
        assert files[0][0] == cfg["every"], files
        os.makedirs(resume_dir)
        shutil.copy(os.path.join(full_dir, files[0][1]), resume_dir)
        net = ComputationGraph(conf, device=DEVICE).init()
        net.fit(ListDataSetIterator(data), epochs=cfg["epochs"],
                checkpoint_every=cfg["every"], resume_from=resume_dir)
        assert full.iteration == net.iteration == \
            cfg["epochs"] * cfg["batches"]
        seen.update(checkpoints=[it for it, _ in files],
                    resumed_from=files[0][0])
        return net.params(), full.params()
    try:
        out = _bitwise_or_deterministic(run)
    finally:
        os.environ.pop("DL4J_TORCH_CKPT_KEEP", None)
    if out["needed"] != "defaults":
        print("chip_smoke: resnet50 resume set "
              "torch.backends.cudnn.deterministic for its check",
              flush=True)
    return {**cfg, **seen, **out}


def charrnn_graph_conf():
    """``zoo.char_rnn``'s chain (two peephole GravesLSTMs and a softmax
    RnnOutputLayer, rmsprop, tBPTT) built with ``GraphBuilder`` at the
    charrnn phase's width and learning rate."""
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    v, h, seg = (CHARRNN["vocab_size"], CHARRNN["hidden"],
                 CHARRNN["tbptt_length"])
    return (NeuralNetConfiguration.Builder()
            .seed(12345).learning_rate(CHARRNN["learning_rate"])
            .updater("rmsprop").rms_decay(0.95).weight_init("xavier")
            .graph_builder().add_inputs("in")
            .add_layer("lstm1", GravesLSTM(n_in=v, n_out=h,
                                           activation="tanh"), "in")
            .add_layer("lstm2", GravesLSTM(n_in=h, n_out=h,
                                           activation="tanh"), "lstm1")
            .add_layer("out", RnnOutputLayer(n_in=h, n_out=v,
                                             activation="softmax",
                                             loss="mcxent"), "lstm2")
            .set_outputs("out").backprop_type("tbptt")
            .tbptt_fwd_length(seg).tbptt_back_length(seg)
            .set_input_types(InputType.recurrent(v)).build())


def recurrent_graph(tries=5):
    """The char-RNN as a ComputationGraph against the MultiLayerNetwork's
    per-batch path: CG_RNN_BATCHES batches of 32 x 200 characters by
    ``fit_batch`` from the same parameters, each run profiled, with the
    wrappers' counts set to 0 just before it and read just after. Both
    must launch the LSTM sequence kernel 8 times and the backward kernel
    400 times a batch, and end with the same parameters."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    data, _ = markov_batches(CG_RNN_BATCHES, np.random.RandomState(SEED + 7))
    mln_conf = zoo.char_rnn(vocab_size=CHARRNN["vocab_size"],
                            hidden=CHARRNN["hidden"],
                            tbptt_length=CHARRNN["tbptt_length"],
                            learning_rate=CHARRNN["learning_rate"])
    start = MultiLayerNetwork(mln_conf, device=DEVICE).init().params()
    runs = {}
    for kind in ("graph", "mln"):
        for _ in range(tries):
            if kind == "graph":
                net = ComputationGraph(charrnn_graph_conf(),
                                       device=DEVICE).init(params=start)
                step = lambda ds: net.fit_batch(ds)       # noqa: E731
            else:
                net = MultiLayerNetwork(mln_conf,
                                        device=DEVICE).init(params=start)
                step = lambda ds: net.fit_batch(ds.features,  # noqa: E731
                                                ds.labels)
            reset_launches()
            wall, names, _ = profiled(lambda: [step(ds) for ds in data])
            wrappers = read_lstm_launches()
            if names:
                break
        else:
            raise AssertionError("torch.profiler recorded no device event "
                                 f"in {tries} runs of the {kind} char-RNN")
        runs[kind] = {"params": net.params(), "profiled": lstm_kernels(names),
                      "wrappers": wrappers, "wall_s": wall,
                      "iterations": net.iteration}
    g, m = runs["graph"], runs["mln"]
    n_layers = 2
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    want = (n_layers * windows * CG_RNN_BATCHES,
            n_layers * CHARRNN["seq_len"] * CG_RNN_BATCHES)
    assert g["profiled"] == m["profiled"] == g["wrappers"] == \
        m["wrappers"] == want, (g["profiled"], m["profiled"],
                                g["wrappers"], m["wrappers"], want)
    diff = float(np.abs(g["params"] - m["params"]).max())
    assert diff == 0.0, diff
    assert g["iterations"] == m["iterations"] == windows * CG_RNN_BATCHES
    return {"config": "zoo.char_rnn's chain through GraphBuilder "
            f"({CHARRNN})", "batches": CG_RNN_BATCHES,
            "launches": {"lstm_seq_kernel": g["profiled"][0],
                         "lstm_bwd_kernel": g["profiled"][1],
                         "counted_by": "torch.profiler and the wrappers"},
            "mln_per_batch_launches": {"lstm_seq_kernel": m["profiled"][0],
                                       "lstm_bwd_kernel": m["profiled"][1]},
            "param_max_abs_diff_vs_mln": diff,
            "graph_wall_s": g["wall_s"], "mln_wall_s": m["wall_s"]}


def phase_resnet50(card):
    import gc
    import tempfile
    import torch

    result = {"phase": "resnet50", "config": "zoo.resnet50() (224x224x3, "
              "1000 classes, bottleneck stages 3-4-6-3, BatchNormalization; "
              "nesterovs 0.9, lr 0.1), compute_dtype bfloat16, f32 masters",
              "params": RESNET_PARAMS, "path": "fit(iterator), per batch "
              "(fuse_allowed declines graphs)", "card": card}
    seconds = {}
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for batch in RESNET_BATCHES:
            t0 = time.perf_counter()
            net, batches, turn = resnet_turn(batch)
            if batch == RESNET_BATCHES[0]:
                turn["device_share"] = resnet_profile(net, batches,
                                                      turn["ms_per_batch"])
            else:
                result["save_restore"] = resnet_archive(net, batches, tmp)
            turns.append(turn)
            del net, batches
            gc.collect()
            torch.cuda.empty_cache()
            seconds[f"batch_{batch}"] = time.perf_counter() - t0
        result["turns"] = turns
        for key, step in (
                ("f32_card_vs_cpu_resnet", lambda: cnn_graph_card_vs_cpu(
                    "resnet50", RESNET_NARROW, 8, SEED + 3)),
                ("card_vs_cpu_googlenet", lambda: cnn_graph_card_vs_cpu(
                    "googlenet", GOOGLENET_NARROW, 8, SEED + 4,
                    compute="float64")),
                ("resume", lambda: resnet_resume(tmp)),
                ("recurrent_graph", recurrent_graph)):
            t0 = time.perf_counter()
            result[key] = step()
            seconds[key] = time.perf_counter() - t0
    result["seconds"] = seconds
    emit(result)
    return result


# ---- phase decode: generation serving -----------------------------------

def _serve_lm(conf_kw, device=None):
    """A seeded TransformerLM for the decode phase (torch's generator:
    the same weights for the same seed on every run and card)."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    return TransformerLM(TransformerConfig(**conf_kw),
                         device=device or DEVICE).init()


def _quantiles(xs):
    import numpy as np
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def step_logits(lm, prefix, rows, total, vector_pos):
    """The logits after ``prefix`` through the token step, eagerly, with
    ``rows`` rows (every row the prefix): the shapes ``generate()`` runs
    (1 row, scalar positions, a cache of ``total``) or a slot pool's
    (``rows`` rows, per-row positions)."""
    import torch
    dev = lm.device
    sp = lm._step_params(lm.params)
    step = lm._make_token_step(rows, total, vector_pos=vector_pos)
    kcs, vcs = lm._new_caches(rows, total)
    write = torch.ones(rows, dtype=torch.bool, device=dev)
    with torch.no_grad():
        for i, t in enumerate(prefix):
            tok = torch.full((rows,), int(t), dtype=torch.int64, device=dev)
            if vector_pos:
                pos = torch.full((rows,), i, dtype=torch.int64, device=dev)
                logits = step(sp, tok, pos, kcs, vcs, write=write)
            else:
                logits = step(sp, tok, i, kcs, vcs)
    return logits[0].float().cpu().numpy()


def token_splits(lm, prompts, got, want, slots, n_new, bar):
    """Compare two arms' greedy rows: for every request, whether they are
    equal and, at the first differing position, the top-2 gap of the
    logits there (one-row path) and the largest difference between the
    one-row and the slot-pool path's logits there. A split is a rounding
    tie when the gap lies under ``bar`` and under the paths' own
    difference; any other split fails."""
    import numpy as np
    splits = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        j = int(np.nonzero(a != b)[0][0])
        prefix = b[:j]
        one = step_logits(lm, prefix, 1, p.size + n_new, False)
        pool = step_logits(lm, prefix, slots, lm.conf.max_len, True)
        top2 = np.sort(one)[-2:]
        gap = float(top2[1] - top2[0])
        diff = float(np.abs(one - pool).max())
        splits.append({"request": i, "position": j, "tokens": [int(a[j]),
                       int(b[j])], "top2_gap": gap,
                       "logits_max_abs_diff": diff,
                       "rounding_tie": gap <= bar and gap <= diff})
    return {"requests": len(prompts), "equal": len(prompts) - len(splits),
            "splits": splits, "bar": bar}


class GcClock:
    """Seconds the interpreter's garbage collector ran inside a block
    (a stall of the scheduler thread that the host clock counts)."""

    def __enter__(self):
        import gc
        self.seconds, self._t0 = 0.0, None
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._tick)


def _hold_splits(check, name):
    bad = [s for s in check["splits"] if not s["rounding_tie"]]
    assert not bad, (name, bad)


def serve_bench_run(card):
    """bench.py's bench_serve, uncut: serial ``generate()`` after one warm
    call per prompt length, then ContinuousLM (warm_start, 2 warm
    requests) over the same 64-request burst."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import ContinuousLM

    cfg = SERVE_BENCH
    lm = _serve_lm(cfg["model"])
    V, n_new = cfg["model"]["vocab_size"], cfg["n_new"]
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, V, (cfg["prompts"][i % len(cfg["prompts"])],))
            .astype(np.int32) for i in range(cfg["requests"])]

    for plen in sorted({p.size for p in reqs}):   # one graph a signature
        lm.generate(np.ones((1, plen), np.int32), n_new, temperature=0.0)
    torch.cuda.synchronize()
    cap0 = capture_count()
    reset_launches()
    naive, lat_naive = [], []
    t0 = time.perf_counter()
    for p in reqs:                 # a burst at t0: latency includes the wait
        naive.append(lm.generate(p[None, :], n_new, temperature=0.0)[0])
        lat_naive.append(time.perf_counter() - t0)
    naive_dt = time.perf_counter() - t0
    naive_captures = capture_count() - cap0

    srv = ContinuousLM(lm, slots=cfg["slots"], chunk=cfg["chunk"],
                       device=DEVICE)
    try:
        t0 = time.perf_counter()
        srv.warm_start()
        warm_s = time.perf_counter() - t0
        for p in reqs[:2]:
            srv.submit(p, n_new).result(300)
        inventory = srv.graph_inventory()
        obs.reset_metrics()
        cap0 = capture_count()
        t0 = time.perf_counter()
        futs = [srv.submit(p, n_new) for p in reqs]
        cont, lat_cont = [], []
        for f in futs:
            cont.append(f.result(600))
            lat_cont.append(time.perf_counter() - t0)
        cont_dt = time.perf_counter() - t0
        cont_captures = capture_count() - cap0
        launches = read_launches() + read_lstm_launches()
        inventory_after = srv.graph_inventory()
    finally:
        srv.stop()
    assert naive_captures == 0 and cont_captures == 0, \
        (naive_captures, cont_captures)
    assert inventory_after == inventory, (inventory, inventory_after)
    assert launches == (0, 0, 0, 0, 0), launches   # no package kernel
    for row, p in zip(cont, reqs):
        assert row.shape == (p.size + n_new,) and (row >= 0).all() \
            and (row < V).all()
    budget = 3 * len(srv._kv_ladder) + 2 * len(srv._prefill_ladder) + 1
    assert len(inventory) == budget, (len(inventory), budget)
    check = token_splits(lm, reqs, cont, naive, cfg["slots"], n_new,
                         CPU_GPU_TOL)
    _hold_splits(check, "bench_serve")
    naive_tps = len(reqs) * n_new / naive_dt
    cont_tps = len(reqs) * n_new / cont_dt
    req_h = obs.metrics.histogram("serve.request_seconds")
    ttft_h = obs.metrics.histogram("serve.ttft_seconds")
    occ = obs.metrics.histogram("serve.batch_occupancy").summary()
    return {"config": cfg, "naive_tokens_per_s": naive_tps,
            "continuous_tokens_per_s": cont_tps,
            "speedup": cont_tps / naive_tps, "bench_bar": SERVE_BASE,
            "speedup_over_bar": cont_tps / naive_tps / SERVE_BASE,
            "naive_request_s": _quantiles(lat_naive),
            "continuous_request_s": _quantiles(lat_cont),
            "request_seconds_hist": {"p50": req_h.quantile(0.5),
                                     "p99": req_h.quantile(0.99)},
            "ttft_seconds_hist": {"p50": ttft_h.quantile(0.5),
                                  "p99": ttft_h.quantile(0.99)},
            "occupancy_mean": occ.get("mean"),
            "graphs_captured_timed": {"naive": naive_captures,
                                      "continuous": cont_captures},
            "inventory": [list(s) for s in inventory],
            "inventory_size": len(inventory), "inventory_budget": budget,
            "reference_budget": len(srv._kv_ladder)
            + len(srv._prefill_ladder) + 1,
            "warm_start_s": warm_s, "package_kernel_launches": 0,
            "tokens_vs_naive": check, "card": card}


def serve_long_prompt_run(card):
    """bench.py's long-prompt arm, uncut: 16 prompts of 400 tokens sharing
    a 256-token prefix, a burst at n_new 1 (time to first token) then at
    n_new 32 (tokens/s), ladders off and no prefix cache against the
    prefill ladder (16, 64) with the default cache."""
    import numpy as np
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import ContinuousLM

    cfg = SERVE_LONG
    V = cfg["model"]["vocab_size"]
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, V, (cfg["shared"],)).astype(np.int32)
    reqs = [np.concatenate([prefix, rng.integers(
        1, V, (cfg["prompt"] - cfg["shared"],)).astype(np.int32)])
        for _ in range(cfg["requests"])]

    def arm(**kwargs):
        lm = _serve_lm(cfg["model"])   # same seed, same weights
        obs.reset_metrics()
        srv = ContinuousLM(lm, slots=cfg["slots"], chunk=cfg["chunk"],
                           device=DEVICE, **kwargs)
        try:
            srv.warm_start()
            inventory = srv.graph_inventory()
            cap0 = capture_count()
            lat = []
            t0 = time.perf_counter()
            futs = [srv.submit(p, 1) for p in reqs]
            for f in futs:
                f.result(600)
                lat.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            futs = [srv.submit(p, cfg["n_new"]) for p in reqs]
            rows = [f.result(900) for f in futs]
            dt = time.perf_counter() - t0
            captured = capture_count() - cap0
            assert srv.graph_inventory() == inventory
        finally:
            srv.stop()
        budget = 3 * len(srv._kv_ladder) + 2 * len(srv._prefill_ladder) + 1
        assert captured == 0 and len(inventory) == budget, \
            (captured, len(inventory), budget)
        return rows, {
            "ttft_s": _quantiles(lat),
            "tokens_per_s": cfg["requests"] * cfg["n_new"] / dt,
            "graphs_captured_timed": captured,
            "inventory_size": len(inventory), "inventory_budget": budget,
            "kv_ladder": list(srv._kv_ladder),
            "prefill_ladder": list(srv._prefill_ladder),
            "prefix_hits": obs.metrics.value("serve.prefix_hits_total"),
            "prefix_misses": obs.metrics.value("serve.prefix_misses_total")}

    base_rows, base = arm(kv_ladder="off", prefill_ladder="off",
                          prefix_cache_mb=0)
    paged_rows, paged = arm(prefill_ladder=cfg["prefill_ladder"])
    assert paged["prefix_hits"] > 0, paged
    lm = _serve_lm(cfg["model"])
    check = token_splits(lm, reqs, paged_rows, base_rows, cfg["slots"],
                         cfg["n_new"], CPU_GPU_TOL)
    _hold_splits(check, "long_prompt")
    return {"config": cfg, "baseline": base, "paged": paged,
            "ttft_p50_speedup": base["ttft_s"]["p50"]
            / paged["ttft_s"]["p50"],
            "tokens_per_s_speedup": paged["tokens_per_s"]
            / base["tokens_per_s"],
            "tokens_paged_vs_baseline": check, "card": card}


def serve_full_width_run(card):
    """The slice phase's LM (bf16 compute, so a bf16 cache) behind
    ContinuousLM: 32 requests of 64-token prompts, n_new 64; tokens/s, ms
    a decode dispatch, peak memory, a profile of decode dispatches, token
    equality with ``generate(temperature=0)`` on the card, and one
    ``beam_search(beams=4)``."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import ContinuousLM, decode

    cfg = SERVE_FULL
    lm = _serve_lm(SLICE)
    assert lm.num_params() == SLICE_PARAMS, lm.num_params()
    assert lm._cache_dtype() == torch.bfloat16
    V = SLICE["vocab_size"]
    rng = np.random.default_rng(2)
    reqs = [rng.integers(1, V, (cfg["prompt"],)).astype(np.int32)
            for _ in range(cfg["requests"])]
    dispatches = [0]
    pool_decode = decode._SlotPool.decode

    def counted(self, *a):
        dispatches[0] += 1
        return pool_decode(self, *a)
    srv = ContinuousLM(lm, slots=cfg["slots"], chunk=cfg["chunk"],
                       device=DEVICE)
    try:
        t0 = time.perf_counter()
        srv.warm_start()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        srv.submit(reqs[0], cfg["n_new"]).result(300)
        torch.cuda.reset_peak_memory_stats()
        cap0 = capture_count()
        decode._SlotPool.decode = counted
        reset_launches()
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            futs = [srv.submit(p, cfg["n_new"]) for p in reqs]
            rows = [f.result(900) for f in futs]
            dt = time.perf_counter() - t0
        n_dispatch = dispatches[0]
        # a second burst of other prompts: the first pays any first-use
        # cost the warm request did not
        more = [rng.integers(1, V, (cfg["prompt"],)).astype(np.int32)
                for _ in range(cfg["requests"])]
        t0 = time.perf_counter()
        for f in [srv.submit(p, cfg["n_new"]) for p in more]:
            f.result(900)
        dt2 = time.perf_counter() - t0
        decode._SlotPool.decode = pool_decode
        launches = read_launches() + read_lstm_launches()
        captured = capture_count() - cap0
        peak = torch.cuda.max_memory_allocated()
        # a profile of decode dispatches over a full pool: every slot
        # active at the max_len rung, greedy
        pool = srv._pool
        pool.state["active"].fill_(True)
        pool.state["nnew"].fill_(0)
        pool.state["pos"].fill_(cfg["prompt"])
        n_prof = 5
        inventory = srv.graph_inventory()
        variants = {}
        with torch.no_grad():
            for mode in ("greedy", "sample", "filter"):
                pool.decode(cfg["chunk"], SLICE["max_len"], mode)
                variants[mode] = profiled(lambda: [
                    pool.decode(cfg["chunk"], SLICE["max_len"], mode)
                    for _ in range(n_prof)])
    finally:
        decode._SlotPool.decode = pool_decode
        srv.stop()
    assert captured == 0 and launches == (0, 0, 0, 0, 0), \
        (captured, launches)
    wall, names, ops = variants["greedy"]
    busy_ms = sum(us for _, _, us in ops) / 1e3 / n_prof
    top = sorted(ops, key=lambda o: o[2], reverse=True)[:8]
    # what each sampler variant costs a dispatch (the host picks greedy
    # when no active row samples)
    variant_ms = {mode: {"wall_ms": w * 1e3 / n_prof,
                         "device_ms": sum(us for _, _, us in o) / 1e3
                         / n_prof,
                         "device_events": len(n) / n_prof}
                  for mode, (w, n, o) in variants.items()}
    cap0 = capture_count()
    t0 = time.perf_counter()
    want = [lm.generate(p[None, :], cfg["n_new"], temperature=0.0)[0]
            for p in reqs]
    gen_s = time.perf_counter() - t0
    gen_captures = capture_count() - cap0
    check = token_splits(lm, reqs, rows, want, cfg["slots"], cfg["n_new"],
                         BF16_LOGITS_BAR)
    _hold_splits(check, "full_width")
    beam = []
    for _ in range(2):   # the first call captures, the second replays
        t0 = time.perf_counter()
        out = lm.beam_search(reqs[0][None, :], cfg["n_new"], beams=4)
        beam.append(time.perf_counter() - t0)
    assert out.shape == (1, cfg["prompt"] + cfg["n_new"])
    assert (out >= 0).all() and (out < V).all()
    return {"config": cfg, "model": SLICE, "num_params": lm.num_params(),
            "tokens_per_s": cfg["requests"] * cfg["n_new"] / dt,
            "wall_s": dt, "gc_s_in_timed_run": gc_clock.seconds,
            "second_burst_tokens_per_s": cfg["requests"] * cfg["n_new"]
            / dt2,
            "decode_dispatches": n_dispatch,
            "ms_per_dispatch": dt * 1e3 / n_dispatch,
            "peak_memory_bytes": peak, "warm_start_s": warm_s,
            "graphs_captured_timed": captured,
            "inventory_size": len(inventory),
            "profile": {"dispatches": n_prof, "rung": SLICE["max_len"],
                        "wall_ms_per_dispatch": wall * 1e3 / n_prof,
                        "device_busy_ms_per_dispatch": busy_ms,
                        "busy_share": busy_ms / (wall * 1e3 / n_prof),
                        "device_events_per_dispatch": len(names) / n_prof,
                        "top_device_ops": [
                            {"name": n[:80], "calls": c, "device_ms": us / 1e3}
                            for n, c, us in top],
                        "sampler_variants": variant_ms},
            "generate_s": gen_s, "generate_graphs_captured": gen_captures,
            "tokens_vs_generate": check,
            "beam_search_4_s": {"first_call": beam[0], "replay": beam[1]},
            "card": card}


def serve_card_vs_cpu(card):
    """A narrow f32 model (TF32 off) on the card and the same weights on
    the CPU: greedy ``generate()`` tokens, and one decode step's logits
    from the same slot-pool state."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.transformer import params_from_numpy

    cfg = SERVE_NARROW
    lm = _serve_lm(cfg["model"])
    cpu = _serve_lm(cfg["model"], device="cpu")
    cpu.params = params_from_numpy(_numpy_tree(lm.params), "cpu")
    rng = np.random.default_rng(3)
    V = cfg["model"]["vocab_size"]
    prompts = rng.integers(0, V, (cfg["rows"], cfg["prompt"]))
    got = lm.generate(prompts, cfg["n_new"], temperature=0.0)
    want = cpu.generate(prompts, cfg["n_new"], temperature=0.0)
    splits = []
    for i in range(cfg["rows"]):
        if not np.array_equal(got[i], want[i]):
            j = int(np.nonzero(got[i] != want[i])[0][0])
            one = step_logits(cpu, want[i][:j], 1, j + 1, False)
            card_l = step_logits(lm, want[i][:j], 1, j + 1, False)
            top2 = np.sort(one)[-2:]
            gap = float(top2[1] - top2[0])
            diff = float(np.abs(one - card_l).max())
            splits.append({"row": i, "position": j, "top2_gap": gap,
                           "logits_max_abs_diff": diff,
                           "rounding_tie": gap <= CPU_GPU_TOL
                           and gap <= diff})
    assert all(s["rounding_tie"] for s in splits), splits
    # one decode step from one state: random caches and positions
    S, c = cfg["rows"], lm.conf
    g = torch.Generator().manual_seed(SEED)
    state = cpu._init_decode_state(S)
    for buf in state["k"] + state["v"]:
        buf.copy_(torch.randn(buf.shape, generator=g))
    pos = torch.tensor(rng.integers(1, c.max_len - 1, S))
    tok = torch.tensor(rng.integers(0, V, S))
    write = torch.ones(S, dtype=torch.bool)
    logits = []
    for model, dev in ((cpu, "cpu"), (lm, DEVICE)):
        step = model._make_token_step(S, c.max_len, vector_pos=True)
        ks = [b.to(dev) for b in state["k"]]
        vs = [b.to(dev) for b in state["v"]]
        with torch.no_grad():
            logits.append(step(model._step_params(model.params),
                               tok.to(dev), pos.to(dev), ks, vs,
                               write=write.to(dev)).cpu().numpy())
    step_err = float(np.abs(logits[0] - logits[1]).max())
    assert np.isfinite(logits[1]).all() and step_err <= CPU_GPU_TOL, step_err
    return {"config": cfg, "greedy_rows_equal": cfg["rows"] - len(splits),
            "rows": cfg["rows"], "splits": splits,
            "decode_step_logits_max_abs_err": step_err, "tol": CPU_GPU_TOL,
            "card": card}


def serve_sampled_determinism(card):
    """One sampled request (temperature 1, top_k 50, top_p 0.9, seed 7)
    alone, then inside a mixed pool of greedy and sampled requests: the
    same tokens (the noise is a pure function of the pool's base seed,
    the request's seed and its position). One KV rung, so the two runs
    attend over the same window shape."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving import ContinuousLM

    cfg = SERVE_BENCH
    lm = _serve_lm(cfg["model"])
    V = cfg["model"]["vocab_size"]
    rng = np.random.default_rng(4)
    p = rng.integers(1, V, (16,)).astype(np.int32)
    others = [rng.integers(1, V, (n,)).astype(np.int32)
              for n in (8, 24, 12, 30, 5, 17)]
    kw = dict(temperature=1.0, top_k=50, top_p=0.9, seed=7)
    srv = ContinuousLM(lm, slots=cfg["slots"], chunk=cfg["chunk"],
                       device=DEVICE, kv_ladder="off")
    try:
        srv.warm_start()
        alone = srv.generate(p, cfg["n_new"], timeout=300, **kw)
        futs = [srv.submit(o, cfg["n_new"], temperature=0.7 * (i % 2),
                           seed=100 + i) for i, o in enumerate(others[:3])]
        mixed_f = srv.submit(p, cfg["n_new"], **kw)
        futs += [srv.submit(o, cfg["n_new"], temperature=1.0, top_k=5,
                            seed=200 + i) for i, o in enumerate(others[3:])]
        mixed = mixed_f.result(300)
        for f in futs:
            f.result(300)
        again = srv.generate(p, cfg["n_new"], timeout=300,
                             **dict(kw, seed=8))
    finally:
        srv.stop()
    assert np.array_equal(alone, mixed), (alone, mixed)
    return {"tokens_equal": True, "n_new": cfg["n_new"], "sampler": kw,
            "other_seed_differs": not np.array_equal(alone, again),
            "card": card}


def phase_decode(card):
    import threading
    t_phase = time.perf_counter()
    seconds = {}
    # threads left by earlier phases share the interpreter lock with the
    # scheduler thread, whose host work paces each dispatch
    result = {"phase": "decode", "card": card,
              "threads_at_start": sorted(t.name for t in
                                         threading.enumerate())}
    for key, run in (("bench_serve", serve_bench_run),
                     ("long_prompt", serve_long_prompt_run),
                     ("full_width", serve_full_width_run),
                     ("card_vs_cpu", serve_card_vs_cpu),
                     ("sampled_determinism", serve_sampled_determinism)):
        t0 = time.perf_counter()
        result[key] = run(card)
        seconds[key] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    result["seconds"] = seconds
    emit(result)
    return result

# ---- phase serve_scale: ReplicaRouter and ServingIngress ------------------

_SERVE_THREADS = ("dl4j-torch-serve", "dl4j-torch-router")


def _serve_threads():
    """Names of the serving tier's threads still alive (schedulers,
    heartbeats, router drains, the ingress listener)."""
    import threading
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(_SERVE_THREADS))


def _recorded(rep, seen):
    """Wrap ``rep.submit`` to note each prompt it is asked to serve."""
    submit = rep.submit

    def wrapper(prompt, *a, **k):
        seen.add(bytes(memoryview(prompt)))
        return submit(prompt, *a, **k)
    rep.submit = wrapper


def kernel_overlap(spans):
    """(sum of the kernels' device time, the time at least one ran) in
    µs, from ``(start, end)`` spans: their ratio above 1 is the overlap
    of kernels on the card's streams."""
    spans = sorted(spans)
    total = sum(e - s for s, e in spans)
    union, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    return total, union


def profiled_streams(fn):
    """``fn()`` under ``torch.profiler``: wall ms, the kernels' device
    time and the time any kernel ran (ms), their overlap ratio, and the
    streams the kernels ran on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, streams = [], set()
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA") or "emcpy" in e.name \
                or "emset" in e.name:
            continue
        kr = getattr(e, "time_range", None)
        if kr is None:
            continue
        spans.append((kr.start, kr.end))
        streams.add(getattr(e, "device_resource_id", None))
    total, union = kernel_overlap(spans)
    return {"wall_ms": wall * 1e3, "kernels": len(spans),
            "kernel_ms": total / 1e3, "any_kernel_running_ms": union / 1e3,
            "busy_share": union / 1e3 / (wall * 1e3),
            "overlap": total / union if union else None,
            "streams": len(streams)}


def serve_scale_bench(card):
    """bench.py:_bench_serve_scale_pinned on the card: a steady 4-client
    open loop (tokens/s, p50/p99, graphs captured 0), ``/v1/generate``
    plain and streamed through ServingIngress equal to a direct submit,
    a kill of replica 0 under a burst of 24 (done and dead, the resolved
    fraction against bench.py's bar, failover seconds, graphs captured in
    recovery 0, no admitted request run again, every completed row equal
    to ``generate()`` of its prompt), and an overload past the SLO (429s
    at the door, the admitted p99)."""
    import json as _json
    import threading
    import urllib.request
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.errors import (ServeQueueFullError,
                                                 ServeReplicaDeadError)
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import (ContinuousLM,
                                                  ReplicaRouter,
                                                  ServingIngress)
    from deeplearning4j_tpu_torch.testing import faults

    cfg = SERVE_SCALE
    lm = _serve_lm(cfg["model"])
    V, n_new, slots = cfg["model"]["vocab_size"], cfg["n_new"], cfg["slots"]
    rng = np.random.default_rng(0)

    def burst(n):
        return [rng.integers(1, V, (cfg["prompts"][i % 2],))
                .astype(np.int32) for i in range(n)]

    reps = [ContinuousLM(lm, slots=slots, chunk=cfg["chunk"],
                         device=DEVICE) for _ in range(cfg["replicas"])]
    router = ReplicaRouter(reps, heartbeat_s=cfg["heartbeat_s"], slo_ms=0.0)
    router2 = ing = None
    out = {"config": cfg, "card": card}
    completed = []     # (prompt, row) of every completed request
    try:
        t0 = time.perf_counter()
        router.warm_start()        # each replica captures over its pool
        torch.cuda.synchronize()
        out["warm_start_s"] = time.perf_counter() - t0
        inventory = [len(r.graph_inventory()) for r in reps]
        for p in burst(2 * cfg["replicas"]):
            completed.append((p, router.submit(p, n_new).result(600)))
        assert lm.params is reps[0].lm.params is reps[1].lm.params
        obs.reset_metrics()
        reset_launches()

        # ---- steady open loop: 0 graphs captured ----------------------
        work = [burst(cfg["per_client"]) for _ in range(cfg["clients"])]
        lat, lock = [], threading.Lock()

        def client(k):
            for p in work[k]:
                t1 = time.perf_counter()
                row = router.submit(p, n_new).result(600)
                with lock:
                    lat.append(time.perf_counter() - t1)
                    completed.append((p, row))
        cap0 = capture_count()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=client, args=(k,), daemon=True)
              for k in range(cfg["clients"])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        steady_dt = time.perf_counter() - t0
        steady_caps = capture_count() - cap0
        n_req = cfg["clients"] * cfg["per_client"]
        req_h = obs.metrics.histogram("serve.request_seconds")
        out["steady"] = {
            "tokens_per_s": n_req * n_new / steady_dt, "requests": n_req,
            "request_s": _quantiles(lat),
            "request_seconds_hist": {"p50": req_h.quantile(0.5),
                                     "p99": req_h.quantile(0.99)},
            "graphs_captured": steady_caps,
            "inventory_per_replica": inventory}
        # the two replicas' streams under one more burst, profiled
        more = burst(2 * slots)
        prof = profiled_streams(lambda: [
            f.result(600) for f in [router.submit(p, n_new) for p in more]])
        out["steady"]["profile_burst_of_16"] = prof

        # ---- /v1/generate through the ingress, plain and streamed -----
        ing = ServingIngress(router).start()
        url = f"http://127.0.0.1:{ing.port}/v1/generate"
        wire = []
        for p in burst(3):
            direct = router.submit(p, n_new).result(600).tolist()
            body = _json.dumps({"prompt": p.tolist(), "n_new": n_new})
            plain = _json.loads(urllib.request.urlopen(urllib.request.Request(
                url, data=body.encode()), timeout=120).read())["tokens"]
            lines = [_json.loads(ln) for ln in urllib.request.urlopen(
                urllib.request.Request(url, data=_json.dumps(
                    {"prompt": p.tolist(), "n_new": n_new,
                     "stream": True}).encode()), timeout=120)
                .read().splitlines()]
            streamed = [t for ln in lines[:-1] for t in ln["tokens"]]
            wire.append(plain == direct and lines[-1]["tokens"] == direct
                        and streamed == direct[p.size:])
        out["ingress"] = {"requests": len(wire), "equal_to_submit": wire,
                          "readyz": urllib.request.urlopen(
                              url.replace("/v1/generate", "/readyz"),
                              timeout=30).status}
        assert all(wire), wire
        ing.stop()
        ing = None

        # ---- kill replica 0 under a burst: nothing lost ---------------
        survivor_seen = set()
        _recorded(reps[1], survivor_seen)
        cap0 = capture_count()
        faults.install("kill-replica[0]@0")
        t_kill = time.perf_counter()
        kill_burst = burst(3 * slots)
        futs = [router.submit(p, n_new) for p in kill_burst]
        done = dead = 0
        dead_prompts = []
        for p, f in zip(kill_burst, futs):
            try:
                completed.append((p, f.result(600)))
                done += 1
            except ServeReplicaDeadError as e:
                assert e.retryable and e.http_status == 502
                dead += 1
                dead_prompts.append(p)
        faults.clear()
        failover_dt = time.perf_counter() - t_kill
        resolved = (done + dead) / len(futs)
        for p in burst(slots):    # the survivor serves on
            completed.append((p, router.submit(p, n_new).result(600)))
        recovery_caps = capture_count() - cap0
        replayed = sum(bytes(memoryview(p)) in survivor_seen
                       for p in dead_prompts)
        out["kill"] = {
            "burst": len(futs), "done": done, "dead": dead,
            "resolved_fraction": resolved, "bench_bar": SERVE_SCALE_BASE,
            "resolved_over_bar": resolved / SERVE_SCALE_BASE,
            "failover_s": failover_dt,
            "graphs_captured_in_recovery": recovery_caps,
            "dead_requests_run_again": replayed,
            "failovers": obs.metrics.value("serve.replica_failovers_total"),
            "replicas_healthy": obs.metrics.value("router.replicas_healthy")}
        assert resolved == 1.0 and dead >= 1 and replayed == 0, out["kill"]
        assert steady_caps == 0 and recovery_caps == 0, \
            (steady_caps, recovery_caps)

        # ---- overload past the SLO: shed at the door -------------------
        # bench.py sends its storm one request at a time; on the card one
        # request alone takes about the SLO, so the storm here is one
        # burst of twice the slots, whose second wave waits for the first
        obs.reset_metrics()
        router2 = ReplicaRouter([reps[1]], heartbeat_s=3600.0,
                                slo_ms=cfg["slo_ms"])
        router2.check()
        storm = burst(2 * slots)
        for p, f in [(p, router2.submit(p, n_new)) for p in storm]:
            completed.append((p, f.result(600)))
        router2.check()
        sheds, admitted = 0, []
        for p in burst(2 * slots):
            try:
                admitted.append((p, router2.submit(p, n_new)))
            except ServeQueueFullError as e:
                assert e.http_status == 429
                sheds += 1
        for p, f in admitted:
            completed.append((p, f.result(600)))
        out["overload"] = {
            "slo_ms": cfg["slo_ms"], "storm_burst": len(storm),
            "rolling_p99_s": router2.rolling_p99(),
            "shed_429": sheds, "offered": 2 * slots,
            "shed_total": obs.metrics.value("serve.shed_total"),
            "admitted_p99_s": obs.metrics.histogram(
                "serve.request_seconds").quantile(0.99)}
        assert sheds > 0, out["overload"]
        out["package_kernel_launches"] = list(read_launches()
                                              + read_lstm_launches())
        assert out["package_kernel_launches"] == [0] * 5
    finally:
        faults.clear()
        if ing is not None:
            ing.stop()
        if router2 is not None:
            router2.stop()
        router.stop()
    # every completed greedy row against generate() of its prompt
    prompts = [p for p, _ in completed]
    rows = [r for _, r in completed]
    want = [lm.generate(p[None, :], n_new, temperature=0.0)[0]
            for p in prompts]
    check = token_splits(lm, prompts, rows, want, slots, n_new, CPU_GPU_TOL)
    _hold_splits(check, "serve_scale")
    out["tokens_vs_generate"] = {k: check[k] for k in ("requests", "equal")}
    out["tokens_vs_generate"]["splits"] = check["splits"]
    return out


def serve_scale_full_width(card):
    """The slice's LM (bf16 compute) behind two ContinuousLM replicas of
    16 slots: a burst of 32 requests with replica 0 killed at its first
    dispatch, and a second burst on the survivor; resolved fraction,
    tokens/s, graphs captured, and every completed greedy row against
    ``generate()`` on the card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.errors import ServeReplicaDeadError
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import ContinuousLM, ReplicaRouter
    from deeplearning4j_tpu_torch.testing import faults

    cfg = SERVE_SCALE_FULL
    lm = _serve_lm(SLICE)
    V, n_new = SLICE["vocab_size"], cfg["n_new"]
    rng = np.random.default_rng(3)
    reps = [ContinuousLM(lm, slots=cfg["slots"], chunk=cfg["chunk"],
                         device=DEVICE) for _ in range(2)]
    router = ReplicaRouter(reps, heartbeat_s=cfg["heartbeat_s"], slo_ms=0.0)
    completed = []
    try:
        t0 = time.perf_counter()
        router.warm_start()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for _ in range(2):
            p = rng.integers(1, V, (cfg["prompt"],)).astype(np.int32)
            completed.append((p, router.submit(p, n_new).result(600)))
        torch.cuda.reset_peak_memory_stats()
        cap0 = capture_count()
        reqs = [rng.integers(1, V, (cfg["prompt"],)).astype(np.int32)
                for _ in range(cfg["requests"])]
        t0 = time.perf_counter()
        steady = [router.submit(p, n_new) for p in reqs]
        for p, f in zip(reqs, steady):
            completed.append((p, f.result(900)))
        steady_dt = time.perf_counter() - t0
        faults.install("kill-replica[0]@0")
        t0 = time.perf_counter()
        kill = [rng.integers(1, V, (cfg["prompt"],)).astype(np.int32)
                for _ in range(cfg["requests"])]
        futs = [router.submit(p, n_new) for p in kill]
        done = dead = 0
        for p, f in zip(kill, futs):
            try:
                completed.append((p, f.result(900)))
                done += 1
            except ServeReplicaDeadError:
                dead += 1
        faults.clear()
        kill_dt = time.perf_counter() - t0
        captured = capture_count() - cap0
        peak = torch.cuda.max_memory_allocated()
    finally:
        faults.clear()
        router.stop()
    assert (done + dead) == len(kill) and dead >= 1 and captured == 0, \
        (done, dead, captured)
    prompts = [p for p, _ in completed]
    rows = [r for _, r in completed]
    want = [lm.generate(p[None, :], n_new, temperature=0.0)[0]
            for p in prompts]
    check = token_splits(lm, prompts, rows, want, cfg["slots"], n_new,
                         BF16_LOGITS_BAR)
    _hold_splits(check, "serve_scale_full_width")
    return {"config": cfg, "model": SLICE, "replicas": 2,
            "warm_start_s": warm_s,
            "steady_tokens_per_s": len(reqs) * n_new / steady_dt,
            "kill": {"burst": len(kill), "done": done, "dead": dead,
                     "resolved_fraction": (done + dead) / len(kill),
                     "seconds": kill_dt},
            "graphs_captured": captured, "peak_memory_bytes": peak,
            "tokens_vs_generate": {"requests": check["requests"],
                                   "equal": check["equal"],
                                   "splits": check["splits"]},
            "card": card}


def phase_serve_scale(card):
    t_phase = time.perf_counter()
    result = {"phase": "serve_scale", "card": card,
              "threads_at_start": _serve_threads()}
    seconds = {}
    for key, run in (("bench", serve_scale_bench),
                     ("full_width", serve_scale_full_width)):
        t0 = time.perf_counter()
        result[key] = run(card)
        seconds[key] = time.perf_counter() - t0
    # every heartbeat, scheduler and listener has stopped
    result["threads_at_end"] = _serve_threads()
    assert not result["threads_at_end"], result["threads_at_end"]
    seconds["phase"] = time.perf_counter() - t_phase
    result["seconds"] = seconds
    emit(result)
    return result


# ---- phase word2vec ---------------------------------------------------------

def w2v_corpus(vocab, total, sent_len, seed):
    """bench.py:bench_word2vec's corpus: ``total`` Zipf-drawn words over
    ``vocab`` words, in sentences of ``sent_len``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(vocab)])
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    ids = rng.choice(vocab, total, p=probs)
    return [" ".join(words[ids[i:i + sent_len]])
            for i in range(0, total, sent_len)]


def w2v_route(route, sents, profile=False):
    """One scatter route at bench.py's configuration: warm-up fits (every
    chunk bucket captured), fresh tables in place, then the timed fit (and
    a second from the same seed): words/s, graphs captured while timed,
    peak memory, whether the two fits' tables are the same bits."""
    import torch
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.nlp import lookup
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.config import env_int
    lookup.set_scatter_impl(route)
    try:
        c = W2V
        # bench.py's batch, unless DL4J_TORCH_W2V_BATCH sets another
        batch = env_int("DL4J_TORCH_W2V_BATCH") or c["batch_size"]
        w2v = Word2Vec(layer_size=c["layer_size"], window=c["window"],
                       negative=c["negative"], use_hierarchic_softmax=False,
                       min_word_frequency=c["min_word_frequency"],
                       sampling=c["sampling"], epochs=1, seed=c["seed"],
                       batch_size=batch, device=DEVICE)

        def provider():
            return (s.split() for s in sents)
        w2v.build_vocab(provider())
        t0 = time.perf_counter()
        for n_warm in c["warm_sentences"]:
            w2v.fit(lambda: (s.split() for s in sents[:n_warm]))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        fits = []
        for _ in range(2):
            w2v.build_vocab(provider())      # fresh tables, in place
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cap0 = capture_count()
            reset_launches()
            t0 = time.perf_counter()
            w2v.fit(provider)
            float(w2v.lookup_table.syn0[0, 0])   # a hard sync
            dt = time.perf_counter() - t0
            fits.append({"seconds": dt, "words_per_s": c["total"] / dt,
                         "graphs_captured": capture_count() - cap0,
                         "peak_memory_bytes":
                             torch.cuda.max_memory_allocated(),
                         "package_kernel_launches":
                             list(read_launches() + read_lstm_launches()),
                         "syn0": w2v.lookup_table.syn0.clone()})
        a, b = fits[0].pop("syn0"), fits[1].pop("syn0")
        out = {"route": route, "batch_size": batch, "warm_up_s": warm_s,
               "fits": fits,
               "words_per_s": fits[0]["words_per_s"],
               "bench_bar": W2V_BASE,
               "words_per_s_over_bar": fits[0]["words_per_s"] / W2V_BASE,
               "syn0_finite": bool(torch.isfinite(a).all()),
               "syn0_std": float(a.float().std()),
               "bitwise_across_two_fits": bool(torch.equal(a, b)),
               "max_abs_diff_across_two_fits":
                   float((a.float() - b.float()).abs().max()),
               "graphs": len(w2v._programs),
               "vocab": w2v.vocab.num_words()}
        if profile:
            w2v.build_vocab(provider())
            wall, names, ops = profiled(lambda: (
                w2v.fit(provider), float(w2v.lookup_table.syn0[0, 0])))
            busy = sum(us for _, _, us in ops) / 1e3
            top = sorted(ops, key=lambda o: o[2], reverse=True)[:8]
            out["profile"] = {
                "wall_ms": wall * 1e3, "device_busy_ms": busy,
                "busy_share": busy / (wall * 1e3),
                "device_events": len(names),
                "top_device_ops": [{"name": n[:80], "calls": k,
                                    "device_ms": us / 1e3}
                                   for n, k, us in top]}
        assert all(f["graphs_captured"] == 0 for f in fits), fits
        assert all(f["package_kernel_launches"] == [0] * 5 for f in fits)
        assert out["syn0_finite"] and out["syn0_std"] > 1e-4, out
        if route == "sorted":
            assert out["bitwise_across_two_fits"], out
        return out
    finally:
        lookup.set_scatter_impl(None)


def w2v_card_vs_cpu():
    """A small hierarchical-softmax skip-gram fit (no device randomness)
    on the card and on the CPU: syn0 and syn1 within W2V_CARD_CPU_RTOL of
    each table's max abs."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    c = W2V_SMALL
    sents = w2v_corpus(c["vocab"], c["total"], c["sent_len"], 1)
    tables = []
    for dev in (DEVICE, "cpu"):
        w = Word2Vec(layer_size=c["layer_size"], window=c["window"],
                     negative=0, use_hierarchic_softmax=True,
                     min_word_frequency=c["min_word_frequency"],
                     sampling=c["sampling"], epochs=1, seed=c["seed"],
                     batch_size=c["batch_size"], device=dev)
        w.fit_corpus(sents)
        tables.append((w.lookup_table.syn0.float().cpu().numpy(),
                       w.lookup_table.syn1.float().cpu().numpy()))
    rel = {name: float(np.abs(a - b).max() / np.abs(b).max())
           for name, a, b in zip(("syn0", "syn1"), tables[0], tables[1])}
    out = {"config": c, "max_rel_err": rel, "tolerance": W2V_CARD_CPU_RTOL}
    assert max(rel.values()) <= W2V_CARD_CPU_RTOL, out
    return out


def phase_word2vec(card):
    t_phase = time.perf_counter()
    c = W2V
    t0 = time.perf_counter()
    sents = w2v_corpus(c["vocab"], c["total"], c["sent_len"],
                       c["corpus_seed"])
    result = {"phase": "word2vec", "config": c,
              "corpus_s": time.perf_counter() - t0, "card": card}
    result["routes"] = {route: w2v_route(route, sents,
                                         profile=route == "sorted")
                        for route in W2V_ROUTES}
    result["card_vs_cpu_hs"] = w2v_card_vs_cpu()
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


def phase_order_check(card):
    """The narrow ResNet's f32 card-against-CPU check again, after the
    serving and Word2Vec phases in this process: it must not depend on
    what ran before it."""
    t0 = time.perf_counter()
    result = {"phase": "order_check", "after": ["decode", "serve_scale",
                                                "word2vec"],
              "resnet_narrow_f32": cnn_graph_card_vs_cpu(
                  "resnet50", RESNET_NARROW, 8, SEED + 3),
              "card": card}
    result["seconds"] = time.perf_counter() - t0
    emit(result)
    return result


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

    d256 = phase_build(card)
    kernels = phase_kernels(card)
    lstm = phase_lstm_kernels(card)
    sl = phase_slice(card)
    tr = phase_train(card)
    cr = phase_charrnn(card)
    phase_lenet(card)
    rn = phase_resnet50(card)
    cg = rn["recurrent_graph"]["launches"]
    phase_decode(card)
    phase_serve_scale(card)
    phase_word2vec(card)
    phase_order_check(card)

    # the flash kernels at the TransformerLM train path's shape, the LSTM
    # kernels at the char-RNN's
    fwd = kernels[("train", "bfloat16")]
    bwd = kernels[("train", "bfloat16", "bwd")]

    def wide(name):
        """The kernel's DP 256 instances at the d256 case: error, ms,
        registers and spill, bf16 (tensor cores) and f32 (CUDA cores)."""
        out = {}
        for dt in ("bfloat16", "float32"):
            f, b = kernels[("d256", dt)], kernels[("d256", dt, "bwd")]
            if name == "flash_attn_fwd":
                rec = {"max_abs_err": f["max_abs_err"], "ms": f["kernel_ms"],
                       "bound_ms": f["bound_ms"], "plain_ms": f["plain_ms"],
                       "library_ms": f["library_ms"]}
            else:
                which = "dq" if name == "flash_attn_dq" else "dkv"
                grads = ("dq",) if which == "dq" else ("dk", "dv")
                rec = {"max_abs_err": max(b["errors"][g]["max_abs_err"]
                                          for g in grads),
                       "ms": b[f"{which}_ms"],
                       "bound_ms": b[f"{which}_bound_ms"],
                       "plain_ms": b["plain_bwd_ms"],
                       "library_ms": b["library_bwd_ms"]}
            rec.update((d256.get(name) or {}).get(dt) or {})
            out[dt] = rec
        return {"shape": kernels[("d256", "float32")]["shape"], **out}
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
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         "design": fwd["design"], "f32_route": "cuda cores",
         "d256": wide("flash_attn_fwd")},
        {"name": "flash_attn_dq", "route": "cuda",
         "source": src + "flash_attn_dq.cu", "replaces": ref + "185",
         "launches": launches["flash_attn_dq"],
         "max_abs_err": bwd["errors"]["dq"]["max_abs_err"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
         "library_ms": bwd["library_bwd_ms"],
         "design": bwd["design"], "f32_route": "cuda cores",
         "d256": wide("flash_attn_dq")},
        {"name": "flash_attn_dkv", "route": "cuda",
         "source": src + "flash_attn_dkv.cu", "replaces": ref + "235",
         "launches": launches["flash_attn_dkv"],
         "max_abs_err": max(bwd["errors"][g]["max_abs_err"]
                            for g in ("dk", "dv")),
         "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["dkv_bound_ms"], "bound_by": bwd["dkv_bound_by"],
         "library_ms": bwd["library_bwd_ms"],
         "design": bwd["design"], "f32_route": "cuda cores",
         "d256": wide("flash_attn_dkv")},
        # the char-RNN's layer window (the sequence kernel) and cell step
        # (the backward); no PyTorch call computes the peephole cell, so
        # library_ms is null and cuDNN's LSTM (another function) is
        # reported beside them
        {"name": "lstm_cell_fwd", "route": "cuda",
         "source": src + "lstm_cell_fwd.cu", "replaces": ref + "508",
         "launches": cr["kernel_launches"]["lstm_cell_fwd"],
         "launches_counted_by": cr["kernel_launches"]["counted_by"],
         "launches_cg": cg["lstm_seq_kernel"],
         "max_abs_err": max(lstm["main"]["errors"][g]["max_abs_err"]
                            for g in ("out", "h", "c")),
         "ms": lstm["main"]["fwd_ms"], "steps": lstm["main"]["shape"]["T"],
         "t1_ms": lstm["t1"]["fwd_ms"],
         "plain_ms": lstm["main"]["plain_fwd_ms"],
         "bound_ms": lstm["main"]["fwd_bound_ms"],
         "bound_by": lstm["main"]["fwd_bound_by"], "library_ms": None,
         "cudnn_lstm_window_fwd_ms": lstm["library"]["window_fwd_ms"],
         "launches_per_call": lstm["main"]["fwd_launches_per_call"],
         "call_ms": lstm["main"]["fwd_call_ms"], "design": LSTM_FWD_DESIGN},
        {"name": "lstm_cell_bwd", "route": "cuda",
         "source": src + "lstm_cell_bwd.cu", "replaces": ref + "540",
         "launches": cr["kernel_launches"]["lstm_cell_bwd"],
         "launches_counted_by": cr["kernel_launches"]["counted_by"],
         "launches_cg": cg["lstm_bwd_kernel"],
         "max_abs_err": max(e["max_abs_err"] for g, e in
                            lstm["main"]["errors"].items()
                            if g not in ("h", "c")),
         "ms": lstm["main"]["bwd_ms"], "plain_ms": lstm["main"]["plain_bwd_ms"],
         "bound_ms": lstm["main"]["bwd_bound_ms"],
         "bound_by": lstm["main"]["bwd_bound_by"], "library_ms": None,
         "cudnn_lstm_step_ms": lstm["library"]["per_step_bwd_ms"],
         "launches_per_call": lstm["main"]["bwd_launches_per_call"],
         "call_ms": lstm["main"]["bwd_call_ms"], "design": LSTM_BWD_DESIGN},
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
