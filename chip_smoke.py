#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain versions.

Run from the repository root on a host with an H100 and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build — compile every kernel of ``deeplearning4j_tpu_torch/csrc`` with
   nvcc (one process per source, started together) and the native
   library (``native/src``) with g++ beside them, and report the time;
2. kernels — each kernel on the card against its plain PyTorch twin on
   the same inputs, at the serving and training paths' shapes and a few
   edge shapes (T 1, T 65, d 36, a q view with a storage offset, d
   256, the widest the kernels take, with GQA 2, and phase ``vit``'s
   attention: n 768, T 196, non-causal): the
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
   fused loop declines BatchNormalization), on seeded normal images and one-hot
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
11. attention — an MLN of two SelfAttentionLayers (causal; the second
   residual) and an RnnOutputLayer of 32 classes at the attention shape
   of bench.py's ``bench_transformer_lm`` (d 512, 8 heads of 64, T 512,
   batch 32; bf16 compute, adam): the layers reach the three flash
   kernels through the helper seam (``FlashAttentionHelper``). 2 warm-up
   and 10 timed ``fit_batch`` steps (ms a step, tokens/s, peak memory),
   with the launch counts set to 0 just before and read just after: 2
   forward, 2 dQ and 2 dK/dV launches a step, by the wrappers and by
   ``torch.profiler`` over one more step; ``output()`` (f32, 2 forward
   launches); the bf16 kernels at the first layer's own q/k/v against the
   built-in dense path in f32 from the same inputs (``BF16_O_BAR``,
   ``BF16_DQ_BAR``, ``BF16_DKV_BAR``); an f32 copy of the net, output and
   one step's gradients, against the same net under
   ``DL4J_TPU_DISABLE_HELPERS=1`` (1e-5 of each tensor's max abs); a
   batch with a key mask, which the helper declines (0 launches, 2
   declines counted, the built-in route's bits); and ``fit(iterator)``
   through the fused loop (the flash kernels inside its window graph,
   counted by the profiler in the replays) against the per-batch loop
   from the same parameters, bitwise;
12. keras — the committed Keras files (``tests/fixtures/keras``)
   imported on the card with the package's HDF5 reader: the Keras 1
   LeNet at the zoo's full width (431,080 parameters, trained on the
   fixture's digits) must reach the held-out bar (0.90) with no
   training, equal the CPU import within 1e-5 of its scale and a zoo
   ``lenet_mnist`` net given the same parameters, then train 2 epochs
   through ``KerasRPCServer``'s POST ``/fit`` on ``.npz`` minibatches of
   the fixture on 127.0.0.1 (first and last score, seconds) and still
   reach the bar; a 'th' functional residual block (Conv2D, BN, a sum
   Merge, Flatten, Dense) and a Keras 2 LSTM at the char-RNN's width (H
   200, 65 inputs, T 50) equal their CPU imports, the LSTM's output
   through one sequence-kernel launch and one fine-tune step through 50
   backward launches (the ``kernels`` line's ``launches_keras``); and
   ``TrainedModelHelper(VGG16).set_path_to_h5`` on the committed tiny
   VGG-shaped file (8x8x3 to 1000), ``VGG16ImagePreProcessor``,
   ``output()`` on the card and ``decode_predictions``: the CPU's top-5;
   and the full-depth Keras 1 ResNet-50 topology with its filters
   narrowed 16x (176 vertices, seeded weights) on the card against the
   CPU, then one ``/fit`` on two seeded 224x224x3 minibatches of 8 and
   its archive restored on the card;
13. lm_persist — the slice phase's LM at full width (bf16 compute): 6
   ``fit_batch`` steps uninterrupted, twice (the card's own spread), and
   a run that commits ``save_training_checkpoint`` after step 3, applied
   to a fresh LM of other weights (in place), which takes 3 more steps:
   its parameters and ``m``/``v`` must equal the uninterrupted run's bits
   (or lie within the two uninterrupted runs' spread); each resumed step
   launches each flash kernel once a layer (the main path: counts set to
   0 just before the resumed steps); ``write_model`` then
   ``restore_model`` on the card: the same parameters, moments and
   ``output()`` bits, the archive's bytes and its write and restore
   seconds; ContinuousLM (16 slots, 8 requests of 64-token prompts, n_new
   32) over the saved LM against a ContinuousLM whose LM captured its
   programs with other weights and then took the archive in place: the
   same greedy tokens and no graph captured after the load; and a 2-layer
   copy with dropout 0.1 resumed the same way (the generator's state);
14. records — ``tests/fixtures/real_digits`` (1,500 training and 297
   held-out 8x8 digits): (1) written as CSV, through ``CSVRecordReader``,
   ``RecordReaderDataSetIterator`` (label column 64, 10 classes) and a
   ``NormalizerStandardize`` fitted over the iterator and set as its
   pre-processor into an MLN of two dense layers of 256 by
   ``fit(iterator)`` (30 epochs): held-out accuracy (bar 0.88) and
   images/s; 3 f32 steps on the card and on the CPU from the same
   weights (CPU_GPU_TOL); ``write_model(net, normalizer=...)``, then
   ``restore_model`` and ``restore_normalizer_from_file`` on the card,
   the held-out digits normalised on the card: the same bits as the host
   path and the same output bits; (2) one CSV file a digit (its rows, 8
   pixels and the label, cut to a seeded 4-8 rows) through
   ``CSVSequenceRecordReader`` and ``SequenceRecordReaderDataSetIterator``
   (ALIGN_END, masks), standardised over the real steps, into a
   GravesLSTM of 200 and an RnnOutputLayer per batch (10 epochs): the
   sequence and backward kernels' launches by the wrappers (the main
   path) and by ``torch.profiler`` over an epoch, the held-out accuracy
   at each digit's last row (bar 0.70), and one masked f32 batch on the
   card against the CPU (the charrnn phase's bars);
15. glove — bench.py's ``bench_word2vec`` corpus (30k words,
   ``default_rng(0)``) cut to its first 500,000 words, ``Glove`` at the
   reference's defaults (d 100, window 5, x_max 100, alpha 0.75, lr 0.05,
   batch 512; seed 42), 2 epochs, fitted twice: the co-occurrence build's
   seconds, the distinct pairs, pairs/s, the loss of each epoch (it must
   fall), peak memory, the two fits' embeddings the same bits (the
   sorted scatter), no package kernel; and a small corpus on the card
   against the CPU (GLOVE_CARD_CPU_RTOL);
16. deepwalk — a seeded undirected graph of 10,000 vertices (a ring and
   40,000 random edge lines) through ``GraphLoader`` from the edge-list
   file the phase writes, ``DeepWalk`` (vector 100, window 5, walk length
   40, a walk a vertex, hierarchical softmax): vertices/s and peak
   memory; then ``GraphVectorSerializer`` and ``WordVectorSerializer``'s
   text, Google binary and zip files of the card-trained model, read back
   on the card, within each format's precision;
17. fused_autotune — bench.py's ``bench_fused`` uncut: ``zoo.lenet_mnist``
   on the fixture's digits tiled to 160 batches of 128, through ``fit()``
   with the fusion autotuner armed (``DL4J_TORCH_FUSE_AUTOTUNE=1``,
   ``DL4J_TORCH_FUSE_STEPS`` unset) in a temporary tune cache: 8 warm-up
   batches, in which the probe times zero-weight groups at each rung of
   the ladder (1, 4, 8, 16) once, then the best of 2 timed fits with a
   checkpoint every 16 updates and the obs layer on (metrics and span
   tracing), against the per-batch arm (``DL4J_TORCH_FUSE_STEPS=1``). The
   timed fits must probe nothing and capture 0 graphs (one window graph
   in all); the autotuned fit must equal a fit pinned at the decided K
   bit for bit; a fresh model on the same cache directory, its memory
   dropped, must adopt K with 0 probes. It reports images/s of both
   arms, the decided K and each rung's seconds a step;
18. dropout_fused — ``zoo.alexnet`` as a MultiLayerNetwork (224x224x3,
   1,000 classes, dropout 0.5, batch 64) and ``zoo.googlenet`` as a
   ComputationGraph (head dropout 0.4, batch 32) on seeded images, each
   from the same parameters through the fused loop at K 8 and per batch:
   images/s, the busy share and the top device ops of both paths (2
   warm-up batches, 16 timed, 16 profiled, cuDNN's defaults); after 8
   batches the parameters and the draw counter the same bits (under
   ``cudnn.deterministic`` if the defaults differ); a
   ``nan-step`` poisoned inside a group of 8 gives the group without
   that batch, bit for bit; the retain fraction of the first dropout
   layer's masks over 16 draws within 5 binomial standard deviations of
   its retain probability; and two per-batch steps, the guard off, under
   ``torch.cuda.set_sync_debug_mode("warn")`` with no synchronising
   call;
19. graph_fused — ``charrnn_graph_conf()`` at full width (vocab 77, H 200,
   tBPTT 50) through ``ComputationGraph.fit(iterator)`` at K 8 on phase
   ``charrnn``'s data (2 warm-up and 8 timed batches of 32 x 200): one
   graph captured, in the warm-up; no wrapper call in the timed run,
   whose profile must count the sequence kernel 8 times and the backward
   kernel 400 times a batch (the ``kernels`` line's
   ``launches_graph_fused``); the parameters the MultiLayerNetwork's
   fused turn's bits from the same start; characters/s beside phase
   ``charrnn``'s fused turn; and a copy with retain 0.8 on the second
   GravesLSTM, fused against per batch, bit for bit
   (``launches_graph_fused_dropout``);
20. solvers — ``zoo.mlp_mnist`` at full width (784-1000-10) on the
   fixture's 320 digits as one batch under ``lbfgs``,
   ``conjugate_gradient`` and ``line_gradient_descent`` at ``iterations``
   10 through ``fit_batch``, on the card and on the CPU from the same
   parameters: the score falls on both; where every line search decided
   alike, the f32 parameters within SOLVER_CARD_CPU_RTOL; the same 10
   iterations in float64 (the model's loss over an f64 flat vector), the
   check for a line search that decides otherwise in f32, within
   SOLVER_F64_RTOL with every line search deciding alike; ms a call and
   forward evaluations an iteration. Then ``zoo.lenet_mnist`` under each of the
   six ``optax:*`` rules, 16 batches fused at K 8: the loss falls, card
   against CPU within OPTAX_CARD_CPU_RTOL (lion: 2 lr a step), and
   ``optax:adamw`` resumed from a checkpoint mid-fit equals the
   uninterrupted run bit for bit;
21. pretrain — layer-wise pretraining on the fixture's real MNIST
   digits (320 and 64 held out) at dl4j-examples 0.7's widths:
   VariationalAutoEncoderExample's VAE through ``net.pretrain(iterator,
   epochs=20)`` (the negative ELBO by epoch, which must fall, examples/s,
   ``reconstruction_log_probability`` of the 64 held-out digits, and one
   step against the CPU with the same eps injected, PRETRAIN_CARD_CPU_RTOL);
   the same VAE as a graph vertex through ``pretrain_vertex`` against the
   MLN's layer on the same draws (PRETRAIN_VERTEX_TOL);
   DeepAutoEncoderExample's binary RBM stack, each RBM's reconstruction
   error before and after its pass, then ``fit()`` (pretraining once more,
   its contract, then backprop; a second fit does not pretrain) and the
   reconstruction MSE, with its two cuts (SGD, batch 320) in the output;
   and a denoising AutoEncoder 784 -> 1000 at corruption 0.3;
22. transfer — the char-RNN at phase ``charrnn``'s widths: a base of 8
   batches, ``TransferLearning.Builder(base).set_feature_extractor(0)
   .n_out_replace(2, 77)``, fine-tuned under an ``EarlyStoppingTrainer``
   (8 batches an epoch, 2 held out through ``DataSetLossCalculator``,
   ``MaxEpochsTerminationCondition(4)``,
   ``ScoreImprovementEpochTerminationCondition(2)``, a
   ``LocalFileModelSaver``) with a ``ProfilerListener`` over iterations
   [2, 4): layer 0 and the base net bitwise unchanged, the result, the
   restored best model's output bits equal to the saved net's, the
   trace's LSTM kernel events, the wrappers' launches (the ``kernels``
   line's ``launches_transfer``) and ms a batch;
23. gradcheck — the gradient checker in float64 on the card: an MLP under
   each loss, a conv/max-pool/BN/dense net, the VAE's supervised forward
   under an output layer and a two-input graph must pass
   (GRADCHECK_MAX_REL), each analytic gradient within GRADCHECK_CARD_CPU
   of the CPU's; a GravesLSTM net's check must raise the LSTM kernels'
   ``TypeError`` (they take f32 and bf16 only);
24. tsne_kmeans — the fixture's 1,797 digits whole: ``KMeansClustering``
   (k 10, k-means++, at most 100 iterations) on the card against the CPU
   (assignments agreeing, KMEANS' bar), exact ``Tsne`` (perplexity 30,
   1,000 iterations) on both (KL within TSNE's bar) and ``BarnesHutTsne``
   on the host, cut (BH_TSNE_CUT), timed;
25. vit — ViT-B/16 as published (224x224x3, patch 16, d 768, 12 heads,
   12 layers, MLP 3072; 85,804,810 parameters with a 10-class head) in
   bf16 with f32 masters at AdamW's fine-tuning rate 1e-5, on batch 64
   of the fetchers' seeded class prototypes plus noise: 2 warm-up and
   10 timed ``fit_batch`` steps (ms a step, images/s, MFU on 6 x
   parameters x tokens plus the attention products against the bf16
   peak, peak memory); the loss finite and falling, 12 launches of each
   flash kernel a step by the wrappers and by ``torch.profiler`` over one
   more step (busy share, top device ops), every leaf's gradient finite
   and non-zero; 16 concurrent requests through ``InferenceServer``, rows
   equal to ``output()`` of their batch and no backward launch; a 2-layer
   f32 copy's logits and one step's gradients on the card against the
   CPU within VIT_CARD_CPU_RTOL; tests/test_vit.py's learner through
   ``fit(DigitsDataSetIterator)`` (150 batches of 64 real digits) to its
   0.85 train accuracy, the held-out accuracy beside, and its archive
   restored to the same ``output()`` bits;
26. moe — the MoE LM at the slice's widths (V 32768, T 512, d 512, L 8,
   H 8, ff 2048, bf16, flash block 128; 4 experts in every 2nd block,
   top-1, aux 0.01; 67,464,192 parameters) on batch 32 of a seeded token
   chain: at the initial weights every expert of every MoE block takes
   tokens and gets a gradient; 2 warm-up and 10 timed ``fit_batch``
   steps, the loss finite and falling, 8 launches of each flash kernel a
   step; tokens/s, ms a step, peak memory, MFU on the active (top-1)
   FLOPs and on the executed ones (dense routing runs every expert), the
   tokens each expert takes after the timed steps; 16 requests served
   as in ``vit``; ``generate()``, ``beam_search()`` and ``ContinuousLM``
   refused with the reference's words; a copy cut to 2 layers written and
   restored, ``output()`` and one further step the same bits; and 2-layer
   f32 copies, top-1 and top-2, with weights drawn on the CPU: each
   token's routing equal on the card and the CPU, the smallest gate
   margins beside (they must exceed MOE_MARGIN), logits within
   CPU_GPU_TOL, one step within the train phase's bars;
27. dp — data parallelism over ``torch.distributed``. (a) In this
   process, a world of one rank over NCCL on the card: the slice's LM
   (batch 32 x 512, bf16) unsharded and after ``shard(level=L)`` for each
   ZeRO level L, from the same parameters on the same batch, 2 warm-up
   and 5 timed ``fit_batch`` steps each: 8 launches of each flash kernel
   a step by the wrappers, ms a step, tokens/s, peak memory and the state
   bytes beside the unsharded run's, losses and parameters bit for bit
   the unsharded run's (a plan of width 1 skips every collective, as XLA
   does on one device); ``ParallelWrapper`` over the full-width char-RNN
   through ``fit()`` on phase ``charrnn``'s batches: the fused loop, each
   window a replayed CUDA graph, 8 sequence and 400 backward LSTM
   launches a batch by ``torch.profiler``, the parameters bit for bit
   ``net.fit``'s on the same stream. (b) Two rank processes over gloo,
   both on the card (``chip_smoke.py --dp-rank``, started by the phase),
   at each level of DP_GLOO_LEVELS: the char-RNN through
   ``ParallelWrapper`` on 4 global batches of 32 (16 rows a rank), each
   rank's LSTM launches for its rows, rank 0's parameters within
   DP_W2_PARAM_RTOL of world 1's on the same batches, the updater
   state's bytes a rank halved from level 1 and the parameters' at level
   3, peak memory a rank; and a 2-layer LM at the slice's widths through
   ``shard``, 2 steps, 2 launches of each flash kernel a step a rank, the
   ranks' losses equal and within DP_W2_LOSS_RTOL of world 1's;
28. scaleout — the scaleout stack on phase ``charrnn``'s net at full
   width and its batches of 32, the coordinator the native one
   (``nativelib.py``, built in phase ``build``): (a)
   ``ParameterAveragingTrainingMaster`` with one thread worker averaging
   every batch, 4 batches: parameters bit for bit plain ``fit_batch``'s,
   the updater vector within SCALEOUT_UPDATER_TOL; (b) two thread
   workers averaging every 5 batches over 20 (2 splits; the main path):
   parameters and updater vector against a yardstick written out here
   (two replicas fitting their batches from the broadcast state, their
   float32 sums halved), bitwise or within SCALEOUT_YARDSTICK_RTOL; a
   second run the same bits, its 160 + 8,000 LSTM launches by the
   wrappers (the ``kernels`` line's ``launches_scaleout``), ms a split,
   characters/s, the master's ``broadcast``/``aggregate`` seconds; a
   third run profiled for the card's busy share; (c) the same splits
   through two ``parallel/worker.py`` processes on the card in Export
   mode: parameters within SCALEOUT_PROCESS_TOL of (b)'s, each worker's
   own launch counts (``launches_scaleout_process``), the seconds with
   and without the spawn; (d) ``ParameterServerParallelWrapper``: one
   trainer pulling every step within SCALEOUT_PS_TOL of ``fit_batch``
   after one batch and, over 4, bit for bit the sequential fit through
   the server's float32 arithmetic; two trainers over 16 batches lower
   the held-out loss; (e) ``DistributedWord2Vec`` at phase
   ``word2vec``'s configuration: one worker bit for bit ``Word2Vec``'s
   tables, two worker threads (each capturing its graphs) bit for bit
   their replicas fitted in turn and averaged, words/s; the reference
   test's topic check on the card;
29. ui — the training UI (after phases ``elastic``, ``shard_ckpt``,
   ``tp``, ``pp``, ``sp`` and ``ep``): phase ``charrnn``'s char-RNN at
   full width through the fused loop (a warm-up of 2 batches captures
   the window graph, then runs of 8 batches, the counts set to 0 just
   before each) without a listener and with a ``StatsListener`` at
   frequency 1 writing through one router into a ``FileStatsStorage``
   and, by ``RemoteUIStatsStorageRouter``, into a ``UIServer`` on
   127.0.0.1: the LSTM kernels by ``torch.profiler`` the same in both
   runs (8 sequence and 400 backward launches a batch; the wrappers 0,
   every window a replay), the last report's parameter and gradient
   summaries equal to ``_summary`` of the model's own tensors and last
   gradients fetched after the group, ``device0_bytes_in_use`` above 0
   and at most ``device0_bytes_limit``, the server's records equal to
   the file's; ms a batch without the listener and at frequencies 1 and
   10; ``zoo.lenet_mnist`` on the fixture's digits with a
   ``ConvolutionalIterationListener``: the PNG that
   ``/train/activations`` serves within 1 grey level of the CPU port's
   grid from the same parameters; every GET endpoint answers 200;
30. streaming — a ``MessageBroker`` on 127.0.0.1 and a ``DL4JServeRoute``
   over the slice's LM (bf16, the flash route): 16 messages of one row
   of 128 tokens, each prediction the bits of a direct ``output()`` of
   its row, 8 forward flash launches a message, then a poison message:
   ``errors`` 1 and ``last_error`` its own; messages/s and latency
   p50/p99; ``InferenceHTTPServer``: ``/predict`` on phase ``ui``'s
   LeNet the bits of its ``output()``, ``/generate`` at temperature 0
   the tokens of a direct ``generate()``, a garbage body a 400;
31. nlp_text — ``BpeTokenizer.train`` at vocab 512 over ``SURVEY.md``
   (seconds); its ids feed the slice's LM at the BPE vocabulary: a
   warm-up and 3 timed ``fit_batch`` steps at batch 32 x 512 on the flash
   route, the losses finite and falling, 8 launches of each flash kernel
   a step, tokens/s, and a 2-layer f32 copy on 2 rows of the ids card
   against CPU within phase ``train``'s bars; ``TfidfVectorizer`` over
   the treebank fixture's sentences into a dense classifier trained on
   the card and on the CPU from the same parameters, outputs within
   NLP_TFIDF_TOL; Word2Vec on the card over the Japanese and the Korean
   tokenizers' streams, each vocabulary the tokenizer's own tokens;
   ``TreeVectorizer`` with the Japanese Word2Vec as its lookup, each
   leaf's vector the bits of the table's row;
32. watch — the port's runtime watchers (``testing/``) on the card,
   within 90 s: (a) lockwatch and leakwatch over the slice's LM behind
   ``InferenceServer`` (16 concurrent 512-token requests, served rows
   equal to ``output()`` of their batch bitwise and 8 forward launches a batch,
   no backward), a ``ContinuousLM`` over it (``warm_start()``, then 8
   sampled generations at temperature 0.8 with seeds 0-7) and the serve
   route (4 messages), everything shut down: zero lock-order
   inversions (the edge count printed, and the edges that take the
   device's graph lock) and nothing left live; (b) compilewatch: the
   warm-up's captures equal ``len(graph_inventory())`` and its budget
   (3 x KV rungs + 2 x prefill rungs + 1), all of the decode pool's
   family, and the generations capture and build nothing inside
   ``steady()``; the full-width char-RNN fits 2 fused batches (the
   window graph, attributed to ``models/_layered.py``'s family), then 4
   at K 4 inside ``steady()``, profiled: nothing captured or built, 32
   sequence and 1,600 backward LSTM kernels, no wrapper call; (c)
   rngwatch over all of the above and a dropout MLN's 2 fused and 2
   per-batch steps: no stream drawn at two sites (the draws it sees are
   the eager ones: a draw inside a capture, decode's replayed Gumbel
   noise among them, is skipped), and the 8 seeds give 8 distinct rows;
   (d) on the card's
   process, each watcher catches its fixture's defect at its line
   (``tests/fixtures/lockwatch/inversion.py``, ``leakwatch/leaky.py``,
   ``torch_watch/recapture.py`` on the card, ``torch_watch/
   rng_reuse.py`` with a CUDA generator) and stays clean on the clean
   twins; (e) requests/s (32 requests a turn), decode tokens/s and the
   char-RNN's ms a batch (12 batches a turn) bare, with the four
   watchers and with lockwatch alone, 3 turns each in rotation, each
   with servers of its own, beside the bare turns' spread;
33. order_check — the narrow ResNet's f32 check of phase ``resnet50``
   again, after phases ``decode``, ``serve_scale``, ``word2vec``,
   ``attention``, ``keras``, ``lm_persist``, ``records``, ``glove``,
   ``deepwalk`` and those above.

Every line before the last is a JSON object or the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

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
    # phase vit's attention: 64 images x 12 heads, 196 patches (no multiple
    # of a tile: the ragged edge), non-causal
    ("vit", 768, 768, 196, 64, False, None, False),
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
# the attention phase: an MLN of two SelfAttentionLayers and an
# RnnOutputLayer at the attention shape of bench.py's bench_transformer_lm
# (bench.py:708): d 512, 8 heads of 64, T 512, batch 32, causal
ATTN = dict(d_model=512, n_heads=8, seq_len=512, batch=32, n_classes=32)
ATTN_WARMUP = 2
ATTN_STEPS = 10
ATTN_FUSED_BATCHES = 4     # fit(iterator): fused against per batch
ATTN_F32_RTOL = 1e-5       # kernel against the built-in path, f32
# the keras phase: the committed files of tests/fixtures/keras
KERAS_FIXTURES = ("tests", "fixtures", "keras")
KERAS_FIT = dict(epochs=2, batch=64)
KERAS_CARD_CPU_RTOL = 1e-5
# the lm_persist phase: the slice's LM at full width saved and resumed:
# 6 fit_batch steps uninterrupted (twice, the card's own spread), and 3,
# a training checkpoint, a fresh LM resumed from it, 3 more; the archive
# through write_model/restore_model; ContinuousLM over the restored
# weights; a 2-layer dropout copy resumed the same way
LM_PERSIST = dict(steps=6, save_after=3, batch=TRAIN_BATCH, out_rows=2)
LM_PERSIST_SERVE = dict(slots=16, chunk=8, requests=8, prompt=64, n_new=32)
LM_PERSIST_DROPOUT = dict(n_layers=2, dropout=0.1)
# the records phase: tests/fixtures/real_digits (1,500 training and 297
# held-out 8x8 UCI digits) as CSV into fit(iterator), and as one CSV
# sequence file a digit (its rows, cut to a seeded 4-8) into a GravesLSTM
DIGITS_FIXTURE = ("tests", "fixtures", "real_digits")
RECORDS_MLN = dict(hidden=256, batch=64, epochs=30, lr=1e-3, seed=SEED + 7)
# held-out bars: the dense net reached 0.91-0.93 over 4 init seeds on the
# CPU, the sequence LSTM 0.80-0.82 over 2 (10 epochs; a digit cut to 4-8
# of its 8 rows): the card draws other initial weights, so the bars leave
# room (chance is 0.10)
RECORDS_HELD_OUT_BAR = 0.88
RECORDS_CPU_STEPS = 3
RECORDS_SEQ = dict(hidden=200, batch=32, epochs=10, lr=5e-3, min_len=4,
                   max_len=8, seed=SEED + 8)
RECORDS_SEQ_BAR = 0.70     # held-out accuracy at each digit's last row
# the glove phase: bench.py:bench_word2vec's corpus (default_rng(0), 30k
# words, sentences of 1000) cut to its first 500,000 words, Glove at the
# reference's defaults (d 100, window 5, x_max 100, alpha 0.75, lr 0.05,
# batch 512; seed 42, bench's model seed), 2 epochs, fitted twice
GLOVE = dict(vocab=30_000, full_total=2_000_000, total=500_000,
             sent_len=1000, corpus_seed=0, layer_size=100, window=5,
             x_max=100.0, alpha=0.75, learning_rate=0.05, batch_size=512,
             epochs=2, seed=42)
# card against CPU: a small corpus from the same seed, f32; the tables
# within the CPU test's bar against the reference (tests/test_torch_glove.py
# TABLE_REL): 1e-5 of the embedding's max abs
GLOVE_SMALL = dict(vocab=300, total=20_000, sent_len=100, layer_size=32,
                   epochs=2, batch_size=512, seed=7)
GLOVE_CARD_CPU_RTOL = 1e-5
# the deepwalk phase: a seeded undirected graph of 10,000 vertices and
# ~50,000 edge lines, through GraphLoader from the edge-list file the phase
# writes; DeepWalk (vector 100, window 5, walk length 40, a walk a vertex,
# hierarchical softmax)
DEEPWALK = dict(vertices=10_000, edges=50_000, vector_size=100,
                window_size=5, walk_length=40, walks_per_vertex=1,
                batch_size=512, seed=SEED + 9)
# the text format's %.6f: half a unit, then the f32 rounding of the value
# read back (one f32 step of it)
TEXT_ATOL, TEXT_RTOL = 5e-7, 2.0 ** -23
# phase fused_autotune: bench.py's bench_fused uncut (LeNet, batch 128,
# 160 batches, 8 warm-up batches in which the probe runs, best of 2 timed
# fits with a checkpoint every 16 updates)
FUSED_AUTOTUNE = dict(batch=LENET_BATCH, batches=LENET_BATCHES, warmup=8,
                      ckpt_every=16, fits=2)
# phase dropout_fused: the zoo's AlexNet (an MLN, dropout 0.5 on its two
# 4096-wide layers) and GoogLeNet (a graph, head dropout 0.4) at full
# width on seeded images, 16 batches each path
DROPOUT_FUSED = {"alexnet": dict(batch=64, batches=16, retain=0.5),
                 "googlenet": dict(batch=32, batches=16, retain=0.4)}
# phase solvers: zoo.mlp_mnist (784-1000-10) on the fixture's 320 digits
# as one batch, 10 solver iterations a call; the card against the CPU
# (TF32 off): the f32 parameters within SOLVER_CARD_CPU_RTOL of their max
# abs where every line search decided alike, and in float64 within
# SOLVER_F64_RTOL, every line search deciding alike
SOLVERS = dict(model="zoo.mlp_mnist (784-1000-10)", rows=320, iterations=10)
# spin kernels that open every profile (see ``profiled``)
PROFILE_WARM = 1000
SOLVER_CARD_CPU_RTOL = 1e-4
SOLVER_F64_RTOL = 1e-9
# LeNet under each optax rule, 16 batches fused at K 8: learning rates,
# and the card's parameters within OPTAX_CARD_CPU_RTOL of the CPU's
# (lion: each element within 2 lr a step, its sign's flip)
OPTAX_LR = {"adam": 1e-3, "adamw": 1e-3, "lion": 1e-4, "lamb": 1e-3,
            "sgd": 1e-2, "rmsprop": 1e-3}
OPTAX_CARD_CPU_RTOL = 1e-3
# rmsprop's bar is derived instead: DP_W2_CHAOS times the relative drift
# of a CPU run from parameters perturbed by DP_W2_PERTURB, measured in
# the same run, so that it holds on any input
OPTAX_DERIVED_BAR = ("rmsprop",)
# phase pretrain: dl4j-examples 0.7's VariationalAutoEncoderExample (784 ->
# encoder 256, 256 -> latent 2 -> decoder 256, 256 -> Bernoulli over 784,
# leaky ReLU, rmsprop 1e-3, l2 1e-4, xavier, batch 128, 20 epochs) and
# DeepAutoEncoderExample (binary RBMs 784-1000-500-250-100-30, the
# mirror, an OutputLayer 1000 -> 784; SGD at the default lr 0.1 and batch
# 320 are the cuts; 60 updates a pass, as the example's one pass over
# 60,000 digits at batch 1,000), and a denoising AutoEncoder of the
# phase's own
PRETRAIN_VAE = dict(encoder=(256, 256), latent=2, decoder=(256, 256),
                    lr=1e-3, l2=1e-4, batch=128, epochs=20, seed=12345,
                    log_prob_samples=16)
PRETRAIN_DEEP_AE = dict(encoder=(1000, 500, 250, 100, 30), batch=320,
                        lr=0.1, seed=123, pass_epochs=60,
                        backprop_epochs=60)
PRETRAIN_DAE = dict(n_out=1000, corruption=0.3, lr=0.1, batch=128,
                    epochs=10)
PRETRAIN_CARD_CPU_RTOL = 1e-5   # one VAE step, the same eps injected
PRETRAIN_VERTEX_TOL = 1e-6      # the VAE as a graph vertex and as a layer
# phase transfer: the char-RNN of phase charrnn (its CHARRNN widths and
# corpus), a base of 8 batches, then layer 0 frozen and the head replaced,
# fine-tuned under the EarlyStoppingTrainer on 8 batches an epoch against
# 2 held-out batches; the ProfilerListener's window
TRANSFER = dict(base=8, train=8, held_out=2, max_epochs=4, patience=2,
                profile_start=2, profile_iterations=2)
# phase gradcheck, float64 on the card: the checker's bar (the reference's
# default) and the card's analytic gradient against the CPU's
GRADCHECK_MAX_REL = 1e-3
GRADCHECK_CARD_CPU = 1e-10
# phase tsne_kmeans on the 1,797 digits: scikit-learn's demos' settings
KMEANS = dict(k=10, init="kmeans++", max_iterations=100,
              agreement_bar=0.99)
TSNE = dict(perplexity=30.0, max_iter=1000, kl_rel_bar=0.05)
BH_TSNE = dict(theta=0.5, max_iter=20, points=300)
BH_TSNE_CUT = ("300 points and 20 iterations in place of 1,797 and 300: "
               "the Barnes-Hut trees are host Python, as the reference's, "
               "and the whole set's 300 iterations do not fit the run's "
               "time limit")
# phase vit: ViT-B/16 as published (Dosovitskiy et al., "An Image is Worth
# 16x16 Words", ICLR 2021, Table 1) with a 10-class head, bf16 compute, at
# AdamW's fine-tuning rate 1e-5: the configuration has no warmup, and
# without one the first steps at the default 3e-4 (and at 3e-5 on the
# CPU) throw the loss from 2.4 to 5-7
VIT_B16 = dict(image_size=224, n_channels=3, patch_size=16, n_classes=10,
               d_model=768, n_heads=12, n_layers=12, d_ff=3072,
               compute_dtype="bfloat16", learning_rate=1e-5, seed=SEED)
VIT_BATCH = 64
VIT_WARMUP = 2
VIT_STEPS = 10
VIT_REQUESTS = 16
# the f32 copy on the card against the CPU: the flash kernels' f32 bar,
# relative to each tensor's max abs (logits, each gradient leaf)
VIT_CPU_CHECK = dict(n_layers=2, batch=2)
VIT_CARD_CPU_RTOL = 1e-5
# tests/test_vit.py's learner on the committed real digits: its width,
# its 150 batches of 64 (320 digits, 30 epochs of 5) and its bar
VIT_DIGITS = dict(image_size=8, n_channels=1, patch_size=2, n_classes=10,
                  d_model=64, n_heads=4, n_layers=2, d_ff=128,
                  learning_rate=1e-3, seed=SEED)
VIT_DIGITS_FIT = dict(examples=320, batch=64, epochs=30, train_bar=0.85)
# phase moe: the slice LM's widths as an MoETransformerConfig at the
# reference's defaults (4 experts every 2nd block, top-1, aux 0.01)
MOE = dict(SLICE, n_experts=4, moe_every=2, router_top_k=1, aux_weight=0.01)
MOE_WARMUP = 2
MOE_STEPS = 10
MOE_REQUESTS = 16
# the archive round trip at full width cut to 2 layers (one MoE block):
# the full depth's ~800 MB archive takes over a minute to deflate
MOE_ARCHIVE_LAYERS = 2
# the 2-layer f32 copy on the card against the CPU, top-1 and top-2: the
# weights drawn on the CPU from this seed, whose every gate margin (top-1
# against top-2, and top-2 against top-3) exceeds MOE_MARGIN, so a route
# that flips fails as a flip, not as a numerics error
MOE_CPU_CHECK = dict(n_layers=2, batch=2, seed=SEED + 4)
MOE_MARGIN = 1e-3
MOE_CARD_CPU_RTOL = 1e-4   # the train phase's bars: V 32768 products

# phase dp: data parallelism (parallel/). World 1 (NCCL, this process):
# the slice's LM unsharded and at each level (DP_LM_WARMUP + DP_LM_STEPS
# steps), ParallelWrapper over the char-RNN through the fused loop.
# World 2: two rank processes over gloo on the one card (NCCL refuses two
# ranks on one device: "Duplicate GPU detected"; PERF.md), at the levels
# DP_GLOO_LEVELS: a probe on the H100's torch 2.11 found every collective
# the core calls (all_reduce, broadcast, all_gather_into_tensor,
# reduce_scatter_tensor) taking CUDA tensors under gloo, so all four run
# there and none is "CPU tests only" (tests/test_torch_dp_shard.py holds
# all four at world 4 on the CPU)
DP_LEVELS = (0, 1, 2, 3)
DP_GLOO_LEVELS = (0, 1, 2, 3)
DP_LM_WARMUP = 2
DP_LM_STEPS = 5
DP_CHARRNN_BATCHES = 4          # global batch 32: 16 rows a rank
DP_LM2 = dict(SLICE, n_layers=2)
DP_LM2_STEPS = 2
# world 2 against world 1 on the same batches. The gradients are the mean
# of two 16-row means, summed in another order, and the kernels reduce
# over 16 rows, not 32: f32 rounding. After one update (a tBPTT window)
# the char-RNN's parameters agree within DP_W2_STEP_RTOL of their max
# abs. Early rmsprop steps are near the gradient's sign, and the LSTM
# carries a difference on from window to window, so such rounding grows:
# on the CPU, parameters drawn 1e-7 apart (relative) are 2e-6, 5e-5 and
# 4e-4 apart after 1, 2 and 4 windows and 1.4-2.3% (relative L2) after
# the 16 updates of 4 batches. So after 4 batches world 2's relative L2
# distance from world 1 is held to DP_W2_CHAOS times that of a world-1
# run from the initial parameters perturbed by 1e-7 (seeded), measured
# in the same run. The LM's losses within DP_W2_LOSS_RTOL (bf16 GEMMs on
# half the rows may round each logit otherwise, ~2^-8 relative, averaged
# over 8,176 tokens a rank)
DP_W2_STEP_RTOL = 1e-5
DP_W2_CHAOS = 10.0
DP_W2_PERTURB = 1e-7
DP_W2_LOSS_RTOL = 1e-3
DP_WORLD2_TIMEOUT_S = 400
# phase dp, extended: phase solvers' LeNet under lbfgs through
# ParallelWrapper at ZeRO level 3 (the first DP_SOLVER["batches"] global
# batches of the fixture's digits) and phase pretrain's VAE pretrained
# under an injected level-3 plan, each rank on its rows, both at world 2
# against world 1 on the global batches; each bar DP_W2_CHAOS times the
# relative L2 drift of a world-1 run from parameters perturbed by
# DP_W2_PERTURB
DP_SOLVER = dict(batch=128, batches=2, iterations=10, level=3)
DP_VAE = dict(batch=64, batches=5, epochs=2, level=3)

# phase elastic: parallel/elastic.py on phase charrnn's net and batches,
# uncut (H 200, tBPTT 50, batch 32, rmsprop), ZeRO level 3, the per-batch
# loop; a checkpoint every batch (4 updates: 200 steps over tBPTT 50).
# The round deadline (ELASTIC["timeout"]) also bounds every collective of
# the trainers' process groups; a wave settles in 1/20 of ELASTIC
# ["reform"]
ELASTIC = dict(batches=8, level=3, every=4, timeout=30.0, reform=6.0)
ELASTIC_KILL_AT = 3          # trainer 1's heartbeat: after batch 4
# the slow case: one trainer and a member, width 1, so the trainer's
# group is NCCL's world of one (multihost.choose_backend); that group
# starts in 0.59-0.71 s, so its round deadline is 2 s, and the member
# sleeps 3 s past it
ELASTIC_SLOW = dict(timeout=2.0, sleep=5.0, at=3)
ELASTIC_TIMEOUT_S = 300

# phase shard_ckpt: the slice's LM (SLICE: d 512, L 8, vocab 32768, bf16)
# at world 2, ZeRO level 3, trained 2 steps at phase train's batch, then
# saved as per-rank shards and restored at world 2 level 1 and at width 1
SHARD_CKPT = dict(steps=2, n_layers=SLICE["n_layers"])
SHARD_CKPT_TIMEOUT_S = 400

# phase tp: TPTransformerLM at SLICE's widths with block_size=None (the
# reference refuses the flash route there), TP 2 over two ranks sharing
# the card over gloo, 3 steps at phase train's batch, bf16. It rounds each
# row-parallel partial product to bf16 before the all-reduce, one
# rounding more a block than the single-device LM; its yardstick is the
# single-device run from every parameter moved by TP_PERTURB (relative,
# half a bf16 ulp, one such rounding). The distance is taken on the
# update (the parameters' change over the steps): |d_tp - d_single| /
# |d_single| within TP_CHAOS times the perturbed run's |d_pert -
# d_single| / |d_single|, and that bar must reject an unchanged state
# (whose distance is 1). The losses at phase dp's bf16 loss bar
# (DP_W2_LOSS_RTOL: a loss over 16,352 tokens of bf16 logits; the
# perturbed run's loss difference is printed beside it, but a mean over
# so many tokens moves too little, and too erratically, to gate on it:
# 3e-5 to 1.2e-4 on the CPU rehearsal at 2^-9 to 2^-7). The
# TensorParallelMLP at
# TP 2 (784-1024-10, plain SGD) against its single-rank run, at phase
# dp's f32 bar (DP_W2_CHAOS x a DP_W2_PERTURB run). The same TP steps in
# f32 on TP_F32["rows"] rows at the same widths, against the
# single-device LM: the gathered logits before the steps (the forward)
# and each step's loss within TP_F32["rel"] of their max abs, the CPU
# test's bar (tests/test_torch_tensor_parallel.py); the logits after the
# steps within TP_CHAOS times the drift of the single-device run from
# parameters perturbed by TP_F32["perturb"] (relative; the CPU test's
# parameter yardstick), because AdamW turns a gradient element that
# rounding moves across zero into a learning-rate-sized step: at these
# widths 1e-5 of the max abs does not hold after the steps (7.29e-5
# against a bar of 2.88e-5 on the H100). Both bars must reject an
# unchanged state (the single-device LM's logits before its steps) and
# the same TP run with the backward all-reduce of copy_to_model
# (Megatron's f) dropped
TP = dict(steps=3, n_layers=SLICE["n_layers"])
TP_F32 = dict(rows=2, rel=1e-5, perturb=1e-7)
TP_PERTURB = 2.0 ** -9
TP_CHAOS = 10.0
TP_MLP = dict(dims=(784, 1024, 10), batch=256, lr=0.1, steps=10)
TP_TIMEOUT_S = 400
# the process groups of phases shard_ckpt, tp, pp, sp and ep bound every
# collective (and their rendezvous) by this, so a rank whose peer died
# raises
WORLD2_GROUP_TIMEOUT_S = 300

# phases pp, sp and ep: the model-parallel trainers, each on ranks sharing
# the card over gloo (NCCL refuses two ranks on one device; gloo's send
# and recv take host memory only, so the point-to-point transfers go
# through pinned host buffers, multihost.exchange, and are counted),
# MP["steps"] steps each, held against the single-device model from the
# same parameters on phase tp's bars: the bf16 update within TP_CHAOS x a
# TP_PERTURB run's, which must reject an unchanged state (and the run
# with the strategy's collective removed is measured against it), the
# losses at DP_W2_LOSS_RTOL; an f32 copy on a few rows, the forward's
# logits and the losses within TP_F32["rel"] of their max abs and the
# logits after the steps within TP_CHAOS x a TP_F32["perturb"] run's
# drift, bars that must reject an unchanged state and the run with the
# collective removed.
# pp: PPTransformerLM at the slice's widths and depth on its flash route
# (block_size 128: kernels 1-3 in every stage, forward and backward),
# S 2 x M 4, phase train's batch (32 x 511); the control drops the
# backward's sends (a stage's output gradient zero); the f32 copy on
# TP_F32["rows"] rows as 2 microbatches of 1. PipelineParallelNet at
# TP_MLP's widths (784-1024-10, batch 256), 2 stages x 4 microbatches,
# against its unpipelined math on one device (DP_W2_CHAOS x a
# DP_W2_PERTURB run)
MP = dict(steps=3)
MP_TIMEOUT_S = 400
FLASH = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")
PP = dict(stages=2, micro=4)
PP_SHARD_FRACTION = 29649920 / 42259456   # (replicated + L/2 blocks) / all
# sp: SPTransformerLM at the slice's widths and depth with block_size None
# (the reference refuses flash under the ring), N 2, 32 rows of T 512
# (max_len); the control replaces the ring's rotation by the identity
# (each rank attends its own K/V block at every step). Then ring
# (sequence_parallel_attention) and Ulysses attention at one layer's
# shape SP_ATTN ([B, H, T, hd], f32, causal) against dense_attention
# within TP_F32["rel"] of its max abs
SP = dict(ranks=2, t=512)
SP_ATTN = (32, 8, 512, 64)
# ep: EPTransformerLM at phase moe's configuration (MOE: top-1, aux 0.01)
# with block_size None (the reference refuses flash there), E 4 over four
# ranks, phase train's batch, lossless capacity (8 rows x 511 tokens a
# rank); its aux term is the reference's local approximation (each rank's
# tokens' f.P, averaged), not the dense model's global one. The f32 copy
# at aux 0 (exact) on EP_F32_ROWS rows (B % E: one a rank); the control
# replaces the all_to_all by the identity (each rank's tokens to its own
# expert). ExpertParallelMoE (d 512, hidden 2048, 10 classes, batch 256)
# at world 4: its sharded forward within 1e-5 of its dense oracle, 10 SGD
# steps against its dense math on one device (DP_W2_CHAOS x a
# DP_W2_PERTURB run)
# The update bar is not gated in ep: top-1 routing under Adam is chaotic
# at any rounding-level difference. A perturbation of the dense MoE LM's
# parameters moves a few tokens between experts at the first step, and
# Adam's first steps are about lr times the gradient's sign, so the
# update lands about 0.2-0.3 (relative L2) from the unperturbed run's at
# TP_PERTURB and at EP_FLOOR_PERTURB (far below one bf16 rounding)
# alike, most of it in the experts' leaves: ten times that cannot reject
# an unchanged state. The phase prints the update's distance beside both
# yardsticks and gates the bf16 run on its losses (DP_W2_LOSS_RTOL, which
# both controls fail: an unchanged state's losses are the first step's,
# and the identity control routes every token to its rank's expert) and
# on the f32 copy (exact at aux 0)
EP = dict(ranks=4)
EP_F32_ROWS = 4
EP_FLOOR_PERTURB = 2.0 ** -18
EP_MOE = dict(d=512, hidden=2048, n_out=10, batch=256, lr=0.1, steps=10)

# the scaleout phase: the training master, the parameter server and
# distributed Word2Vec on phase charrnn's net at full width and on its
# seeded batches of 32 (the shape of the kernel rows 4-5); dl4j-examples'
# SparkLSTMCharacterExample averages every 5 batches
SCALEOUT = dict(batch=32, parity_batches=4, workers=2, averaging_frequency=5,
                batches=20, ps_equal_batches=4, ps_batches=16, ps_workers=2)
SCALEOUT_UPDATER_TOL = 1e-6      # the parity gate's updater vector
SCALEOUT_YARDSTICK_RTOL = 1e-7   # thread mode against its yardstick
SCALEOUT_PROCESS_TOL = 1e-6      # process mode against thread mode
SCALEOUT_PS_TOL = 1e-5           # one trainer against sequential fit_batch
SCALEOUT_TIMEOUT_S = 300         # the process mode's join
# the topic corpus of tests/test_nlp_distributed.py:81-99 and its fit
SCALEOUT_TOPICS = dict(sentences=150, seed=3, epochs=3, layer_size=24,
                       window=4, negative=5, min_word_frequency=1, seed_fit=7,
                       batch_size=128)

# phase keras, extended: the committed narrow ResNet-50 topology
KERAS_RESNET50 = dict(file="resnet50_narrow_k1_tf.h5", images=4,
                      fit_batches=2, fit_batch=8)


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
    """nvcc for every kernel and g++ for the native library
    (``nativelib.py``: the coordinator, the CSV and idx readers), all
    started together; the phase fails if the library does not load."""
    from deeplearning4j_tpu_torch import nativelib
    from deeplearning4j_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(nativelib.ensure_built)
        logs = _build.build_all()
        native_ok = native.result()
    seconds = time.perf_counter() - t0
    assert native_ok, f"the native library did not build: " \
        f"{nativelib.build_error()}"
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        emit({"phase": "build", "kernel": name, "ptxas": usage,
              "routes": kernel_routes(name, log)})
    d256 = d256_usage(logs)
    emit({"phase": "build", "seconds": seconds, "d256_instances": d256,
          "native_library": str(nativelib.LIB_PATH.relative_to(
              Path(__file__).resolve().parent)), "card": card})
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


def train_card_vs_cpu(conf, rng, toks=None):
    """One f32 step's loss and gradients of a 2-layer copy of the model
    at full width, T ``CPU_CHECK_T``, batch 2: on the card (the kernels)
    and on the CPU (their twins), from the same weights; on ``toks``
    ([2, CPU_CHECK_T + 1] int64 on the CPU) or on rows drawn from
    ``rng``."""
    import dataclasses
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerLM, params_from_numpy)

    c2 = dataclasses.replace(conf, n_layers=2, compute_dtype=None)
    card = TransformerLM(c2, device=DEVICE).init()
    cpu = TransformerLM(c2, device="cpu")
    cpu.params = params_from_numpy(_numpy_tree(card.params), "cpu")
    if toks is None:
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
    grad_rel, worst = _leaf_rel(got, want)
    loss_err = abs(float(got_loss) - float(want_loss))
    assert loss_err <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_RTOL, \
        (loss_err, worst, grad_rel)
    return {"config": {"n_layers": 2, "d_model": c2.d_model,
                       "T": CPU_CHECK_T, "batch": 2, "dtype": "float32"},
            "loss_card": float(got_loss), "loss_cpu": float(want_loss),
            "loss_abs_err": loss_err, "grad_max_rel_err": grad_rel,
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
    zero = _bad_grad_leaves(grads)
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


def profiled(fn, aten_rows=None, warm=None):
    """``fn()`` once under ``torch.profiler``: (its wall seconds, the names
    of the run's device-side events, and ``(name, calls, device µs)`` of
    each device-side op with device time: kernels, copies, memsets). A
    CPU op's entry repeats the time of the kernels it launched, so only
    the device-side entries count. ``aten_rows``, a list, receives
    ``(aten op, calls, self device µs)`` of each host op that launched
    device work: the same time by the op that asked for it. ``warm``
    (default PROFILE_WARM) spin kernels run inside the profile before
    the clock starts, and their events are left out: late in a long
    process the profiler drops a region's first device events (phase
    ``records``' first sequence launch in PR 13, the first window of
    phase ``graph_fused`` in PR 14)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    warm = PROFILE_WARM if warm is None else warm

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(warm):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")
             and "spin_kernel" not in e.name]
    averages = prof.key_averages()
    ops = [(e.key, e.count, device_us(e)) for e in averages
           if str(e.device_type).endswith("CUDA") and device_us(e) > 0
           and "spin_kernel" not in e.key]
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
    from deeplearning4j_tpu_torch.nn.layers.conv import _pair, spatial_pads
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
                pt, pb, pl, pr = spatial_pads(v.layer, xin)
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
              "(fuse_allowed declines BatchNormalization)", "card": card}
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
                                                "word2vec", "attention",
                                                "keras", "lm_persist",
                                                "records", "glove",
                                                "deepwalk",
                                                "fused_autotune",
                                                "dropout_fused",
                                                "graph_fused", "solvers",
                                                "pretrain", "transfer",
                                                "gradcheck", "tsne_kmeans",
                                                "vit", "moe", "dp",
                                                "scaleout"],
              "resnet_narrow_f32": cnn_graph_card_vs_cpu(
                  "resnet50", RESNET_NARROW, 8, SEED + 3),
              "card": card}
    result["seconds"] = time.perf_counter() - t0
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase vit: ViT-B/16 on the flash kernels (non-causal), served, held
# against the CPU, learning the real digits
# ---------------------------------------------------------------------------
def _bad_grad_leaves(grads):
    """The leaves whose gradient is not finite or is all zero."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import _flatten
    return [k for k, g in _flatten(grads).items()
            if not (bool(torch.isfinite(g).all()) and g.abs().max() > 0)]


def _leaf_rel(got, want):
    """The largest error of any leaf of two gradient trees, relative to
    the leaf's max abs, and that leaf's path."""
    from deeplearning4j_tpu_torch.models.transformer import _flatten
    got, want = _flatten(got), _flatten(want)
    rel = {k: ((got[k].cpu() - w).abs().max()
               / w.abs().max().clamp(min=1e-30)).item()
           for k, w in want.items()}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def vit_train_flops_per_image(conf):
    """Matmul FLOPs of one image's training step (hw.py's convention: 2
    a multiply-add, 3x the forward): per patch token the patch embedding,
    qkv, the output projection, QKᵀ and PV against T keys, the MLP; then
    the head on the pooled vector."""
    from deeplearning4j_tpu_torch import hw
    d, t = conf.d_model, conf.n_patches
    pdim = conf.patch_size ** 2 * conf.n_channels
    per_layer = 2 * d * 3 * d + 2 * d * d + 4 * t * d + 4 * d * conf.d_ff
    fwd = t * (conf.n_layers * per_layer + 2 * pdim * d) \
        + 2 * d * conf.n_classes
    return hw.TRAIN_FLOPS_MULTIPLIER * fwd


def _served(model, rows, row_shape):
    """``rows`` through ``InferenceServer`` over ``model.output()`` from
    concurrent clients (bucket 8): the served rows, the batches
    dispatched (inputs and outputs), the forward and backward launches
    between the first request and the last answer (the main path), and
    the wall seconds; every served row must equal ``output()`` of its
    batch computed again."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.serving import InferenceServer
    srv = InferenceServer(model, buckets=(BUCKET,), device=DEVICE)
    srv.warm_start([row_shape])
    batches = []
    served_output = model.output

    def recording_output(x):
        y = served_output(x)
        batches.append((x, y))
        return y
    model.output = recording_output
    torch.cuda.synchronize()
    reset_launches()                           # the main path starts here
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(rows)) as pool:
            served = list(pool.map(lambda x: srv.infer(x, timeout=600),
                                   rows))
        wall = time.perf_counter() - t0
        launches = read_launches()             # ... and ends here
    finally:
        srv.stop()
        del model.output                       # back to the class method
    err = 0.0
    for x, y in batches:
        err = max(err, float(np.abs(model.output(x) - y).max()))
    for row, got in zip(rows, served):
        hits = [y[j] for x, y in batches for j in range(len(x))
                if np.array_equal(x[j], row)]
        assert hits and np.isfinite(got).all(), "a row served from nowhere"
        err = max(err, float(np.abs(got - hits[0]).max()))
    assert err <= 1e-6, err
    assert launches[1:] == (0, 0), launches    # inference: no backward
    return {"requests": len(rows), "batches": len(batches),
            "flash_fwd_launches": launches[0], "wall_s": wall,
            "requests_per_s": len(rows) / wall,
            "served_vs_output_max_abs_err": err}


def vit_full_width(card):
    """ViT-B/16 at batch 64 in bf16: 2 warm-up and 10 timed ``fit_batch``
    steps, the launches of the timed steps by the wrappers and of one
    more step by ``torch.profiler``, every leaf's gradient, and 16
    concurrent requests served. Returns (record, the model)."""
    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers import _synthetic_images
    from deeplearning4j_tpu_torch.models.transformer import _flatten
    from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
    conf = ViTConfig(**VIT_B16)
    s, ch = conf.image_size, conf.n_channels
    x, y = _synthetic_images(VIT_BATCH, s, s, ch, conf.n_classes, SEED + 20)
    vit = ViT(conf, device=DEVICE).init()
    xd, yd = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    warm = [float(vit.fit_batch(xd, yd)) for _ in range(VIT_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # the main path starts here
    t0 = time.perf_counter()
    scores = [vit.fit_batch(xd, yd) for _ in range(VIT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                 # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = warm + [float(v) for v in scores]
    assert launches == (conf.n_layers * VIT_STEPS,) * 3, launches
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    for _ in range(5):
        p_wall, names, ops = profiled(lambda: vit.fit_batch(xd, yd))
        if names:
            break
    else:
        raise AssertionError("torch.profiler recorded no device event")
    by_name = _flash_names(names)
    assert all(v == conf.n_layers for v in by_name.values()), by_name
    _, grads = vit._value_and_grad(xd, vit._device_labels(yd))
    bad = _bad_grad_leaves(grads)
    assert not bad, f"leaves without a finite non-zero gradient: {bad}"
    n_leaves = len(_flatten(grads))
    del grads
    step_s = wall / VIT_STEPS
    flops = vit_train_flops_per_image(conf) * VIT_BATCH
    busy_ms = sum(us for _, _, us in ops) / 1e3
    rec = {"config": VIT_B16, "batch": VIT_BATCH,
           "tokens_per_image": conf.n_patches, "num_params": vit.num_params(),
           "warmup_steps": VIT_WARMUP, "timed_steps": VIT_STEPS,
           "losses": losses, "step_ms": step_s * 1e3,
           "images_per_s": VIT_BATCH / step_s,
           "flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / step_s / PEAK_OPS_PER_S["bfloat16"],
           "peak_memory_bytes": peak,
           "kernel_launches": {"flash_attn_fwd": launches[0],
                               "flash_attn_dq": launches[1],
                               "flash_attn_dkv": launches[2],
                               "counted_by": "the wrappers, timed steps"},
           "profiled_step_kernels": by_name,
           "profiled_step_ms": p_wall * 1e3,
           "busy_share_of_profiled_step": busy_ms / (p_wall * 1e3),
           "profiled_step_top_ops": [
               {"name": n[:80], "calls": c, "device_ms": us / 1e3}
               for n, c, us in sorted(ops, key=lambda o: -o[2])[:6]],
           "leaves_with_finite_nonzero_gradient": n_leaves}
    rows = list(x[:VIT_REQUESTS])
    rec["serve"] = _served(vit, rows, (s, s, ch))
    # one forward launch a layer a dispatched batch
    assert rec["serve"]["flash_fwd_launches"] == \
        conf.n_layers * rec["serve"]["batches"], rec["serve"]
    return rec, vit


def vit_card_vs_cpu(conf):
    """A 2-layer f32 copy (TF32 off): logits and one step's loss and
    gradients on the card and on the CPU from the same weights, within
    VIT_CARD_CPU_RTOL of each tensor's max abs."""
    import dataclasses
    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers import _synthetic_images
    from deeplearning4j_tpu_torch.models.transformer import params_from_numpy
    from deeplearning4j_tpu_torch.models.vit import ViT
    c2 = dataclasses.replace(conf, n_layers=VIT_CPU_CHECK["n_layers"],
                             compute_dtype=None)
    n, s = VIT_CPU_CHECK["batch"], c2.image_size
    x, y = _synthetic_images(n, s, s, c2.n_channels, c2.n_classes, SEED + 21)
    card = ViT(c2, device=DEVICE).init()
    cpu = ViT(c2, device="cpu")
    cpu.params = params_from_numpy(_numpy_tree(card.params), "cpu")
    xc, yc = torch.from_numpy(x), cpu._device_labels(y)
    with torch.no_grad():
        got = card._logits(card.params, xc.to(DEVICE)).cpu()
        want = cpu._logits(cpu.params, xc)
    logits_rel = float((got - want).abs().max() / want.abs().max())
    before = read_launches()
    got_loss, got_g = card._value_and_grad(xc.to(DEVICE), yc.to(DEVICE))
    torch.cuda.synchronize()
    after = read_launches()
    want_loss, want_g = cpu._value_and_grad(xc, yc)
    assert [a - b for a, b in zip(after, before)] == [c2.n_layers] * 3, \
        (before, after)
    grad_rel, worst = _leaf_rel(got_g, want_g)
    loss_err = abs(float(got_loss) - float(want_loss))
    rec = {"config": {"n_layers": c2.n_layers, "d_model": c2.d_model,
                      "batch": n, "dtype": "float32"},
           "logits_rel_err": logits_rel, "loss_abs_err": loss_err,
           "grad_max_rel_err": grad_rel, "grad_worst_leaf": worst,
           "tol": VIT_CARD_CPU_RTOL}
    assert logits_rel <= VIT_CARD_CPU_RTOL and grad_rel <= \
        VIT_CARD_CPU_RTOL and loss_err <= VIT_CARD_CPU_RTOL, rec
    return rec


def vit_digits(tmp):
    """tests/test_vit.py's learner through ``fit(DigitsDataSetIterator)``
    on the card: 30 epochs of the first 320 training digits at batch 64
    (its 150 batches), the train accuracy against its bar and the
    held-out accuracy; then ``write_model``/``restore_model`` of the
    learned ViT on the card: the same ``output()`` bits."""
    import os
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_model, write_model)
    f = VIT_DIGITS_FIT
    it = DigitsDataSetIterator(f["batch"], num_examples=f["examples"])
    test = DigitsDataSetIterator(f["batch"], train=False)
    vit = ViT(ViTConfig(**VIT_DIGITS), device=DEVICE).init()
    t0 = time.perf_counter()
    vit.fit(it, epochs=f["epochs"])
    train_acc = vit.evaluate(it.features, it.label_ids)
    fit_s = time.perf_counter() - t0
    rec = {"config": VIT_DIGITS, "batches": vit.iteration,
           "fit_s": fit_s, "final_score": float(vit.score_),
           "train_accuracy": train_acc, "bar": f["train_bar"],
           "held_out_accuracy": vit.evaluate(test.features,
                                             test.label_ids)}
    assert vit.iteration == f["epochs"] * f["examples"] // f["batch"]
    assert train_acc >= f["train_bar"], rec
    path = os.path.join(tmp, "vit.zip")
    write_model(vit, path)
    back = restore_model(path, device=DEVICE)
    rec["archive_output_bitwise"] = bool(np.array_equal(
        back.output(test.features), vit.output(test.features)))
    rec["archive_bytes"] = os.path.getsize(path)
    assert type(back) is ViT and rec["archive_output_bitwise"], rec
    return rec


def phase_vit(card):
    import tempfile
    import torch
    t_phase = time.perf_counter()
    rec, vit = vit_full_width(card)
    rec = {"phase": "vit", **rec, "card": card}
    conf = vit.conf
    del vit
    torch.cuda.empty_cache()
    seconds = {"full_width": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    rec["f32_card_vs_cpu"] = vit_card_vs_cpu(conf)
    seconds["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec["digits"] = vit_digits(tmp)
    seconds["digits"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    rec["seconds"] = seconds
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase moe: the MoE LM at the slice's widths on the LM's flash route
# ---------------------------------------------------------------------------
class _MoERoutes:
    """Watches ``moe_ffn_dense`` (the module attribute the MoE LM calls):
    per call, each token's experts in order of gate logit and the
    smallest gaps between the first and second, and the second and
    third, gate logits."""

    def __init__(self):
        from deeplearning4j_tpu_torch.models import moe_transformer as mt
        self.module, self.real = mt, mt.moe_ffn_dense
        self.order, self.margins = [], []

    def __enter__(self):
        import torch

        def spy(bp, h, n_experts, top_k=1):
            with torch.no_grad():
                gl = (h @ bp["gate"]).float().reshape(-1, n_experts)
                top = torch.sort(gl, dim=-1, descending=True)
                gaps = (top.values[:, :-1] - top.values[:, 1:]).min(0)
                self.order.append(top.indices[:, :3].cpu())
                self.margins.append(gaps.values[:2].cpu())
            return self.real(bp, h, n_experts, top_k)
        self.module.moe_ffn_dense = spy
        return self

    def __exit__(self, *exc):
        self.module.moe_ffn_dense = self.real


def _tokens_per_expert(conf, moe_blocks, routes):
    """{block: tokens whose first choice is each expert} of one
    watched forward."""
    import numpy as np
    return {f"b{i}": np.bincount(o[:, 0].numpy(),
                                 minlength=conf.n_experts).tolist()
            for i, o in zip(moe_blocks, routes.order)}


def token_chain(rows, t, vocab, seed):
    """[rows, t] int64 tokens of a seeded chain: each token is followed by
    ``(7919 * token + 13) % vocab`` with probability 0.9, else by a
    uniform draw, so a model has something to learn."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = np.empty((rows, t), np.int64)
    out[:, 0] = rng.randint(0, vocab, rows)
    for j in range(1, t):
        follow = (7919 * out[:, j - 1] + 13) % vocab
        out[:, j] = np.where(rng.rand(rows) < 0.9, follow,
                             rng.randint(0, vocab, rows))
    return out


def moe_full_width(card):
    """The MoE LM at the slice's widths in bf16: 2 warm-up and 10 timed
    ``fit_batch`` steps on one batch of 32 rows of the seeded token
    chain, every expert's routing and gradient, and 16 requests served.
    Returns (record, the model)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import hw
    from deeplearning4j_tpu_torch.models.moe_transformer import (
        MoETransformerConfig, MoETransformerLM)
    conf = MoETransformerConfig(**MOE)
    t = conf.max_len
    lm = MoETransformerLM(conf, device=DEVICE).init()
    batch = torch.from_numpy(token_chain(TRAIN_BATCH, t, conf.vocab_size,
                                         SEED + 30)).to(DEVICE)
    moe_blocks = [i for i in range(conf.n_layers) if conf.is_moe_layer(i)]
    # the routing and its gradients, from the initial weights: every
    # expert of every MoE block takes tokens and gets a gradient
    with _MoERoutes() as routes:
        _, grads = lm._value_and_grad(batch[:, :-1], batch[:, 1:], None)
    assert len(routes.order) == len(moe_blocks)
    first_routes = _tokens_per_expert(conf, moe_blocks, routes)
    bad = _bad_grad_leaves(grads)
    dead = [f"b{i}.expert{e}" for i in moe_blocks
            for e in range(conf.n_experts)
            if not (grads[f"b{i}"]["W1"][e].abs().max() > 0
                    and grads[f"b{i}"]["W2"][e].abs().max() > 0)]
    assert not bad and not dead, (bad, dead, first_routes)
    assert all(min(c) > 0 for c in first_routes.values()), first_routes
    del grads
    warm = [float(lm.fit_batch(batch)) for _ in range(MOE_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # the main path starts here
    t0 = time.perf_counter()
    scores = [lm.fit_batch(batch) for _ in range(MOE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                 # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = warm + [float(v) for v in scores]
    assert launches == (conf.n_layers * MOE_STEPS,) * 3, launches
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    # where the tokens go after the timed steps (reported: a gate trained
    # on one fixed batch may starve an expert)
    with _MoERoutes() as routes, torch.no_grad():
        lm._logits(lm.params, batch[:, :-1])
    step_s = wall / MOE_STEPS
    tokens = TRAIN_BATCH * (t - 1)
    h = conf.d_expert or conf.d_ff
    active = hw.TRAIN_FLOPS_MULTIPLIER * hw.transformer_fwd_flops_per_token(
        t, conf.d_model, conf.n_layers, h, conf.vocab_size)
    # dense routing runs every expert on every token: E/k times the
    # expert MLP's FLOPs in each MoE block
    extra = hw.TRAIN_FLOPS_MULTIPLIER * len(moe_blocks) * (
        conf.n_experts / conf.router_top_k - 1) * 4 * conf.d_model * h
    rec = {"config": MOE, "batch": TRAIN_BATCH, "tokens_per_row": t,
           "num_params": lm.num_params(), "moe_blocks": moe_blocks,
           "warmup_steps": MOE_WARMUP, "timed_steps": MOE_STEPS,
           "losses": losses, "step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "active_flops_per_token": active,
           "mfu_active_vs_bf16_peak": tokens * active / step_s
           / PEAK_OPS_PER_S["bfloat16"],
           "executed_flops_per_token": active + extra,
           "mfu_executed_vs_bf16_peak": tokens * (active + extra) / step_s
           / PEAK_OPS_PER_S["bfloat16"],
           "flops_note": "MFU counts the active (top-1) FLOPs; dense "
                         "routing executes E/k = 4x the expert FLOPs "
                         "(executed_flops_per_token)",
           "peak_memory_bytes": peak,
           "kernel_launches": {"flash_attn_fwd": launches[0],
                               "flash_attn_dq": launches[1],
                               "flash_attn_dkv": launches[2],
                               "counted_by": "the wrappers, timed steps"},
           "tokens_per_expert_at_init": first_routes,
           "tokens_per_expert_after_timed_steps": _tokens_per_expert(
               conf, moe_blocks, routes),
           "min_gate_margin_after": float(min(m[0]
                                              for m in routes.margins))}
    rows = [r.astype(np.int32) for r in batch[:MOE_REQUESTS].cpu().numpy()]
    rec["serve"] = _served(lm, rows, (t,))
    assert rec["serve"]["flash_fwd_launches"] == \
        conf.n_layers * rec["serve"]["batches"], rec["serve"]
    return rec, lm


def moe_refusals(lm):
    """generate(), beam_search() and a ContinuousLM over the MoE LM raise
    NotImplementedError at once, with the reference's words."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving import ContinuousLM
    prompt = np.zeros((1, 4), np.int32)
    said = []
    for call in (lambda: lm.generate(prompt, 2),
                 lambda: lm.beam_search(prompt, 2),
                 lambda: ContinuousLM(lm, slots=2, device=DEVICE)):
        try:
            call()
        except NotImplementedError as e:
            said.append(str(e))
        else:
            raise AssertionError("MoE generation did not raise")
    assert len(set(said)) == 1 and "MoE family" in said[0], said
    return said[0]


def moe_archive(conf, tmp):
    """A copy at full width cut to MOE_ARCHIVE_LAYERS layers, one step,
    written and restored on the card: ``output()`` the same bits, and one
    further step from each the same parameter and moment bits."""
    import dataclasses
    import os
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerLM
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_model, write_model)
    c2 = dataclasses.replace(conf, n_layers=MOE_ARCHIVE_LAYERS)
    batches = [token_chain(8, c2.max_len, c2.vocab_size, SEED + 31 + i)
               for i in range(2)]
    lm = MoETransformerLM(c2, device=DEVICE).init()
    lm.fit_batch(batches[0])
    path = os.path.join(tmp, "moe.zip")
    t0 = time.perf_counter()
    write_model(lm, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = restore_model(path, device=DEVICE)
    restore_s = time.perf_counter() - t0
    rows = batches[1][:2]
    out_bits = bool(np.array_equal(back.output(rows), lm.output(rows)))
    for m in (lm, back):
        m.fit_batch(batches[1])
    torch.cuda.synchronize()
    params_bits, p_err = _tree_bits_equal(lm.params, back.params)
    opt_bits, o_err = _tree_bits_equal(lm.opt_state, back.opt_state)
    rec = {"n_layers": c2.n_layers, "archive_bytes": os.path.getsize(path),
           "write_s": write_s, "restore_s": restore_s,
           "output_bitwise": out_bits, "resume_params_bitwise": params_bits,
           "resume_moments_bitwise": opt_bits,
           "resume_max_abs_diff": max(p_err, o_err)}
    assert type(back) is MoETransformerLM and out_bits and params_bits \
        and opt_bits, rec
    return rec


def moe_card_vs_cpu(conf, top_k):
    """A 2-layer f32 copy with ``router_top_k`` = ``top_k``, weights drawn
    on the CPU (MOE_CPU_CHECK's seed) and copied to the card: the
    routing (each token's first choice, and its second under top-2)
    equal on both, with the smallest gate margins; the logits within
    CPU_GPU_TOL; one step's loss within TRAIN_LOSS_TOL and gradients
    within MOE_CARD_CPU_RTOL of each leaf's max abs."""
    import dataclasses
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerLM
    from deeplearning4j_tpu_torch.models.transformer import params_from_numpy
    c2 = dataclasses.replace(conf, n_layers=MOE_CPU_CHECK["n_layers"],
                             compute_dtype=None, router_top_k=top_k,
                             seed=MOE_CPU_CHECK["seed"])
    cpu = MoETransformerLM(c2, device="cpu").init()
    card = MoETransformerLM(c2, device=DEVICE)
    card.params = params_from_numpy(_numpy_tree(cpu.params), DEVICE)
    toks = torch.from_numpy(np.random.RandomState(SEED + 32).randint(
        0, c2.vocab_size, (MOE_CPU_CHECK["batch"], CPU_CHECK_T + 1)))
    x, y = toks[:, :-1], toks[:, 1:]
    routes = {}
    for name, m, xx in (("card", card, x.to(DEVICE)), ("cpu", cpu, x)):
        with _MoERoutes() as r, torch.no_grad():
            logits = m._logits(m.params, xx).cpu()
        routes[name] = (r, logits)
    (rg, lg), (rc, lc) = routes["card"], routes["cpu"]
    first_equal = all(torch.equal(a[:, 0], b[:, 0])
                      for a, b in zip(rg.order, rc.order))
    second_equal = all(torch.equal(a[:, 1], b[:, 1])
                       for a, b in zip(rg.order, rc.order))
    margins = [float(min(m[i] for m in rc.margins)) for i in range(2)]
    logits_err = float((lg - lc).abs().max())
    got_loss, got_g = card._value_and_grad(x.to(DEVICE), y.to(DEVICE), None)
    want_loss, want_g = cpu._value_and_grad(x, y, None)
    grad_rel, worst = _leaf_rel(got_g, want_g)
    loss_err = abs(float(got_loss) - float(want_loss))
    rec = {"router_top_k": top_k, "n_layers": c2.n_layers,
           "batch": MOE_CPU_CHECK["batch"], "T": CPU_CHECK_T,
           "routing_first_choice_equal": first_equal,
           "routing_second_choice_equal": second_equal,
           "min_gate_margin_first_second": margins[0],
           "min_gate_margin_second_third": margins[1],
           "logits_max_abs_err": logits_err, "loss_abs_err": loss_err,
           "grad_max_rel_err": grad_rel, "grad_worst_leaf": worst}
    need = margins[:top_k]
    assert min(need) > MOE_MARGIN, ("pick another seed", rec)
    assert first_equal and (top_k == 1 or second_equal), rec
    assert logits_err <= CPU_GPU_TOL and loss_err <= TRAIN_LOSS_TOL \
        and grad_rel <= MOE_CARD_CPU_RTOL, rec
    return rec


def phase_moe(card):
    import tempfile
    import torch
    t_phase = time.perf_counter()
    rec, lm = moe_full_width(card)
    rec = {"phase": "moe", **rec, "card": card}
    rec["generation_refused"] = moe_refusals(lm)
    conf = lm.conf
    del lm
    torch.cuda.empty_cache()
    seconds = {"full_width": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec["archive"] = moe_archive(conf, tmp)
    seconds["archive"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["f32_card_vs_cpu"] = [moe_card_vs_cpu(conf, k) for k in (1, 2)]
    seconds["card_vs_cpu"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    rec["seconds"] = seconds
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase attention: SelfAttentionLayer on the flash kernels through the
# helper seam
# ---------------------------------------------------------------------------
def attention_conf(compute):
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (RnnOutputLayer,
                                                    SelfAttentionLayer)
    d, h = ATTN["d_model"], ATTN["n_heads"]
    return (NeuralNetConfiguration.Builder().seed(SEED + 11)
            .learning_rate(1e-3).updater("adam").compute_dtype(compute)
            .list()
            .layer(SelfAttentionLayer(n_in=d, n_out=d, n_heads=h,
                                      causal=True))
            .layer(SelfAttentionLayer(n_in=d, n_out=d, n_heads=h,
                                      causal=True, residual=True))
            .layer(RnnOutputLayer(n_in=d, n_out=ATTN["n_classes"],
                                  activation="softmax", loss="mcxent"))
            .build())


def attention_batches(n, seed):
    """Seeded [B, T, d] features and one-hot [B, T, classes] labels whose
    class is the argmax of a fixed projection of the features (a task the
    net can learn), on the host."""
    import numpy as np
    r = np.random.RandomState(seed)
    proj = r.randn(ATTN["d_model"], ATTN["n_classes"]).astype(np.float32)
    out = []
    for _ in range(n):
        x = r.randn(ATTN["batch"], ATTN["seq_len"],
                    ATTN["d_model"]).astype(np.float32)
        y = np.eye(ATTN["n_classes"], dtype=np.float32)[(x @ proj).argmax(-1)]
        out.append((x, y))
    return out


class _helpers_off:
    """``DL4J_TPU_DISABLE_HELPERS=1`` for the block: the layers take
    their built-in route (dense attention, on the card)."""

    def __enter__(self):
        import os
        os.environ["DL4J_TPU_DISABLE_HELPERS"] = "1"

    def __exit__(self, *exc):
        import os
        os.environ.pop("DL4J_TPU_DISABLE_HELPERS", None)


def _flash_names(names):
    """Launches of each flash kernel (either route) among a profile's
    device events."""
    return {k: sum(any(v in n for v in TC_KERNELS[k]) for n in names)
            for k in TC_KERNELS}


def _rel_err(got, want):
    import torch
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def attention_f32_parity(x, y):
    """An f32 copy of the net: output and one step's gradients through the
    kernels (the helper) against the built-in dense path on the card
    (helpers off), each tensor within ATTN_F32_RTOL of its max abs."""
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = MultiLayerNetwork(attention_conf("float32"), device=DEVICE).init()
    out = torch.from_numpy(net.output(x))
    g, s = net.compute_gradient_and_score(x, y)
    with _helpers_off():
        out_b = torch.from_numpy(net.output(x))
        g_b, s_b = net.compute_gradient_and_score(x, y)
    errs = {"output": _rel_err(out, out_b), "score": abs(s - s_b) / abs(s_b)}
    for i, (a, b) in enumerate(zip(g, g_b)):
        for k in b:
            errs[f"{i}.{k}"] = _rel_err(a[k], b[k])
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= ATTN_F32_RTOL, worst
    return {"max_rel_err": worst[1], "worst": worst[0],
            "tol": ATTN_F32_RTOL, "leaves": len(errs) - 2}


def attention_bf16_op_parity(net, x):
    """The bf16 kernels at the first layer's own q/k/v (the bf16 net's
    projections of the batch): O, dQ, dK and dV against the built-in
    dense path on the card in f32 from the same bf16 inputs (the
    unrounded result the bars are stated against), within
    ``BF16_O_BAR``, ``BF16_DQ_BAR`` and ``BF16_DKV_BAR``."""
    import torch
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
        dense_attention
    layer = net.layers[0]
    p = {k: v.detach().to(torch.bfloat16)
         for k, v in net.params_list[0].items()}
    xb = torch.from_numpy(x).to(DEVICE, torch.bfloat16)
    q, k, v = (layer._split_heads(xb @ p[w]).contiguous()
               for w in ("Wq", "Wk", "Wv"))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    do = torch.randn(q.shape, generator=gen, device=DEVICE) \
        .to(torch.bfloat16)
    helper = helpers.get_helper(layer)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    o = helper.attention(qa, ka, va, causal=True)
    dq, dk, dv = torch.autograd.grad(o, (qa, ka, va), do)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    with _helpers_off():
        o32 = dense_attention(qf, kf, vf, causal=True)
    g32 = torch.autograd.grad(o32, (qf, kf, vf), do.float())
    n, t, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    o, o32 = o.detach(), o32.detach()
    o_limit = fa.bf16_o_limit(v.reshape(n, t, d), o32.reshape(n, t, d), 1)
    o_ratio = float(((o.float() - o32).abs().reshape(n, t, d)
                     / o_limit).max())
    ratios = {"o": o_ratio,
              "dq": _rel_err(dq, g32[0]) / fa.BF16_DQ_BAR,
              "dk": _rel_err(dk, g32[1]) / fa.BF16_DKV_BAR,
              "dv": _rel_err(dv, g32[2]) / fa.BF16_DKV_BAR}
    assert max(ratios.values()) <= 1.0, ratios
    return {"shape": list(q.shape), "err_over_bar": ratios,
            "bars": {"o": fa.BF16_O_BAR, "dq": fa.BF16_DQ_BAR,
                     "dkv": fa.BF16_DKV_BAR}}


def attention_mask_decline(x):
    """A batch with a key mask: the helper declines (no launch, one more
    decline a layer), and the output equals the built-in route's."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn import helpers
    net = MultiLayerNetwork(attention_conf("bfloat16"), device=DEVICE).init()
    mask = np.ones(x.shape[:2], np.float32)
    mask[::2, ATTN["seq_len"] * 3 // 4:] = 0.0
    reset_launches()
    before = helpers.declines("SelfAttentionLayer")
    got = net.output(x, fmask=mask)
    launches = read_launches()
    declines = helpers.declines("SelfAttentionLayer") - before
    with _helpers_off():
        want = net.output(x, fmask=mask)
    assert launches == (0, 0, 0), launches
    assert declines == 2, declines
    assert np.array_equal(got, want)
    return {"launches": list(launches), "declines": declines,
            "equals_builtin_route": True,
            "masked_rows": int((mask == 0).any(1).sum())}


def attention_fit_iterator(batches):
    """fit(iterator) on the fused loop (K = the group) against the
    per-batch loop from the same parameters: the fused window graph holds
    the flash kernels (counted by the profiler in its timed replay) and
    its parameters must equal the per-batch run's, bit for bit."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    conf = attention_conf("bfloat16")
    allowed = fuse_allowed(conf, conf.layers)
    data = [DataSet(x, y) for x, y in batches]
    out = {"fuse_allowed": allowed}
    params = {}
    for fused in (True, False):
        _fit_path(fused)
        try:
            net = MultiLayerNetwork(conf, device=DEVICE).init()
            net.fit(ListDataSetIterator(data[:1]))     # warm-up (capture)
            reset_launches()
            wall, names, _ = profiled(
                lambda: net.fit(ListDataSetIterator(data[1:])))
            calls = read_launches()
        finally:
            _fit_path(True)
        params[fused] = net.params()
        key = "fused" if fused else "per_batch"
        out[key] = {"wall_s": wall, "wrapper_launches": list(calls),
                    "profiled_kernels": _flash_names(names),
                    "graphs_captured": net._fused.captures
                    if net._fused else 0,
                    "fuse_stats": net._last_fuse_stats}
    steps = len(data) - 1
    per = ATTN_FUSED_BATCHES - 1
    assert steps == per
    if allowed:
        assert out["fused"]["wrapper_launches"] == [0, 0, 0], out
        assert out["fused"]["graphs_captured"] == 1, out
        assert all(v == 2 * steps for v in
                   out["fused"]["profiled_kernels"].values()), out
    assert out["per_batch"]["wrapper_launches"] == [2 * steps] * 3, out
    out["fused_equals_per_batch_bitwise"] = bool(
        np.array_equal(params[True], params[False]))
    out["param_max_abs_diff"] = float(np.abs(params[True]
                                             - params[False]).max())
    assert out["fused_equals_per_batch_bitwise"], out
    out["route"] = "fused loop captures the flash kernels" if allowed \
        else "declined by fuse_allowed"
    torch.cuda.synchronize()
    return out


def phase_attention(card):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn import helpers
    t_phase = time.perf_counter()
    batches = attention_batches(ATTN_FUSED_BATCHES, SEED + 10)
    x, y = batches[0]
    xd, yd = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    net = MultiLayerNetwork(attention_conf("bfloat16"), device=DEVICE).init()
    warm = [float(net.fit_batch(xd, yd)) for _ in range(ATTN_WARMUP)]
    net.output(xd)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = net.output(xd)
    out_ms = (time.perf_counter() - t0) * 1e3
    out_launches = read_launches()
    assert out_launches == (2, 0, 0), out_launches
    assert out.shape == (ATTN["batch"], ATTN["seq_len"], ATTN["n_classes"])
    assert np.isfinite(out).all()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    declines = helpers.declines("SelfAttentionLayer")
    reset_launches()                           # the main path starts here
    t0 = time.perf_counter()
    scores = [net.fit_batch(xd, yd) for _ in range(ATTN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                 # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    assert launches == (2 * ATTN_STEPS,) * 3, launches
    assert helpers.declines("SelfAttentionLayer") == declines
    losses = warm + [float(s) for s in scores]
    assert all(math.isfinite(v) for v in losses), losses
    for _ in range(5):
        _, names, ops = profiled(lambda: net.fit_batch(xd, yd))
        if names:
            break
    else:
        raise AssertionError("torch.profiler recorded no device event")
    by_name = _flash_names(names)
    assert all(v == 2 for v in by_name.values()), by_name
    tokens = ATTN["batch"] * ATTN["seq_len"]
    rec = {"phase": "attention", "config": ATTN, "compute": "bfloat16",
           "layers": "SelfAttentionLayer x2 (causal; the second residual) "
                     "+ RnnOutputLayer", "num_params": net.num_params(),
           "output_ms": out_ms, "output_launches": list(out_launches),
           "warmup_steps": ATTN_WARMUP, "timed_steps": ATTN_STEPS,
           "step_ms": wall / ATTN_STEPS * 1e3,
           "tokens_per_s": tokens * ATTN_STEPS / wall,
           "losses": losses, "peak_memory_bytes": peak,
           "kernel_launches": {"flash_attn_fwd": launches[0],
                               "flash_attn_dq": launches[1],
                               "flash_attn_dkv": launches[2],
                               "counted_by": "the wrappers, timed steps"},
           "profiled_step_kernels": by_name,
           "profiled_step_top_ops": [
               {"name": n[:80], "calls": c, "device_ms": us / 1e3}
               for n, c, us in sorted(ops, key=lambda o: -o[2])[:6]],
           "card": card}
    seconds = {"main": time.perf_counter() - t_phase}
    for key, step in (
            ("bf16_op_vs_builtin", lambda: attention_bf16_op_parity(net, x)),
            ("f32_vs_builtin", lambda: attention_f32_parity(x, y)),
            ("mask_decline", lambda: attention_mask_decline(x)),
            ("fit_iterator", lambda: attention_fit_iterator(batches))):
        t0 = time.perf_counter()
        if key == "f32_vs_builtin":
            del net
            torch.cuda.empty_cache()
        rec[key] = step()
        seconds[key] = time.perf_counter() - t0
    rec["seconds"] = seconds
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase keras: the committed Keras files imported on the card
# ---------------------------------------------------------------------------
def _keras_file(name):
    return str(_repo_path(*KERAS_FIXTURES, name))


def _accuracy(net, it):
    import numpy as np
    return float((np.argmax(net.output(it.features), 1)
                  == it.label_ids).mean())


def _card_cpu(imp, path, x):
    """The file imported on the card and on the CPU: outputs within
    KERAS_CARD_CPU_RTOL of their scale, parameters the same bits."""
    import numpy as np
    import torch
    card, cpu = imp(path), imp(path, device="cpu")
    assert card.device.type == torch.device(DEVICE).type
    assert np.array_equal(card.params(), cpu.params())
    got, want = card.output(x), cpu.output(x)
    rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert np.isfinite(got).all() and rel <= KERAS_CARD_CPU_RTOL, rel
    return card, {"card_vs_cpu_rel": rel, "tol": KERAS_CARD_CPU_RTOL,
                  "num_params": card.num_params(),
                  "output_shape": list(got.shape)}


def keras_lenet(tmp):
    """The Keras 1 LeNet: held-out accuracy with no training, card against
    CPU and against a zoo-built lenet_mnist given the same parameters,
    then 2 epochs through KerasRPCServer's POST /fit on .npz minibatches
    (training on the card) and the held-out accuracy again."""
    import json
    import os
    import urllib.request
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_sequential_model_and_weights as imp
    from deeplearning4j_tpu_torch.modelimport.keras_server import \
        KerasRPCServer
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.utils.model_serializer import restore_model
    fixture = _repo_path(*MNIST_FIXTURE)
    train = MnistDataSetIterator(KERAS_FIT["batch"], data_dir=fixture)
    test = MnistDataSetIterator(KERAS_FIT["batch"], train=False,
                                data_dir=fixture)
    path = _keras_file("lenet_k1_tf.h5")
    t0 = time.perf_counter()
    net, rec = _card_cpu(imp, path, test.features)
    rec["import_s"] = time.perf_counter() - t0
    assert rec["num_params"] == 431080
    rec["held_out_accuracy"] = _accuracy(net, test)
    assert rec["held_out_accuracy"] >= LENET_HELD_OUT_BAR, rec
    z = MultiLayerNetwork(zoo.lenet_mnist(), device=DEVICE).init()
    z.set_params(net.params())
    got, want = net.output(test.features), z.output(test.features)
    rec["zoo_lenet_bit_identical"] = bool(np.array_equal(got, want))
    rec["zoo_lenet_rel"] = float(np.abs(got - want).max()
                                 / np.abs(want).max())
    assert rec["zoo_lenet_rel"] <= KERAS_CARD_CPU_RTOL, rec
    data = os.path.join(tmp, "minibatches")
    os.makedirs(data)
    b = KERAS_FIT["batch"]
    for i in range(0, len(train.features), b):
        np.savez(os.path.join(data, f"b{i // b:03d}.npz"),
                 features=train.features[i:i + b],
                 labels=train.labels[i:i + b])
    srv = KerasRPCServer(device=DEVICE).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/fit", data=json.dumps({
                "model_path": path, "data_dir": data,
                "epochs": KERAS_FIT["epochs"],
                "save_path": os.path.join(tmp, "tuned.zip")}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            reply = json.loads(r.read())
        fit_wall = time.perf_counter() - t0
    finally:
        srv.stop()
    assert reply["status"] == "ok", reply
    tuned = restore_model(os.path.join(tmp, "tuned.zip"), device=DEVICE)
    rec["fit"] = {"epochs": reply["epochs"], "batches": reply["batches"],
                  "first_score": reply["first_score"],
                  "final_score": reply["final_score"],
                  "seconds": reply["seconds"], "request_s": fit_wall,
                  "held_out_accuracy": _accuracy(tuned, test)}
    assert math.isfinite(reply["final_score"])
    assert rec["fit"]["held_out_accuracy"] >= LENET_HELD_OUT_BAR, rec
    return rec


def keras_residual():
    import numpy as np
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_model_and_weights as imp
    x = np.random.RandomState(SEED + 13).randn(16, 8, 8, 4) \
        .astype(np.float32)
    _, rec = _card_cpu(imp, _keras_file("residual_k1_th.h5"), x)
    return rec


def keras_lstm():
    """The Keras 2 LSTM: its output on the card through the sequence
    kernel (launches counted), then one fine-tune step through the
    backward kernel (a launch a step)."""
    import numpy as np
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_sequential_model_and_weights as imp
    r = np.random.RandomState(SEED + 14)
    eye = np.eye(65, dtype=np.float32)
    x = eye[r.randint(0, 65, (32, 50))]
    y = eye[r.randint(0, 65, 32)]
    reset_launches()
    net, rec = _card_cpu(imp, _keras_file("lstm_k2_charrnn.h5"), x)
    fwd_output = read_lstm_launches()
    score = float(net.fit_batch(x, y))
    after = read_lstm_launches()
    assert fwd_output[0] >= 1 and fwd_output[1] == 0, fwd_output
    assert after[0] == fwd_output[0] + 1 and after[1] == 50, after
    assert math.isfinite(score)
    rec.update({"launches_output": {"lstm_cell_fwd": fwd_output[0]},
                "launches_fit_step": {"lstm_cell_fwd": after[0]
                                      - fwd_output[0],
                                      "lstm_cell_bwd": after[1]},
                "fit_step_score": score})
    return rec


def keras_resnet50_narrow(tmp):
    """The committed full-depth Keras 1 ResNet-50 topology (filters
    narrowed 16x, seeded weights): imported on the card against the CPU
    (KERAS_CARD_CPU_RTOL), then one ``/fit`` through ``KerasRPCServer``
    on seeded 224x224x3 minibatches, its archive restored on the card."""
    import json
    import os
    import urllib.request
    import numpy as np
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_model_and_weights as imp
    from deeplearning4j_tpu_torch.modelimport.keras_server import \
        KerasRPCServer
    from deeplearning4j_tpu_torch.utils.model_serializer import restore_model
    k = KERAS_RESNET50
    r = np.random.RandomState(SEED + 15)
    path = _keras_file(k["file"])
    x = r.rand(k["images"], 224, 224, 3).astype(np.float32)
    t0 = time.perf_counter()
    net, rec = _card_cpu(imp, path, x)
    rec["import_s"] = time.perf_counter() - t0
    rec["vertices"] = len(net.conf.vertices)
    assert rec["vertices"] == 176, rec
    data = os.path.join(tmp, "resnet_batches")
    os.makedirs(data)
    eye = np.eye(1000, dtype=np.float32)
    for i in range(k["fit_batches"]):
        np.savez(os.path.join(data, f"b{i:03d}.npz"),
                 features=r.rand(k["fit_batch"], 224, 224, 3).astype(
                     np.float32),
                 labels=eye[r.randint(0, 1000, k["fit_batch"])])
    srv = KerasRPCServer(device=DEVICE).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/fit", data=json.dumps({
                "model_path": path, "data_dir": data, "epochs": 1,
                "save_path": os.path.join(tmp, "resnet.zip")}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            reply = json.loads(resp.read())
    finally:
        srv.stop()
    assert reply["status"] == "ok" and reply["model_type"] == \
        "ComputationGraph", reply
    assert math.isfinite(reply["final_score"]), reply
    tuned = restore_model(os.path.join(tmp, "resnet.zip"), device=DEVICE)
    out = tuned.output(x)
    assert np.isfinite(out).all() and out.shape == (k["images"], 1000)
    rec["fit"] = {key: reply[key] for key in ("batches", "first_score",
                                              "final_score", "seconds")}
    return rec


def phase_keras(card):
    import tempfile
    t_phase = time.perf_counter()
    rec = {"phase": "keras", "card": card}
    seconds = {}
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for key, step in (("lenet_k1_tf", lambda: keras_lenet(tmp)),
                          ("residual_k1_th", keras_residual),
                          ("lstm_k2_charrnn", keras_lstm),
                          ("trained_vgg16_tiny", keras_trained_vgg),
                          ("resnet50_narrow_k1_tf",
                           lambda: keras_resnet50_narrow(tmp))):
            t0 = time.perf_counter()
            if key == "lstm_k2_charrnn":
                lstm_before = read_lstm_launches()
            rec[key] = step()
            seconds[key] = time.perf_counter() - t0
    # the LSTM counts of this phase (the LeNet and the residual block run
    # no kernel of the package)
    rec["kernel_launches"] = {"lstm_cell_fwd": read_lstm_launches()[0],
                              "lstm_cell_bwd": read_lstm_launches()[1],
                              "flash": list(read_launches())}
    assert lstm_before == (0, 0), lstm_before
    seconds["phase"] = time.perf_counter() - t_phase
    rec["seconds"] = seconds
    emit(rec)
    return rec


def _tree_bits_equal(a, b):
    """Whether two LM trees (parameters or an optimizer state) hold the
    same bits, and the largest difference of any leaf."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import _flatten
    fa, fb = _flatten(a), _flatten(b)
    worst = max(float((fa[k].detach().float() - fb[k].detach().float())
                      .abs().max()) for k in fa)
    return all(torch.equal(fa[k].detach(), fb[k].detach()) for k in fa), \
        worst


def _lm_batches(conf, n, seed, batch):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, conf.vocab_size,
                                         (batch, conf.max_len)))
            .to(DEVICE) for _ in range(n)]


def lm_resume(conf, batches, tmp):
    """Uninterrupted runs (two, from the same weights: the card's own
    spread) against a run saved after ``save_after`` steps and resumed
    in a fresh LM from the training checkpoint; the flash launches of the
    resumed steps (the main path), counted by the wrappers."""
    import dataclasses
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.utils import training_checkpoint as tc
    c = LM_PERSIST

    def run(steps, lm=None):
        lm = lm or TransformerLM(conf, device=DEVICE).init()
        for b in batches[lm.iteration:steps]:
            lm.fit_batch(b)
        return lm
    full = run(c["steps"])
    again = run(c["steps"])
    spread = {t: _tree_bits_equal(getattr(full, t), getattr(again, t))
              for t in ("params", "opt_state")}
    del again
    part = run(c["save_after"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tc.save_training_checkpoint(part, tmp)
    save_s = time.perf_counter() - t0
    del part
    fresh = TransformerLM(dataclasses.replace(conf, seed=conf.seed + 100),
                          device=DEVICE).init()
    t0 = time.perf_counter()
    cursor = tc.apply_training_checkpoint(fresh, path)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    assert cursor == {} and fresh.iteration == c["save_after"]
    reset_launches()                        # the main path starts here
    run(c["steps"], fresh)
    torch.cuda.synchronize()
    launches = read_launches()              # ... ends
    resumed = {t: _tree_bits_equal(getattr(fresh, t), getattr(full, t))
               for t in ("params", "opt_state")}
    n = (c["steps"] - c["save_after"]) * conf.n_layers
    assert launches == (n, n, n), launches
    # one more step of the resumed LM under the profiler: each flash
    # kernel once a layer on the device (another step if the profiler
    # dropped an event, up to five)
    for tries in range(1, 6):
        _, names, _ = profiled(lambda: fresh.fit_batch(batches[-1]))
        by_name = _flash_names(names)
        if all(v == conf.n_layers for v in by_name.values()):
            break
    assert all(v == conf.n_layers for v in by_name.values()), \
        (by_name, tries)
    for t in resumed:
        # bitwise, or within the spread of two uninterrupted card runs
        assert resumed[t][0] or resumed[t][1] <= spread[t][1], \
            (t, resumed, spread)
    rec = {"steps": c["steps"], "save_after": c["save_after"],
           "uninterrupted_bitwise": {t: v[0] for t, v in spread.items()},
           "uninterrupted_max_abs_diff": {t: v[1]
                                          for t, v in spread.items()},
           "resumed_bitwise": {t: v[0] for t, v in resumed.items()},
           "resumed_max_abs_diff": {t: v[1] for t, v in resumed.items()},
           "checkpoint_save_s": save_s, "checkpoint_apply_s": apply_s,
           "kernel_launches": {"flash_attn_fwd": launches[0],
                               "flash_attn_dq": launches[1],
                               "flash_attn_dkv": launches[2]},
           "profiled_step_kernels": by_name, "steps_profiled": tries}
    return full, rec


def lm_archive(lm, tmp):
    """``write_model`` then ``restore_model`` on the card: archive bytes,
    write and restore seconds, and ``output()`` of the restored LM equal
    to the original's, bit for bit."""
    import os
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.utils import model_serializer
    path = os.path.join(tmp, "lm.zip")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_serializer.write_model(lm, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = model_serializer.restore_model(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert back.device == lm.device and back.iteration == lm.iteration
    x = np.random.RandomState(SEED + 21).randint(
        0, lm.conf.vocab_size, (LM_PERSIST["out_rows"], lm.conf.max_len))
    got, want = back.output(x), lm.output(x)
    params_equal, _ = _tree_bits_equal(back.params, lm.params)
    opt_equal, _ = _tree_bits_equal(back.opt_state, lm.opt_state)
    rec = {"archive_bytes": os.path.getsize(path), "write_s": write_s,
           "restore_s": restore_s,
           "params_bitwise": params_equal, "opt_state_bitwise": opt_equal,
           "output_bitwise": bool(np.array_equal(got, want)),
           "output_rows": list(x.shape)}
    assert params_equal and opt_equal and rec["output_bitwise"], rec
    return path, rec


def lm_serve_restored(lm, path):
    """Greedy tokens of ContinuousLM over ``lm`` against a ContinuousLM
    whose model held other weights when it captured its programs, and
    then took the archive in place (``apply_training_checkpoint``): the
    same tokens, no graph captured after the load."""
    import dataclasses
    import numpy as np
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import ContinuousLM
    from deeplearning4j_tpu_torch.utils import training_checkpoint as tc
    c = LM_PERSIST_SERVE
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, lm.conf.vocab_size, (c["prompt"],))
               .astype(np.int32) for _ in range(c["requests"])]

    def serve(model, load=None):
        srv = ContinuousLM(model, slots=c["slots"], chunk=c["chunk"],
                           device=DEVICE)
        try:
            srv.warm_start()
            if load is not None:
                srv.submit(prompts[0], c["n_new"]).result(600)
                load()
            cap0 = capture_count()
            rows = [f.result(600) for f in
                    [srv.submit(p, c["n_new"]) for p in prompts]]
            return rows, capture_count() - cap0
        finally:
            srv.stop()
    want, _ = serve(lm)
    other = TransformerLM(dataclasses.replace(lm.conf, seed=lm.conf.seed
                                              + 200), device=DEVICE).init()
    params = other.params
    got, captured = serve(other, lambda: tc.apply_training_checkpoint(
        other, path))
    equal = sum(np.array_equal(a, b) for a, b in zip(got, want))
    rec = {"requests": c["requests"], "slots": c["slots"],
           "prompt": c["prompt"], "n_new": c["n_new"],
           "rows_equal": int(equal), "graphs_captured_after_load": captured,
           "same_parameter_tensors": other.params is params}
    assert equal == len(prompts) and captured == 0 \
        and rec["same_parameter_tensors"], rec
    return rec


def phase_lm_persist(card):
    """The slice's LM saved and resumed on the card (the module
    docstring's phase 13)."""
    import dataclasses
    import tempfile
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    t_phase = time.perf_counter()
    conf = TransformerConfig(**SLICE)
    batches = _lm_batches(conf, LM_PERSIST["steps"], SEED + 20,
                          LM_PERSIST["batch"])
    rec = {"phase": "lm_persist", "config": SLICE, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        lm, rec["resume"] = lm_resume(conf, batches, tmp)
        assert lm.num_params() == SLICE_PARAMS
        path, rec["archive"] = lm_archive(lm, tmp)
        rec["serve_restored"] = lm_serve_restored(lm, path)
        del lm
        torch.cuda.empty_cache()
        drop = dataclasses.replace(conf, **LM_PERSIST_DROPOUT)
        dtmp = tempfile.mkdtemp(dir=tmp)
        _, rec["dropout_resume"] = lm_resume(drop, batches, dtmp)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["kernel_launches"] = rec["resume"]["kernel_launches"]
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def digits():
    """The fixture's real digits: (train images, labels), (test ...), the
    images [n, 8, 8] uint8."""
    from deeplearning4j_tpu_torch.datasets.fetchers import read_idx
    d = _repo_path(*DIGITS_FIXTURE)
    out = []
    for split in ("train", "t10k"):
        x = read_idx(f"{d}/{split}-images-idx3-ubyte")
        y = read_idx(f"{d}/{split}-labels-idx1-ubyte")
        out.append((x, y))
    assert out[0][0].shape == (1500, 8, 8) and out[1][0].shape == (297, 8, 8)
    return out


def _write_digit_csv(path, x, y):
    import numpy as np
    rows = np.concatenate([x.reshape(len(x), -1), y[:, None]], axis=1)
    with open(path, "w") as f:
        f.write("\n".join(",".join(str(int(v)) for v in r) for r in rows))
        f.write("\n")


def _records_conf(device_seed):
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    c = RECORDS_MLN
    return (NeuralNetConfiguration.Builder().seed(device_seed)
            .updater("adam").learning_rate(c["lr"]).list()
            .layer(DenseLayer(n_in=64, n_out=c["hidden"], activation="relu"))
            .layer(DenseLayer(n_in=c["hidden"], n_out=c["hidden"],
                              activation="relu"))
            .layer(OutputLayer(n_in=c["hidden"], n_out=10,
                               activation="softmax", loss="mcxent"))
            .build())


def _csv_iterator(path, batch):
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    return RecordReaderDataSetIterator(CSVRecordReader(path=path), batch,
                                       label_index=64, num_possible_labels=10)


def records_csv(tmp, train, test):
    """CSVRecordReader → RecordReaderDataSetIterator → a fitted
    NormalizerStandardize set as its pre-processor → an MLN of dense
    layers through fit(iterator): held-out accuracy and images/s; a 3-step
    f32 run on the card against the CPU; the archive with the normalizer
    restored on the card to the same output bits."""
    import os
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.normalizers import \
        NormalizerStandardize
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import model_serializer
    c = RECORDS_MLN
    tr_path, te_path = os.path.join(tmp, "train.csv"), \
        os.path.join(tmp, "test.csv")
    _write_digit_csv(tr_path, *train)
    _write_digit_csv(te_path, *test)
    it = _csv_iterator(tr_path, c["batch"])
    t0 = time.perf_counter()
    norm = NormalizerStandardize().fit(it)
    fit_norm_s = time.perf_counter() - t0
    it.set_pre_processor(norm)
    held = next(iter(_csv_iterator(te_path, len(test[0]))))
    norm.pre_process(held)
    conf = _records_conf(c["seed"])
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    net.fit(it)                           # warm-up epoch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it, epochs=c["epochs"] - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = float((net.output(held.features).argmax(1)
                 == held.labels.argmax(1)).mean())
    rec = {"train": len(train[0]), "held_out": len(test[0]),
           "batch": c["batch"], "epochs": c["epochs"],
           "normalizer_fit_s": fit_norm_s, "timed_epochs": c["epochs"] - 1,
           "timed_s": wall,
           "images_per_s": len(train[0]) * (c["epochs"] - 1) / wall,
           "held_out_accuracy": acc, "bar": RECORDS_HELD_OUT_BAR,
           "final_score": float(net.score_)}
    assert acc >= RECORDS_HELD_OUT_BAR, rec
    # f32, card against CPU, from the same weights on the same batches
    card = MultiLayerNetwork(conf, device=DEVICE).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.set_params(card.params())
    it.reset()
    for _, ds in zip(range(RECORDS_CPU_STEPS), it):
        card.fit_batch(ds.features, ds.labels)
        cpu.fit_batch(ds.features, ds.labels)
    got, want = card.params(), cpu.params()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    rec["card_vs_cpu"] = {"steps": RECORDS_CPU_STEPS, "param_max_rel_err":
                          rel, "tol": CPU_GPU_TOL}
    assert rel <= CPU_GPU_TOL, rec
    # the archive carries the normalizer
    path = os.path.join(tmp, "digits.zip")
    model_serializer.write_model(net, path, normalizer=norm)
    back = model_serializer.restore_model(path)
    back_norm = model_serializer.restore_normalizer_from_file(path)
    raw = next(iter(_csv_iterator(te_path, len(test[0]))))
    again = DataSet(torch.from_numpy(raw.features).to(DEVICE), None)
    back_norm.pre_process(again)          # a batch on the card, normalised
    same_x = bool(np.array_equal(again.features.cpu().numpy(),
                                 held.features))
    same_out = bool(np.array_equal(back.output(again.features),
                                   net.output(held.features)))
    rec["archive"] = {"normalizer": type(back_norm).__name__,
                      "normalized_on_card_bitwise": same_x,
                      "output_bitwise": same_out}
    assert same_x and same_out, rec
    return rec


def _write_digit_sequences(tmp, x, y, rng):
    """A CSV file a digit: its 8 rows (8 pixels and the label), cut to a
    seeded length of min_len-max_len rows."""
    import os
    c = RECORDS_SEQ
    paths = []
    os.makedirs(tmp, exist_ok=True)
    for i, (img, lab) in enumerate(zip(x, y)):
        n = rng.randint(c["min_len"], c["max_len"] + 1)
        p = os.path.join(tmp, f"d{i:04d}.csv")
        with open(p, "w") as f:
            f.write("".join(",".join(str(int(v)) for v in row) + f",{lab}\n"
                            for row in img[:n]))
        paths.append(p)
    return paths


def _seq_conf():
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    c = RECORDS_SEQ
    return (NeuralNetConfiguration.Builder().seed(c["seed"])
            .updater("adam").learning_rate(c["lr"]).list()
            .layer(GravesLSTM(n_in=8, n_out=c["hidden"], activation="tanh"))
            .layer(RnnOutputLayer(n_in=c["hidden"], n_out=10,
                                  activation="softmax", loss="mcxent"))
            .build())


def records_sequences(tmp, train, test):
    """CSVSequenceRecordReader → SequenceRecordReaderDataSetIterator
    (ALIGN_END) → a GravesLSTM at the char-RNN's width and an
    RnnOutputLayer, per batch (masked batches): the LSTM kernels' launches
    by the wrappers and by torch.profiler over an epoch, the held-out
    accuracy at each digit's last row, and one masked f32 batch on the
    card against the CPU within the charrnn phase's bars."""
    import os
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.normalizers import \
        NormalizerStandardize
    from deeplearning4j_tpu_torch.datasets.records import (
        ALIGN_END, CSVSequenceRecordReader,
        SequenceRecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    c = RECORDS_SEQ
    rng = np.random.RandomState(c["seed"])
    tr = _write_digit_sequences(os.path.join(tmp, "seq_train"), *train, rng)
    te = _write_digit_sequences(os.path.join(tmp, "seq_test"), *test, rng)

    def iterator(paths, batch):
        return SequenceRecordReaderDataSetIterator(
            CSVSequenceRecordReader(paths), batch, num_possible_labels=10,
            label_index=8, alignment=ALIGN_END)
    it = iterator(tr, c["batch"])
    raw = next(iter(it))
    assert raw.features_mask is not None and raw.labels_mask is not None
    # ALIGN_END: every row's last step is real
    assert bool((raw.features_mask[:, -1] == 1).all())
    # the pixels standardised over the real steps only (the masked fit)
    norm = NormalizerStandardize().fit(it)
    it.set_pre_processor(norm)
    first = next(iter(it))
    n_batches = -(-len(tr) // c["batch"])
    net = MultiLayerNetwork(_seq_conf(), device=DEVICE).init()
    net.fit(it)                              # warm-up epoch
    torch.cuda.synchronize()
    reset_launches()                         # the main path starts here
    t0 = time.perf_counter()
    net.fit(it, epochs=c["epochs"] - 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seq, bwd = read_lstm_launches()          # ... ends
    assert seq == n_batches * (c["epochs"] - 2) and bwd > 0, (seq, bwd)
    # one more epoch under the profiler: the kernels on the device, as
    # many as the wrappers launched in it (the profiler can drop an event
    # at its start: another epoch is profiled then, up to five)
    for tries in range(1, 6):
        reset_launches()
        _, names, _ = profiled(lambda: net.fit(it))
        prof, wrapped = lstm_kernels(names), read_lstm_launches()
        if prof == wrapped:
            break
    assert prof == wrapped and prof[0] == n_batches, (prof, wrapped, tries)
    held = next(iter(iterator(te, len(te))))
    norm.pre_process(held)
    out = net.output(held.features, fmask=held.features_mask)
    acc = float((out[:, -1].argmax(-1) == held.labels[:, -1].argmax(-1))
                .mean())
    # f32 card against CPU, one masked batch from the same weights
    card = MultiLayerNetwork(_seq_conf(), device=DEVICE).init()
    cpu = MultiLayerNetwork(_seq_conf(), device="cpu").init()
    cpu.set_params(card.params())
    ds = first
    got = float(card.fit_batch(ds.features, ds.labels, ds.features_mask,
                               ds.labels_mask))
    want = float(cpu.fit_batch(ds.features, ds.labels, ds.features_mask,
                               ds.labels_mask))
    p_got, p_want = card.params(), cpu.params()
    rel = float(np.abs(p_got - p_want).max() / np.abs(p_want).max())
    rec = {"sequences": len(tr), "held_out": len(te), "batch": c["batch"],
           "hidden": c["hidden"], "lengths": [c["min_len"], c["max_len"]],
           "alignment": "ALIGN_END", "timed_epochs": c["epochs"] - 2,
           "timed_s": wall,
           "sequences_per_s": len(tr) * (c["epochs"] - 2) / wall,
           "held_out_last_step_accuracy": acc, "bar": RECORDS_SEQ_BAR,
           "kernel_launches": {"lstm_cell_fwd": seq, "lstm_cell_bwd": bwd,
                               "counted_by": "wrappers"},
           "profiled_epoch_kernels": {"lstm_seq_kernel": prof[0],
                                      "lstm_bwd_kernel": prof[1],
                                      "epochs_profiled": tries},
           "card_vs_cpu": {"loss_card": got, "loss_cpu": want,
                           "loss_abs_err": abs(got - want),
                           "param_max_rel_err": rel,
                           "tol": [CHARRNN_LOSS_TOL, CHARRNN_PARAM_RTOL]}}
    assert abs(got - want) <= CHARRNN_LOSS_TOL and \
        rel <= CHARRNN_PARAM_RTOL, rec
    assert acc >= RECORDS_SEQ_BAR, rec
    return rec


def phase_records(card):
    import tempfile
    t_phase = time.perf_counter()
    train, test = digits()
    rec = {"phase": "records", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        rec["csv_mln"] = records_csv(tmp, train, test)
        rec["sequences_lstm"] = records_sequences(tmp, train, test)
    rec["kernel_launches"] = rec["sequences_lstm"]["kernel_launches"]
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def _glove(device, **kw):
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    c = dict(GLOVE, **kw)
    return Glove(layer_size=c["layer_size"], window=c["window"],
                 x_max=c["x_max"], alpha=c["alpha"],
                 learning_rate=c["learning_rate"],
                 batch_size=c["batch_size"], epochs=c["epochs"],
                 seed=c["seed"], min_word_frequency=1, device=device)


def glove_fit(sents):
    """One Glove fit at GLOVE: the co-occurrence build's seconds, the
    distinct pairs, the training's pairs/s, each epoch's loss, peak
    memory, and the embedding."""
    import torch
    g = _glove(DEVICE)
    tokens = [g.tokenizer_factory.create(s).get_tokens() for s in sents]
    from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabWord
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g.build_vocab(Sequence([VocabWord(t) for t in toks])
                  for toks in tokens if toks)
    vocab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, cols, vals = g.co_occurrences(tokens).pairs()
    build_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    g._fit_pairs(rows, cols, vals)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    return g, {"vocab_s": vocab_s, "co_occurrence_build_s": build_s,
               "distinct_pairs": int(len(vals)), "fit_s": fit_s,
               "pairs_per_s": len(vals) * g.epochs / fit_s,
               "epoch_losses": list(g.epoch_losses_),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "package_kernel_launches":
                   list(read_launches() + read_lstm_launches())}


def glove_card_vs_cpu():
    import numpy as np
    c = GLOVE_SMALL
    sents = w2v_corpus(c["vocab"], c["total"], c["sent_len"], 1)
    tables = []
    for dev in (DEVICE, "cpu"):
        g = _glove(dev, layer_size=c["layer_size"], epochs=c["epochs"],
                   batch_size=c["batch_size"], seed=c["seed"])
        g.fit_corpus(sents)
        tables.append((g.lookup_table.all_vectors(), g.loss_))
    rel = float(np.abs(tables[0][0] - tables[1][0]).max()
                / np.abs(tables[1][0]).max())
    out = {"config": c, "max_rel_err": rel, "loss_card": tables[0][1],
           "loss_cpu": tables[1][1], "tolerance": GLOVE_CARD_CPU_RTOL}
    assert rel <= GLOVE_CARD_CPU_RTOL, out
    return out


def phase_glove(card):
    import torch
    t_phase = time.perf_counter()
    c = GLOVE
    t0 = time.perf_counter()
    sents = w2v_corpus(c["vocab"], c["full_total"], c["sent_len"],
                       c["corpus_seed"])[:c["total"] // c["sent_len"]]
    rec = {"phase": "glove", "config": c, "corpus_s":
           time.perf_counter() - t0, "card": card,
           "cut": f"bench_word2vec's corpus cut from {c['full_total']:,} "
                  f"to its first {c['total']:,} words"}
    fits = []
    for _ in range(2):
        g, r = glove_fit(sents)
        fits.append((g.lookup_table.syn0.clone(), r))
        del g
    (a, r0), (b, r1) = fits
    rec["fits"] = [r0, r1]
    rec["bitwise_across_two_fits"] = bool(torch.equal(a, b))
    rec["embedding_finite"] = bool(torch.isfinite(a).all())
    rec["card_vs_cpu"] = glove_card_vs_cpu()
    for r in (r0, r1):
        assert r["epoch_losses"][-1] < r["epoch_losses"][0], r
        assert r["package_kernel_launches"] == [0] * 5, r
    assert rec["bitwise_across_two_fits"] and rec["embedding_finite"], rec
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def _write_edge_list(path, n, m, seed):
    """~m edge lines over n vertices: a ring (every vertex connected) and
    seeded random pairs."""
    import numpy as np
    rng = np.random.RandomState(seed)
    a = rng.randint(0, n, m - n)
    b = rng.randint(0, n, m - n)
    ring = np.arange(n)
    src = np.concatenate([ring, a])
    dst = np.concatenate([(ring + 1) % n, b])
    with open(path, "w") as f:
        f.write("# seeded undirected graph\n")
        f.write("\n".join(f"{s},{d}" for s, d in zip(src, dst)) + "\n")


def deepwalk_round_trips(dw, tmp):
    """GraphVectorSerializer, then WordVectorSerializer's text, Google
    binary and zip, of the card-trained model, read back on the card."""
    import os
    import numpy as np
    from deeplearning4j_tpu_torch.graph import GraphVectorSerializer
    from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
    sv = dw._sv
    want = sv.lookup_table.all_vectors()
    words = sv.vocab.words()
    out = {}
    p = os.path.join(tmp, "graph_vectors.txt")
    GraphVectorSerializer.write_graph_vectors(dw, p)
    back = GraphVectorSerializer.read_graph_vectors(p)
    got = np.stack([back.get_vertex_vector(int(w)) for w in words])
    scale = float(np.abs(want).max())
    out["graph_vectors"] = {"max_abs_err": float(np.abs(got - want).max()),
                            "tol": 5e-9 + 1e-7 * scale}
    for fmt, write, read, atol, rtol in (
            ("text", "write_word_vectors", "read_word_vectors", TEXT_ATOL,
             TEXT_RTOL),
            ("binary", "write_google_binary", "read_google_binary", 0.0, 0.0),
            ("zip", "write_word2vec_model", "read_word2vec_model", 0.0, 0.0)):
        p = os.path.join(tmp, f"vectors.{fmt}")
        getattr(WordVectorSerializer, write)(sv, p)
        back = getattr(WordVectorSerializer, read)(p)
        assert back.vocab.words() == words
        got = back.lookup_table.all_vectors()
        excess = np.abs(got - want) - (atol + rtol * np.abs(want))
        out[fmt] = {"max_abs_err": float(np.abs(got - want).max()),
                    "atol": atol, "rtol": rtol,
                    "within": bool((excess <= 0).all()),
                    "bytes": os.path.getsize(p)}
    g = out["graph_vectors"]
    g["within"] = g["max_abs_err"] <= g["tol"]
    assert all(r["within"] for r in out.values()), out
    return out


def phase_deepwalk(card):
    import os
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.graph import DeepWalk, GraphLoader
    t_phase = time.perf_counter()
    c = DEEPWALK
    rec = {"phase": "deepwalk", "config": c, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "edges.csv")
        _write_edge_list(path, c["vertices"], c["edges"], c["seed"])
        t0 = time.perf_counter()
        g = GraphLoader.load_undirected_graph_edge_list_file(
            path, c["vertices"])
        rec["load_s"] = time.perf_counter() - t0
        degrees = [g.get_degree(v) for v in range(g.num_vertices())]
        rec["graph"] = {"vertices": g.num_vertices(),
                        "edges_out_total": int(sum(degrees)),
                        "max_degree": int(max(degrees))}
        dw = DeepWalk(vector_size=c["vector_size"],
                      window_size=c["window_size"],
                      walk_length=c["walk_length"],
                      walks_per_vertex=c["walks_per_vertex"],
                      batch_size=c["batch_size"], seed=c["seed"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        dw.fit(g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vecs = dw._sv.lookup_table.all_vectors()
        rec.update({"fit_s": dt, "vertices_per_s": c["vertices"] / dt,
                    "walk_tokens": c["vertices"] * c["walks_per_vertex"]
                    * (c["walk_length"] + 1),
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                    "trained_vertices": dw.num_vertices(),
                    "vectors_finite": bool(np.isfinite(vecs).all()),
                    "package_kernel_launches":
                        list(read_launches() + read_lstm_launches())})
        assert rec["vectors_finite"] and dw.num_vertices() == c["vertices"]
        assert rec["package_kernel_launches"] == [0] * 5, rec
        rec["round_trips"] = deepwalk_round_trips(dw, tmp)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def keras_trained_vgg():
    """TrainedModelHelper(VGG16) on the committed tiny VGG-shaped file:
    VGG16ImagePreProcessor, output() on the card and decode_predictions,
    against the same on the CPU."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.modelimport.trained_models import (
        TrainedModelHelper, TrainedModels)
    helper = TrainedModelHelper(TrainedModels.VGG16).set_path_to_h5(
        _keras_file("vgg16_tiny_k1_tf.h5"))
    card, cpu = helper.load_model(), helper.load_model(device="cpu")
    img = np.random.RandomState(SEED + 15).randint(
        0, 256, (4, 8, 8, 3)).astype(np.float32)
    ds = DataSet(img, None)
    TrainedModels.get_pre_processor(TrainedModels.VGG16).pre_process(ds)
    got, want = card.output(ds.features), cpu.output(ds.features)
    top_card = TrainedModels.decode_predictions(got)
    top_cpu = TrainedModels.decode_predictions(want)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    labels = [[lbl for _, lbl, _ in row] for row in top_card]
    rec = {"images": 4, "output_shape": list(got.shape),
           "card_vs_cpu_rel": rel, "top5_card": labels,
           "top5_equal": labels == [[lbl for _, lbl, _ in row]
                                    for row in top_cpu]}
    assert rec["top5_equal"] and rel <= KERAS_CARD_CPU_RTOL, rec
    return rec


# ---------------------------------------------------------------------------
# phase fused_autotune: bench.py's bench_fused (LeNet fit() with the
# fusion autotuner) uncut, against the per-batch arm
# ---------------------------------------------------------------------------
def _autotune_arm(arm):
    """Select an arm of ``fit()``: the armed autotuner (FUSE_STEPS unset),
    a pinned K, or per batch (K 1)."""
    import os
    os.environ.pop("DL4J_TORCH_FUSE_AUTOTUNE", None)
    os.environ.pop("DL4J_TORCH_FUSE_STEPS", None)
    if arm == "autotune":
        os.environ["DL4J_TORCH_FUSE_AUTOTUNE"] = "1"
    else:
        os.environ["DL4J_TORCH_FUSE_STEPS"] = str(arm)


def _probes():
    from deeplearning4j_tpu_torch import obs
    return obs.metrics.value("fuse.autotune_probes_total")


def autotune_run(conf, feats, labels, arm, ckdir):
    """bench_fused's run: a fresh net, FUSED_AUTOTUNE["warmup"] batches
    (the autotuner probes in them), then the best of ``fits`` timed fits
    of all the batches with a checkpoint every ``ckpt_every`` updates."""
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    cfg = FUSED_AUTOTUNE
    warm = cfg["warmup"] * cfg["batch"]
    _autotune_arm(arm)
    try:
        net = MultiLayerNetwork(conf, device=DEVICE).init()
        p0 = _probes()
        net.fit(ArrayDataSetIterator(feats[:warm], labels[:warm],
                                     cfg["batch"]))
        float(net.score_)
        probes_warm = _probes() - p0
        captures_warm = net._fused.captures if net._fused else 0
        best = 0.0
        p1 = _probes()
        for _ in range(cfg["fits"]):
            t0 = time.perf_counter()
            net.fit(ArrayDataSetIterator(feats, labels, cfg["batch"]),
                    checkpoint_every=cfg["ckpt_every"], checkpoint_dir=ckdir)
            float(net.score_)
            best = max(best, len(feats) / (time.perf_counter() - t0))
        torch.cuda.synchronize()
    finally:
        _fit_path(True)
        import os
        os.environ.pop("DL4J_TORCH_FUSE_AUTOTUNE", None)
    captures = net._fused.captures if net._fused else 0
    return {"net": net, "images_per_s": best,
            "probes_in_warmup": probes_warm,
            "probes_in_timed_fits": _probes() - p1,
            "graphs_captured_in_warmup": captures_warm,
            "graphs_captured_in_timed_fits": captures - captures_warm,
            "window_graphs": len(net._fused.graphs) if net._fused else 0,
            "fuse_stats": net._last_fuse_stats}


def autotune_bitwise(conf, feats, labels):
    """The autotuned fit against a fit pinned at the K it decided, from
    the same parameters over the same batches: bitwise (under
    ``cudnn.deterministic`` if the defaults differ). The decision is the
    phase's (adopted from memory: no probe)."""
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.tuning import autotuner
    n = 24 * FUSED_AUTOTUNE["batch"]
    seen = {}

    def run():
        params = []
        for arm in ("autotune", "pinned"):
            net = MultiLayerNetwork(conf, device=DEVICE).init()
            if arm == "pinned":
                arm = seen["k"]
            _autotune_arm(arm)
            try:
                p0 = _probes()
                net.fit(ArrayDataSetIterator(feats[:n], labels[:n],
                                             FUSED_AUTOTUNE["batch"]))
                seen.setdefault("probes", []).append(_probes() - p0)
            finally:
                _fit_path(True)
                import os
                os.environ.pop("DL4J_TORCH_FUSE_AUTOTUNE", None)
            if "k" not in seen:
                seen["k"] = autotuner.lookup_decision(
                    autotuner.model_key(net), autotuner.backend_key(DEVICE),
                    _lenet_bucket())
            params.append(net.params())
        return params
    out = _bitwise_or_deterministic(run)
    assert not any(seen["probes"]), seen
    return {"pinned_k": seen["k"], "batches": 24, **out}


def _lenet_bucket():
    b = FUSED_AUTOTUNE["batch"]
    return ("ds", (b, 28, 28, 1), (b, 10))


def phase_fused_autotune(card):
    import json as _json
    import os
    import tempfile
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.tuning import autotuner

    conf = zoo.lenet_mnist()
    _, _, feats, labels = lenet_images()
    assert len(feats) == FUSED_AUTOTUNE["batches"] * FUSED_AUTOTUNE["batch"]
    ladder = autotuner.candidate_ladder()
    saved = {k: os.environ.get(k) for k in ("DL4J_TORCH_TUNE_CACHE_DIR",
                                            "DL4J_TORCH_TRACE_DIR")}
    with tempfile.TemporaryDirectory() as tmp:
        tune_dir = os.path.join(tmp, "tune")
        os.environ["DL4J_TORCH_TUNE_CACHE_DIR"] = tune_dir
        # the obs layer fully on: metrics and span tracing, as bench_fused
        os.environ["DL4J_TORCH_TRACE_DIR"] = os.path.join(tmp, "trace")
        autotuner._reset_for_tests()
        try:
            auto = autotune_run(conf, feats, labels, "autotune",
                                os.path.join(tmp, "ck_auto"))
            plain = autotune_run(conf, feats, labels, 1,
                                 os.path.join(tmp, "ck_plain"))
            (path,) = [os.path.join(tune_dir, f) for f in
                       os.listdir(tune_dir)]
            with open(path, encoding="utf-8") as fh:
                doc = _json.loads(fh.read())
            entry = doc["decisions"][repr(_lenet_bucket())]
            k = entry["k"]
            bitwise = autotune_bitwise(conf, feats, labels)
            # a restarted process: the decisions in memory dropped, the
            # file on disk kept; a fresh model adopts K with 0 probes
            autotuner._reset_for_tests()
            _autotune_arm("autotune")
            try:
                fresh = MultiLayerNetwork(conf, device=DEVICE).init()
                p0 = _probes()
                warm = FUSED_AUTOTUNE["warmup"] * FUSED_AUTOTUNE["batch"]
                fresh.fit(ArrayDataSetIterator(feats[:warm], labels[:warm],
                                               FUSED_AUTOTUNE["batch"]))
                adopted = {"probes": _probes() - p0,
                           "k": autotuner.lookup_decision(
                               autotuner.model_key(fresh),
                               autotuner.backend_key(DEVICE),
                               _lenet_bucket())}
            finally:
                _fit_path(True)
                os.environ.pop("DL4J_TORCH_FUSE_AUTOTUNE", None)
            metrics = {name: obs.metrics.value(name) for name in (
                "fuse.autotune_probes_total", "fuse.selected_k",
                "checkpoint.commits_total", "train.dispatch_groups_total")}
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
            autotuner._reset_for_tests()
    assert auto["probes_in_warmup"] == len(ladder), auto
    assert auto["probes_in_timed_fits"] == 0, auto
    assert auto["graphs_captured_in_timed_fits"] == 0, auto
    assert auto["window_graphs"] == 1, auto
    assert plain["net"]._fused is None
    assert adopted == {"probes": 0, "k": k}, (adopted, k)
    assert bitwise["pinned_k"] == k
    del auto["net"], plain["net"]
    result = {"phase": "fused_autotune",
              "config": "zoo.lenet_mnist, bench.py:bench_fused uncut",
              **FUSED_AUTOTUNE, "ladder": list(ladder), "decided_k": k,
              "per_step_s_by_k": entry["per_step_s"],
              "autotune": auto, "per_batch": plain,
              "speedup": auto["images_per_s"] / plain["images_per_s"],
              "autotuned_vs_pinned": bitwise, "fresh_model_adopts": adopted,
              "metrics": metrics, "card": card}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase dropout_fused: AlexNet (an MLN) and GoogLeNet (a graph) with
# dropout through the fused loop, against the per-batch loop
# ---------------------------------------------------------------------------
def _dropout_images(kind, n, seed):
    import numpy as np
    cfg = DROPOUT_FUSED[kind]
    rng = np.random.default_rng(seed)
    b = cfg["batch"]
    x = rng.standard_normal((n * b, 224, 224, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n * b)]
    return x, y


def _dropout_net(kind):
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    if kind == "alexnet":
        return MultiLayerNetwork(zoo.alexnet(), device=DEVICE).init()
    return ComputationGraph(zoo.googlenet(), device=DEVICE).init()


def _dropout_iter(kind, x, y):
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, ArrayMultiDataSetIterator)
    b = DROPOUT_FUSED[kind]["batch"]
    if kind == "alexnet":
        return ArrayDataSetIterator(x, y, b)
    return ArrayMultiDataSetIterator([x], [y], batch_size=b)


def dropout_paths(kind, x, y):
    """Each path (fused at K 8, per batch) from the same parameters under
    cuDNN's default algorithms: 2 warm-up batches, the timed batches,
    then the same batches profiled (the busy share). Returns the
    counters and rates."""
    import os
    import torch
    cfg = DROPOUT_FUSED[kind]
    b, n = cfg["batch"], cfg["batches"]
    out = {}
    for path in ("fused", "per_batch"):
        os.environ["DL4J_TORCH_FUSE_STEPS"] = "8" if path == "fused" else "1"
        try:
            net = _dropout_net(kind)
            net.fit(_dropout_iter(kind, x[:2 * b], y[:2 * b]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(_dropout_iter(kind, x, y))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for _ in range(5):
                pwall, names, ops = profiled(
                    lambda: net.fit(_dropout_iter(kind, x, y)))
                if names:
                    break
            else:
                raise AssertionError("torch.profiler recorded no device "
                                     "event in five profiles")
            share = device_share(names, ops, n, wall / n * 1e3)
        finally:
            _fit_path(True)
        stats = net._last_fuse_stats
        out[path] = {"draws": net.dropout_draws,
                     "iteration": net.iteration,
                     "images_per_s": n * b / wall,
                     "ms_per_batch": wall / n * 1e3,
                     "busy_share": share["busy_share_of_timed_batch"],
                     "device_busy_ms_per_batch":
                         share["device_busy_ms_per_batch"],
                     "device_events_per_batch":
                         share["cuda_kernels_per_batch"]["all"],
                     "top_device_ops": share["top_device_ops"][:5],
                     "graphs_captured": net._fused.captures
                     if net._fused else 0, "fuse_stats": stats}
        del net
        torch.cuda.empty_cache()
    assert out["fused"]["graphs_captured"] == 1, out["fused"]
    assert out["per_batch"]["graphs_captured"] == 0
    assert out["fused"]["draws"] == out["per_batch"]["draws"] == 2 + 2 * n
    return out


def dropout_bitwise(kind, x, y):
    """8 batches fused at K 8 and per batch from the same parameters: the
    same bits and draw counter (under ``cudnn.deterministic`` if the
    defaults differ)."""
    import os
    b, n = DROPOUT_FUSED[kind]["batch"], 8

    def run():
        out = []
        for k in ("8", "1"):
            os.environ["DL4J_TORCH_FUSE_STEPS"] = k
            try:
                net = _dropout_net(kind)
                net.fit(_dropout_iter(kind, x[:n * b], y[:n * b]))
                out.append((net.params(), net.dropout_draws))
            finally:
                _fit_path(True)
        assert out[0][1] == out[1][1] == n, (out[0][1], out[1][1])
        return out[0][0], out[1][0]
    return {"batches": n, **_bitwise_or_deterministic(run)}


def dropout_nan_step(kind, x, y):
    """``nan-step@0:1`` in a fused group of 8 against the group without
    batch 1, from the same parameters: the same bits and the same draw
    counter (the rejected step's successor redraws its masks)."""
    import os
    import numpy as np
    import warnings
    from deeplearning4j_tpu_torch.testing import faults
    b = DROPOUT_FUSED[kind]["batch"]
    keep = np.r_[0:b, 2 * b:8 * b]

    def run():
        os.environ["DL4J_TORCH_FUSE_STEPS"] = "8"
        try:
            a = _dropout_net(kind)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with faults.inject("nan-step@0:1"):
                    a.fit(_dropout_iter(kind, x[:8 * b], y[:8 * b]))
            c = _dropout_net(kind)
            c.fit(_dropout_iter(kind, x[keep], y[keep]))
            assert a.nan_skipped_steps == 1
            assert a.dropout_draws == c.dropout_draws == 7
        finally:
            _fit_path(True)
        return a.params(), c.params()
    return _bitwise_or_deterministic(run)


def dropout_retain(kind):
    """The retain fraction of the first dropout layer's masks over the
    keys of draws 0..15 at its input's shape, within 5 binomial standard
    deviations of its retain probability."""
    import torch
    from deeplearning4j_tpu_torch.ops import random as random_mod
    net = _dropout_net(kind)
    i, layer = next((i, l) for i, l in enumerate(net.layers)
                    if (l.dropout or 0.0) not in (0.0, 1.0))
    width = layer.n_in * DROPOUT_FUSED[kind]["batch"]
    kept = 0
    for c in range(16):
        key = random_mod.DropoutKey(net.conf.seed, torch.tensor(
            c, dtype=torch.int64, device=DEVICE), i)
        kept += int(random_mod.dropout_keep(key, (width,), layer.dropout,
                                            DEVICE).sum())
    n = 16 * width
    p = layer.dropout
    sd = (n * p * (1 - p)) ** 0.5
    frac = kept / n
    assert abs(kept - p * n) <= 5 * sd, (kept, p * n, sd)
    return {"layer": i, "retain": p, "elements": n, "kept_fraction": frac,
            "bound": f"|kept - p n| <= 5 sd, sd = {sd:.1f}",
            "z": (kept - p * n) / sd}


def dropout_no_host_read(kind, x, y):
    """Three per-batch steps on batches already on the card, the guard
    off, under ``torch.cuda.set_sync_debug_mode("warn")``: no operation
    of a step waits for the card (with the guard on, its one deferred
    read a step, of the previous step's counter, is the only one)."""
    import os
    import warnings
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    b = DROPOUT_FUSED[kind]["batch"]
    net = _dropout_net(kind)
    xs = torch.from_numpy(x[:3 * b]).to(DEVICE)
    ys = torch.from_numpy(y[:3 * b]).to(DEVICE)

    def step(i):
        xb, yb = xs[i * b:(i + 1) * b], ys[i * b:(i + 1) * b]
        if kind == "alexnet":
            net.fit_batch(xb, yb)
        else:
            net.fit_batch(MultiDataSet([xb], [yb]))
    os.environ["DL4J_TORCH_NANGUARD"] = "0"
    try:
        step(0)                        # first use: allocations, cuDNN picks
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(1)
                step(2)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        os.environ.pop("DL4J_TORCH_NANGUARD", None)
    # each synchronising call warns "called a synchronizing CUDA
    # operation"; the mode's own notice that it is a prototype is not one
    syncs = [str(w.message)[:200] for w in seen
             if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs
    return {"steps": 2, "synchronizing_calls": 0}


def phase_dropout_fused(card):
    import os
    import numpy as np
    result = {"phase": "dropout_fused", "config": DROPOUT_FUSED,
              "card": card}
    # a group of 8 AlexNet batches (38.5 MB each) past the default 256 MB
    # staging cap would shrink to 6
    os.environ["DL4J_TORCH_TRANSFER_STAGE_BYTES"] = str(1 << 30)
    try:
        for kind in ("alexnet", "googlenet"):
            result[kind] = dropout_model(kind)
    finally:
        os.environ.pop("DL4J_TORCH_TRANSFER_STAGE_BYTES", None)
    emit(result)
    return result


def dropout_model(kind):
    """One configuration of phase dropout_fused: the two paths (bitwise,
    rates, busy share), a poisoned step, the retain fraction and the
    per-batch step's host reads."""
    import numpy as np
    cfg = DROPOUT_FUSED[kind]
    x, y = _dropout_images(kind, cfg["batches"], SEED + 11)
    t0 = time.perf_counter()
    paths = dropout_paths(kind, x, y)
    rec = {"paths": paths, "fused_vs_per_batch": dropout_bitwise(kind, x, y),
           "nan_step": dropout_nan_step(kind, x, y),
           "retain": dropout_retain(kind),
           "per_batch_host_reads": dropout_no_host_read(kind, x, y),
           "seconds": time.perf_counter() - t0}
    assert np.isfinite(paths["fused"]["images_per_s"])
    # the last fit's groups: its batches in groups of 8
    assert paths["fused"]["fuse_stats"]["fused_groups"] == \
        -(-cfg["batches"] // 8), paths["fused"]["fuse_stats"]
    return rec


# ---------------------------------------------------------------------------
# phase graph_fused: the char-RNN as a ComputationGraph through the fused
# loop (a tBPTT window a captured graph, over the LSTM vertices)
# ---------------------------------------------------------------------------
def graph_fused_turn(conf, data, params, k, profile):
    """A graph from ``params`` through ``fit(iterator)`` at ``k``: the
    warm-up batches, then the timed batches (profiled when asked), the
    launch counts set to 0 just before the timed run and read just
    after."""
    import os
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    os.environ["DL4J_TORCH_FUSE_STEPS"] = str(k)
    try:
        net = ComputationGraph(conf, device=DEVICE).init()
        net.set_params(params)
        net.fit(ListDataSetIterator(data[:CHARRNN_WARMUP]))
        torch.cuda.synchronize()
        captures_warm = net._fused.captures if net._fused else 0

        def timed():
            net.fit(ListDataSetIterator(data[CHARRNN_WARMUP:]))
        reset_launches()
        if profile:
            wall, names, ops = profiled(timed)
        else:
            t0 = time.perf_counter()
            timed()
            torch.cuda.synchronize()
            wall, names, ops = time.perf_counter() - t0, None, None
        calls = read_lstm_launches()
    finally:
        _fit_path(True)
    return {"net": net, "wall": wall, "names": names, "ops": ops,
            "calls": calls,
            "captures_warm": captures_warm,
            "captures": net._fused.captures if net._fused else 0}


def graph_fused_profiled(conf, data, start, want, tries=5):
    """``graph_fused_turn`` at K 8, profiled, until its profile counts
    ``want`` LSTM launches; returns the turn and the counts of the
    profiles run again (it fails after ``tries``)."""
    seen = []
    for _ in range(tries):
        turn = graph_fused_turn(conf, data, start, 8, True)
        got = lstm_kernels(turn["names"]) if turn["names"] else None
        if got == want:
            return turn, seen
        seen.append(got)
    raise AssertionError(f"torch.profiler counted {seen} LSTM launches in "
                         f"{tries} runs of the graph's fused loop, not "
                         f"{want}")


def phase_graph_fused(card, charrnn):
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    rng = np.random.RandomState(SEED + 3)     # phase charrnn's data
    data, _ = markov_batches(CHARRNN_WARMUP + CHARRNN_BATCHES, rng)
    seg, t = CHARRNN["tbptt_length"], CHARRNN["seq_len"]
    windows = t // seg
    want = (2 * windows * CHARRNN_BATCHES, 2 * t * CHARRNN_BATCHES)
    mconf = zoo.char_rnn(vocab_size=CHARRNN["vocab_size"],
                         hidden=CHARRNN["hidden"], tbptt_length=seg,
                         learning_rate=CHARRNN["learning_rate"])
    mln = MultiLayerNetwork(mconf, device=DEVICE).init()
    start = mln.params()
    conf = charrnn_graph_conf()
    # the main path: the graph's fused loop at K 8, its timed run
    # profiled (behind PROFILE_WARM spin kernels: late in the script the
    # profiler dropped the first window's events, 62 of 64 sequence
    # launches, PR 14); a run whose profile still counts otherwise than
    # `want` is run again from the same start, up to five times
    main, seen = graph_fused_profiled(conf, data, start, want)
    launches = lstm_kernels(main["names"])
    assert main["calls"] == (0, 0), main["calls"]
    assert main["captures_warm"] == main["captures"] == 1, main
    net = main["net"]
    assert net._last_fuse_stats["fused_groups"] == 1
    # the MultiLayerNetwork's fused turn from the same start
    _fit_path(True)
    mln.fit(ListDataSetIterator(data[:CHARRNN_WARMUP]))
    mln.fit(ListDataSetIterator(data[CHARRNN_WARMUP:]))
    mln_diff = float(np.abs(mln.params() - net.params()).max())
    assert mln_diff == 0.0, mln_diff
    ms_per_batch = main["wall"] / CHARRNN_BATCHES * 1e3
    chars = CHARRNN["batch"] * t * CHARRNN_BATCHES
    share = device_share(main["names"], main["ops"], CHARRNN_BATCHES,
                         ms_per_batch)
    # the dropout copy: retain 0.8 on the second LSTM, fused against per
    # batch, bitwise
    dconf = charrnn_graph_conf()
    dconf.vertices["lstm2"].layer.dropout = 0.8
    fused_d, seen_d = graph_fused_profiled(dconf, data, start, want)
    plain_d = graph_fused_turn(dconf, data, start, 1, False)
    d_launches = lstm_kernels(fused_d["names"])
    assert plain_d["calls"] == want, plain_d["calls"]
    d_diff = float(np.abs(fused_d["net"].params()
                          - plain_d["net"].params()).max())
    assert d_diff == 0.0, d_diff
    assert fused_d["net"].dropout_draws == plain_d["net"].dropout_draws == \
        (CHARRNN_WARMUP + CHARRNN_BATCHES) * windows
    result = {"phase": "graph_fused", "config": CHARRNN,
              "conf": "charrnn_graph_conf() (two GravesLSTM vertices, "
              "RnnOutputLayer, rmsprop, tBPTT 50)", "k": 8,
              "warmup_batches": CHARRNN_WARMUP,
              "timed_batches": CHARRNN_BATCHES,
              "chars_per_s": chars / main["wall"],
              "ms_per_batch": ms_per_batch,
              "charrnn_mln_fused_chars_per_s": charrnn["chars_per_s"],
              "kernel_launches": {"lstm_cell_fwd": launches[0],
                                  "lstm_cell_bwd": launches[1],
                                  "counted_by": "torch.profiler, the "
                                  "timed run",
                                  "profiles_run_again": seen},
              "wrapper_calls": list(main["calls"]),
              "graphs_captured_in_warmup": main["captures_warm"],
              "graphs_captured": main["captures"],
              "device_share": share,
              "params_vs_mln_fused_max_abs_diff": mln_diff,
              "dropout_copy": {
                  "retain": 0.8, "vertex": "lstm2",
                  "fused_vs_per_batch_max_abs_diff": d_diff,
                  "fused_chars_per_s": chars / fused_d["wall"],
                  "per_batch_chars_per_s": chars / plain_d["wall"],
                  "fused_kernel_launches": d_launches,
                  "profiles_run_again": seen_d,
                  "per_batch_wrapper_calls": list(plain_d["calls"]),
                  "draws": fused_d["net"].dropout_draws},
              "card": card}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase solvers: the line-search solvers on mlp_mnist, and LeNet under
# the six optax rules
# ---------------------------------------------------------------------------
def _recording_line_search(log):
    """A stand-in for ``solvers.backtrack_line_search`` that records each
    search's backtracks, step and Armijo margin (in float64, from the
    values the search compared)."""
    from deeplearning4j_tpu_torch.optimize import solvers
    real = solvers.backtrack_line_search

    def search(f, x, fx, g, d, **kw):
        probes = []

        def counted(v):
            fv = f(v)
            probes.append(fv)
            return fv
        step, fnew = real(counted, x, fx, g, d, **kw)
        gd = float(solvers._vdot(g, d))
        margin = float(fnew) - (float(fx) + 1e-4 * float(step) * gd)
        log.append({"probes": len(probes), "step": float(step),
                    "fx": float(fx), "armijo_margin": margin})
        return step, fnew
    return real, search


def solver_run(conf, x, y, device, algo, iterations, start):
    """``fit_batch`` once (``iterations`` solver iterations) on the whole
    batch from the parameters ``start``: the score before and after, the
    line searches' records, the forward evaluations an iteration and the
    call's seconds."""
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.optimize import solvers
    conf.optimization_algo = algo
    conf.iterations = iterations
    net = MultiLayerNetwork(conf, device=device).init()
    net.set_params(start)
    counts = {"value_and_grad": 0, "value": 0}
    vg, val = net._solver_value_and_grad, net._solver_value

    def count_vg(*a):
        counts["value_and_grad"] += 1
        return vg(*a)

    def count_v(*a):
        counts["value"] += 1
        return val(*a)
    net._solver_value_and_grad, net._solver_value = count_vg, count_v
    s0 = net.score(DataSet(x, y))
    log = []
    real, search = _recording_line_search(log)
    solvers.backtrack_line_search = search
    try:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = float(net.fit_batch(x, y))
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        solvers.backtrack_line_search = real
    return {"net": net, "score_before": s0, "score_after": score,
            "ms_per_call": secs * 1e3, "line_searches": log,
            "forward_evaluations_per_iteration":
                (counts["value"] + counts["value_and_grad"]) / iterations,
            "value_and_grad_calls": counts["value_and_grad"],
            "probe_calls": counts["value"]}


def solver_f64(algo, x, y):
    """The solver's loop in float64 on the card and on the CPU from the
    same parameters: the model's own value-and-gradient and forward over
    an f64 flat vector and f64 inputs, SOLVERS["iterations"] iterations.
    Returns the parameters' largest difference against their max abs and
    both runs' line-search records."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.optimize import solvers
    from deeplearning4j_tpu_torch.utils import flat_params
    start = None
    runs = []
    for device in (DEVICE, "cpu"):
        net = MultiLayerNetwork(zoo.mlp_mnist(), device=device).init()
        if start is None:
            start = net.params()
        net.set_params(start)
        vec0 = flat_params.params_to_vector(
            net.layers, net.params_list).detach().double()
        xs = torch.from_numpy(x).double().to(net.device)
        ys = torch.from_numpy(y).double().to(net.device)
        log = []
        real, search = _recording_line_search(log)
        solvers.backtrack_line_search = search
        try:
            run = solvers.solver_for(algo).make_run(
                net._solver_value_and_grad, SOLVERS["iterations"],
                value=net._solver_value)
            vec, score, _ = run(vec0, xs, ys, None, None, None)
        finally:
            solvers.backtrack_line_search = real
        runs.append((vec.detach().cpu().numpy(), float(score), log))
    (card, cs_, clog), (cpu, ps_, plog) = runs
    assert [a["probes"] for a in clog] == [a["probes"] for a in plog], \
        (algo, clog, plog)
    return {"params_card_vs_cpu_rel": float(np.abs(card - cpu).max()
                                            / np.abs(cpu).max()),
            "score_card": cs_, "score_cpu": ps_,
            "backtracks": [a["probes"] - 1 for a in clog]}


def solvers_card_vs_cpu(x, y):
    """mlp_mnist at full width under each solver, on the card and on the
    CPU from the same parameters (TF32 off), through ``fit_batch``
    (SOLVERS["iterations"] iterations): the score must fall on both;
    where every line search took the same steps on both, the f32
    parameters within SOLVER_CARD_CPU_RTOL; and in float64
    (``solver_f64``, which also covers a line search that decided
    otherwise in f32) within SOLVER_F64_RTOL, every line search
    deciding alike."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    # one start for both devices (a generator draws otherwise on each)
    start = MultiLayerNetwork(zoo.mlp_mnist(), device="cpu").init().params()
    it = SOLVERS["iterations"]
    # first use of the card's GEMMs, outside the timed calls
    solver_run(zoo.mlp_mnist(), x, y, DEVICE, "lbfgs", 1, start)
    out = {}
    for algo in ("lbfgs", "conjugate_gradient", "line_gradient_descent"):
        card = solver_run(zoo.mlp_mnist(), x, y, DEVICE, algo, it, start)
        cpu = solver_run(zoo.mlp_mnist(), x, y, "cpu", algo, it, start)
        for r in (card, cpu):
            assert r["score_after"] < r["score_before"], (algo, r)
        rec = {k: card[k] for k in (
            "score_before", "score_after", "ms_per_call",
            "forward_evaluations_per_iteration", "value_and_grad_calls",
            "probe_calls")}
        rec["cpu_score_after"] = cpu["score_after"]
        rec["cpu_ms_per_call"] = cpu["ms_per_call"]
        rec["backtracks"] = [a["probes"] - 1 for a in card["line_searches"]]
        cpu_bt = [a["probes"] - 1 for a in cpu["line_searches"]]
        want = cpu["net"].params()
        err = float(np.abs(card["net"].params() - want).max()
                    / np.abs(want).max())
        rec["f32_params_card_vs_cpu_rel"] = err
        if rec["backtracks"] == cpu_bt:
            assert err <= SOLVER_CARD_CPU_RTOL, (algo, err)
            rec["f32_decisions"] = "same"
        else:
            rec["f32_decisions"] = {"cpu_backtracks": cpu_bt}
        f64 = solver_f64(algo, x, y)
        assert f64["params_card_vs_cpu_rel"] <= SOLVER_F64_RTOL, (algo, f64)
        rec["f64"] = f64
        out[algo] = rec
    return out


def _lenet_batches(feats, labels, n):
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    return ArrayDataSetIterator(feats[:n * LENET_BATCH],
                                labels[:n * LENET_BATCH], LENET_BATCH)


def optax_rule(rule, feats, labels):
    """LeNet under ``optax:<rule>``, 16 batches fused at K 8 on the card
    and on the CPU from the same parameters: the loss must fall on the
    card, and the card's parameters lie within OPTAX_CARD_CPU of the
    CPU's (lion's sign can flip where an update rounds near 0: its
    elements may differ by up to 2 lr a step)."""
    import os
    import numpy as np
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    lr = OPTAX_LR[rule]
    conf = zoo.lenet_mnist(learning_rate=lr, updater=f"optax:{rule}")
    # one start for both devices (a generator draws otherwise on each)
    start = MultiLayerNetwork(conf, device="cpu").init().params()
    os.environ["DL4J_TORCH_FUSE_STEPS"] = "8"
    try:
        out = {}
        for device in (DEVICE, "cpu"):
            net = MultiLayerNetwork(conf, device=device).init()
            net.set_params(start)
            rec = _ScoreRecorder()
            net.set_listeners(rec)
            t0 = time.perf_counter()
            net.fit(_lenet_batches(feats, labels, 16))
            scores = [float(s) for s in rec.scores]
            out[device] = (net.params(), scores, time.perf_counter() - t0,
                           net)
    finally:
        _fit_path(True)
    card, cpu = out[DEVICE], out["cpu"]
    assert np.isfinite(card[1]).all()
    assert np.mean(card[1][-4:]) < np.mean(card[1][:4]), card[1]
    assert card[3]._fused.captures == 1
    diff = np.abs(card[0] - cpu[0])
    rel = float(diff.max() / np.abs(cpu[0]).max())
    bar = OPTAX_CARD_CPU_RTOL
    yard = None
    if rule in OPTAX_DERIVED_BAR:
        # rmsprop divides each gradient element by its own running scale,
        # so rounding grows step by step; its bar is DP_W2_CHAOS times the
        # drift of a CPU run from parameters perturbed by DP_W2_PERTURB
        rng = np.random.default_rng(SEED + 25)
        moved = (start * (1 + DP_W2_PERTURB * rng.standard_normal(
            start.size))).astype(np.float32)
        os.environ["DL4J_TORCH_FUSE_STEPS"] = "8"
        try:
            net = MultiLayerNetwork(conf, device="cpu").init()
            net.set_params(moved)
            net.fit(_lenet_batches(feats, labels, 16))
        finally:
            _fit_path(True)
        yard = float(np.abs(net.params() - cpu[0]).max()
                     / np.abs(cpu[0]).max())
        bar = DP_W2_CHAOS * yard
    if rule == "lion":
        assert float(diff.max()) <= 2 * lr * 16 + 1e-6, float(diff.max())
    else:
        assert rel <= bar, (rule, rel, bar)
    return {"lr": lr, "loss_first_4": float(np.mean(card[1][:4])),
            "loss_last_4": float(np.mean(card[1][-4:])),
            "params_card_vs_cpu_rel": rel,
            "params_card_vs_cpu_max_abs": float(diff.max()),
            "bar": None if rule == "lion" else bar,
            "perturbed_cpu_drift_rel": yard,
            "card_fit_s": card[2], "cpu_fit_s": cpu[2]}


def phase_solvers(card):
    import tempfile
    from deeplearning4j_tpu_torch.models import zoo
    train, _, feats, labels = lenet_images()
    x = train.features.reshape(len(train.features), -1)
    y = train.labels
    assert x.shape == (320, 784)
    t0 = time.perf_counter()
    result = {"phase": "solvers", "config": SOLVERS,
              "solvers": solvers_card_vs_cpu(x, y)}
    result["solvers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["optax"] = {rule: optax_rule(rule, feats, labels)
                       for rule in OPTAX_LR}
    with tempfile.TemporaryDirectory() as tmp:
        conf = zoo.lenet_mnist(learning_rate=OPTAX_LR["adamw"],
                               updater="optax:adamw")
        result["optax"]["adamw_resume"] = lenet_resume(conf, feats, labels,
                                                       tmp)
    result["optax_s"] = time.perf_counter() - t0
    result["card"] = card
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase pretrain: layer-wise pretraining on the fixture's real MNIST
# digits, at dl4j-examples 0.7's widths
# ---------------------------------------------------------------------------
def mnist_flat():
    """The fixture's 320 training and 64 held-out MNIST digits as
    [n, 784] f32 in [0, 1]."""
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    fixture = _repo_path(*MNIST_FIXTURE)
    train = MnistDataSetIterator(PRETRAIN_VAE["batch"], data_dir=fixture)
    test = MnistDataSetIterator(PRETRAIN_VAE["batch"], train=False,
                                data_dir=fixture)
    assert not train.synthetic
    x = train.features.reshape(len(train.features), -1)
    xt = test.features.reshape(len(test.features), -1)
    assert x.shape == (320, 784) and xt.shape == (64, 784)
    assert 0.0 <= x.min() and x.max() <= 1.0
    return x, xt


def _unlabelled(x, batch):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(x[i:i + batch], None) for i in range(0, len(x), batch)]


def vae_layer():
    from deeplearning4j_tpu_torch.nn.layers import VariationalAutoencoder
    v = PRETRAIN_VAE
    return VariationalAutoencoder(
        n_in=784, n_out=v["latent"], encoder_layer_sizes=v["encoder"],
        decoder_layer_sizes=v["decoder"], activation="leakyrelu",
        pzx_activation="identity", reconstruction_distribution="bernoulli",
        reconstruction_activation="sigmoid")


def _vae_builder():
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    v = PRETRAIN_VAE
    return (NeuralNetConfiguration.Builder().seed(v["seed"])
            .updater("rmsprop").learning_rate(v["lr"])
            .weight_init("xavier").regularization(True).l2(v["l2"]))


class _EpochScores:
    """An epoch's batches; each new pass keeps the model's device score
    of the pass before (its last batch's), with no host read."""

    def __init__(self, net, batches):
        self.net, self.batches, self.scores = net, batches, []

    def __iter__(self):
        if self.net._score is not None:
            self.scores.append(self.net._score)
        return iter(self.batches)


class _InjectedNormals:
    """The pretrain layers' N(0, 1) draws taken from ``draws`` in order
    (the test seam of ``nn/layers/pretrain.py``)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __enter__(self):
        import torch
        from deeplearning4j_tpu_torch.nn.layers import pretrain
        self.mod, self.real = pretrain, pretrain._normal

        def take(g, shape, like):
            d = self.draws.pop(0)
            assert tuple(d.shape) == tuple(shape), (d.shape, shape)
            return torch.from_numpy(d).to(device=like.device,
                                          dtype=like.dtype)
        pretrain._normal = take
        return self

    def __exit__(self, *exc):
        self.mod._normal = self.real
        assert exc[0] is not None or not self.draws, "draws left unused"


def _rel(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def vae_example(x, xt):
    """VariationalAutoEncoderExample: 784 -> (256, 256) -> 2 -> (256,
    256) -> Bernoulli over 784, ``net.pretrain(iterator, epochs=20)``."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    v = PRETRAIN_VAE
    conf = (_vae_builder().list().layer(vae_layer()).pretrain(True)
            .backprop(False).build())
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    layer = net.layers[0]
    xd, xtd = torch.from_numpy(x).to(net.device), \
        torch.from_numpy(xt).to(net.device)
    with torch.no_grad():
        at_mean_before = float(layer.pretrain_loss(net.params_list[0], xd,
                                                   None))
    epochs = _EpochScores(net, _unlabelled(x, v["batch"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(epochs, epochs=v["epochs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_epoch = [float(s) for s in epochs.scores + [net._score]]
    assert len(by_epoch) == v["epochs"] and np.isfinite(by_epoch).all()
    assert net.iteration == v["epochs"] * len(epochs.batches)
    with torch.no_grad():
        at_mean_after = float(layer.pretrain_loss(net.params_list[0], xd,
                                                  None))
        g = torch.Generator(device=net.device).manual_seed(SEED)
        logp = layer.reconstruction_log_probability(
            net.params_list[0], xtd, g, num_samples=v["log_prob_samples"])
        logp = logp.cpu().numpy()
        z = layer.forward(net.params_list[0], xtd, {})[0].cpu().numpy()
    assert np.isfinite(logp).all() and z.shape == (64, v["latent"])
    # the ELBO falls: the last three epochs' mean below the first three's
    assert np.mean(by_epoch[-3:]) < np.mean(by_epoch[:3]), by_epoch
    assert at_mean_after < at_mean_before
    return {"config": {k: list(vv) if isinstance(vv, tuple) else vv
                       for k, vv in v.items()},
            "params": net.num_params(),
            "neg_elbo_by_epoch_last_batch": by_epoch,
            "neg_elbo_at_mean_all_320": [at_mean_before, at_mean_after],
            "examples_per_s": len(x) * v["epochs"] / wall, "wall_s": wall,
            "test_reconstruction_log_probability_mean": float(logp.mean()),
            "test_latent_mean_abs": float(np.abs(z).mean()),
            "one_step_card_vs_cpu": vae_step_card_vs_cpu(conf, x)}


def vae_step_card_vs_cpu(conf, x):
    """One pretraining step of the VAE on the card and on the CPU from
    the same parameters, with the same eps injected: parameters and
    score within PRETRAIN_CARD_CPU_RTOL of their scale."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    b = PRETRAIN_VAE["batch"]
    start = MultiLayerNetwork(conf, device="cpu").init().params()
    eps = np.random.RandomState(SEED + 15).randn(
        b, PRETRAIN_VAE["latent"]).astype(np.float32)
    out = {}
    for device in (DEVICE, "cpu"):
        net = MultiLayerNetwork(conf, device=device).init()
        net.set_params(start)
        with _InjectedNormals([eps]):
            net.pretrain_layer(0, _unlabelled(x[:b], b))
        out[device] = (net.params(), float(net.score_))
    card, cpu = out[DEVICE], out["cpu"]
    rel = _rel(card[0], cpu[0])
    score_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
    assert rel <= PRETRAIN_CARD_CPU_RTOL and \
        score_rel <= PRETRAIN_CARD_CPU_RTOL, (rel, score_rel)
    return {"params_rel": rel, "score_rel": score_rel, "score": card[1],
            "moved_from_start_rel": _rel(card[0], start)}


def vae_vertex_equals_layer(x):
    """The example's VAE as a graph vertex (in -> vae -> out) through
    ``pretrain_vertex`` and as an MLN layer through ``pretrain_layer``,
    from the same parameters and draws: within PRETRAIN_VERTEX_TOL."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    v = PRETRAIN_VAE

    def out_layer():
        return OutputLayer(n_in=v["latent"], n_out=10, activation="softmax")
    mln = MultiLayerNetwork(_vae_builder().list().layer(vae_layer())
                            .layer(out_layer()).build(),
                            device=DEVICE).init()
    graph = ComputationGraph(
        _vae_builder().graph_builder().add_inputs("in")
        .add_layer("vae", vae_layer(), "in")
        .add_layer("out", out_layer(), "vae").set_outputs("out").build(),
        device=DEVICE).init()
    with torch.no_grad():
        for k, t in graph.params_map["vae"].items():
            t.copy_(mln.params_list[0][k])
    batches = _unlabelled(x, v["batch"])
    r = np.random.RandomState(SEED + 16)
    draws = [r.randn(len(d.features), v["latent"]).astype(np.float32)
             for d in batches]
    t0 = time.perf_counter()
    with _InjectedNormals(draws):
        mln.pretrain_layer(0, batches)
    with _InjectedNormals(draws):
        graph.pretrain_vertex("vae", batches)
    torch.cuda.synchronize()
    with torch.no_grad():
        err = max(float((graph.params_map["vae"][k] - p).abs().max()
                        / p.abs().max())
                  for k, p in mln.params_list[0].items())
    assert err <= PRETRAIN_VERTEX_TOL, err
    assert graph.iteration == mln.iteration == len(batches)
    return {"max_rel_diff": err, "batches": len(batches),
            "wall_s": time.perf_counter() - t0}


def _rbm_recon_error(net, i, x):
    """Layer ``i``'s (an RBM's) reconstruction MSE on the activations the
    layers below give ``x``."""
    import torch
    with torch.no_grad():
        h = torch.from_numpy(x).to(net.device)
        for j in range(i):
            h, _ = net.layers[j].forward(net.params_list[j], h, {})
        layer, p = net.layers[i], net.params_list[i]
        return float(((h - layer.prop_down(p, layer.prop_up(p, h))) ** 2)
                     .mean())


def deep_autoencoder(x):
    """DeepAutoEncoderExample: binary RBMs 784-1000-500-250-100-30 and the
    mirror 30-100-250-500-1000, an OutputLayer 1000 -> 784 (sigmoid, MSE),
    ``pretrain(true).backprop(true)``; cut to SGD (the reference refuses a
    line-search solver while pretraining) at batch 320."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                           ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import RBM, OutputLayer
    d = PRETRAIN_DEEP_AE
    widths = [784, *d["encoder"], *d["encoder"][-2::-1]]
    b = (NeuralNetConfiguration.Builder().seed(d["seed"]).iterations(1)
         .optimization_algo("stochastic_gradient_descent")
         .learning_rate(d["lr"]).list())
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        b = b.layer(RBM(n_in=n_in, n_out=n_out))
    conf = b.layer(OutputLayer(n_in=widths[-1], n_out=784,
                               activation="sigmoid", loss="mse")) \
        .pretrain(True).backprop(True).build()
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    n_rbm = len(widths) - 1
    data = [DataSet(x[i:i + d["batch"]], x[i:i + d["batch"]])
            for i in range(0, len(x), d["batch"])]
    passes = []
    t_pre = time.perf_counter()
    for i in range(n_rbm):
        before = _rbm_recon_error(net, i, x)
        t0 = time.perf_counter()
        net.pretrain_layer(i, ListDataSetIterator(data),
                           epochs=d["pass_epochs"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        passes.append({"layer": i, "n_in": widths[i], "n_out": widths[i + 1],
                       "recon_mse_before": before,
                       "recon_mse_after": _rbm_recon_error(net, i, x),
                       "examples_per_s": len(x) * d["pass_epochs"] / dt})
    pre_wall = time.perf_counter() - t_pre
    assert all(np.isfinite(p["recon_mse_after"]) for p in passes)
    # the first RBM, on the pixels, learns: its error falls
    assert passes[0]["recon_mse_after"] < passes[0]["recon_mse_before"]
    mse_before = float(((net.output(x) - x) ** 2).mean())
    it0 = net.iteration
    t0 = time.perf_counter()
    # fit() pretrains once a net (one more pass a layer here, its
    # contract), then backpropagates
    net.fit(ListDataSetIterator(data), epochs=d["backprop_epochs"])
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    assert net._pretrained
    assert net.iteration - it0 == len(data) * (n_rbm + d["backprop_epochs"])
    it1 = net.iteration
    net.fit(ListDataSetIterator(data))          # no second pretraining
    assert net.iteration - it1 == len(data)
    mse_after = float(((net.output(x) - x) ** 2).mean())
    assert np.isfinite(mse_after) and mse_after < mse_before, \
        (mse_before, mse_after)
    return {"widths": widths + [784], "params": net.num_params(),
            "cuts": {"optimization_algo": "stochastic_gradient_descent in "
                     "place of line_gradient_descent (refused while "
                     "pretraining)", "batch": f"{d['batch']} (the "
                     "fixture's whole set) in place of 1,000"},
            "config": {k: list(vv) if isinstance(vv, tuple) else vv
                       for k, vv in d.items()},
            "rbm_passes": passes, "pretrain_wall_s": pre_wall,
            "recon_mse_before_fit": mse_before,
            "recon_mse_after_fit": mse_after,
            "fit_examples_per_s":
                len(x) * (n_rbm + d["backprop_epochs"]) / fit_wall,
            "fit_wall_s": fit_wall}


def denoising_autoencoder(x):
    """The phase's own choice: one denoising AutoEncoder 784 -> 1000 at
    corruption 0.3 (sgd), its uncorrupted loss before and after."""
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import AutoEncoder
    a = PRETRAIN_DAE
    conf = (NeuralNetConfiguration.Builder().seed(SEED).learning_rate(a["lr"])
            .list().layer(AutoEncoder(n_in=784, n_out=a["n_out"],
                                      corruption_level=a["corruption"],
                                      activation="sigmoid"))
            .pretrain(True).build())
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    layer, xd = net.layers[0], torch.from_numpy(x).to(net.device)

    def loss():
        with torch.no_grad():
            return float(layer.pretrain_loss(net.params_list[0], xd, None))
    before = loss()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(_unlabelled(x, a["batch"]), epochs=a["epochs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = loss()
    assert after < before, (before, after)
    return {"config": a, "why": "the phase's own choice, not an example's",
            "loss_uncorrupted": [before, after],
            "examples_per_s": len(x) * a["epochs"] / wall, "wall_s": wall}


def phase_pretrain(card):
    t0 = time.perf_counter()
    x, xt = mnist_flat()
    result = {"phase": "pretrain",
              "data": "tests/fixtures/real_mnist: 320 training and 64 "
                      "held-out digits in place of MNIST's 60,000/10,000",
              "vae": vae_example(x, xt),
              "vae_vertex_vs_layer": vae_vertex_equals_layer(x),
              "deep_autoencoder": deep_autoencoder(x),
              "denoising_autoencoder": denoising_autoencoder(x)}
    result["seconds"] = time.perf_counter() - t0
    result["card"] = card
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase transfer: the char-RNN fine-tuned with a frozen layer under the
# EarlyStoppingTrainer, profiled by the ProfilerListener
# ---------------------------------------------------------------------------
def _bits(net):
    return [t.detach().cpu().numpy().copy() for p in net.params_list
            for t in p.values()]


def _same_bits(a, b):
    import numpy as np
    return len(a) == len(b) and all(np.array_equal(x, y, equal_nan=True)
                                    for x, y in zip(a, b))


def _trace_kernels(path):
    """(sequence, backward) LSTM kernel events in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("ph") == "X"]
    return lstm_kernels(names)


def phase_transfer(card):
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import early_stopping as es
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.transfer_learning import (
        TransferLearning)
    from deeplearning4j_tpu_torch.optimize.listeners import ProfilerListener
    t_phase = time.perf_counter()
    tr = TRANSFER
    v = CHARRNN["vocab_size"]
    conf = zoo.char_rnn(vocab_size=v, hidden=CHARRNN["hidden"],
                        tbptt_length=CHARRNN["tbptt_length"],
                        learning_rate=CHARRNN["learning_rate"])
    rng = np.random.RandomState(SEED + 17)
    data, floor = markov_batches(tr["base"] + tr["train"] + tr["held_out"],
                                 rng)
    base_data = data[:tr["base"]]
    train = data[tr["base"]:tr["base"] + tr["train"]]
    held = data[tr["base"] + tr["train"]:]
    base = MultiLayerNetwork(conf, device=DEVICE).init()
    t0 = time.perf_counter()
    base.fit(ListDataSetIterator(base_data))
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    base_bits = _bits(base)
    tuned = (TransferLearning.Builder(base).set_feature_extractor(0)
             .n_out_replace(2, v).build())
    assert tuned.layers[0].updater == "none" and tuned.layers[0].frozen
    frozen_bits = [t.detach().cpu().numpy().copy()
                   for t in tuned.params_list[0].values()]
    probe = held[0].features[:4]
    outputs, epoch_ends, fit_s = {}, [], []

    def on_epoch(epoch, score, net):
        outputs[epoch] = net.output(probe)
        epoch_ends.append(time.perf_counter())
    real_fit = tuned.fit

    def timed_fit(ds):
        # each batch's fit(DataSet) alone (it ends in the guard's host
        # read); the first batch holds the profiler's window
        t = time.perf_counter()
        real_fit(ds)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t)
    tuned.fit = timed_fit
    with tempfile.TemporaryDirectory() as tmp:
        prof = ProfilerListener(f"{tmp}/prof",
                                start_iteration=tr["profile_start"],
                                num_iterations=tr["profile_iterations"],
                                log_fn=lambda m: None)
        tuned.set_listeners(prof)
        cfg = es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(held),
            model_saver=es.LocalFileModelSaver(f"{tmp}/es"),
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(tr["max_epochs"]),
                es.ScoreImprovementEpochTerminationCondition(
                    tr["patience"])])
        torch.cuda.synchronize()
        reset_launches()                      # the main path starts here
        t0 = time.perf_counter()
        res = es.EarlyStoppingTrainer(cfg, tuned, train, on_epoch).fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_lstm_launches()       # ... and ends here
        del tuned.fit
        prof.close(tuned)
        assert prof.captured, "the profiler window did not close"
        trace_kernels = _trace_kernels(prof.trace_path)
        trace_name = prof.trace_path.split(f"{tmp}/")[-1]
        best = res.best_model
        best_bits = np.array_equal(best.output(probe),
                                   outputs[res.best_model_epoch])
    assert best_bits, "the restored best model differs from the saved net"
    assert best.device == tuned.device, best.device
    frozen_same = _same_bits(frozen_bits,
                             [t.detach().cpu().numpy()
                              for t in tuned.params_list[0].values()])
    base_same = _same_bits(base_bits, _bits(base))
    assert frozen_same and base_same, (frozen_same, base_same)
    epochs_run = res.total_epochs
    batches = epochs_run * len(train)
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    n_layers = 2
    want = (n_layers * windows * batches, n_layers * CHARRNN["seq_len"]
            * batches)
    # every batch through fit(DataSet): each window on the per-batch path,
    # whose wrappers launch every kernel; the held-out scoring and the
    # listener's probe output add one forward launch a layer a batch an
    # epoch (no backward)
    scored = n_layers * (len(held) + 1) * epochs_run
    assert launches == (want[0] + scored, want[1]), (launches, want, scored)
    assert trace_kernels[0] >= 1 and trace_kernels[1] >= 1, trace_kernels
    assert res.termination_reason == "EpochTerminationCondition"
    scores = [res.score_vs_epoch[e] for e in sorted(res.score_vs_epoch)]
    assert np.isfinite(scores).all()
    result = {"phase": "transfer", "config": {**CHARRNN, **tr},
              "base_fit_s": base_s,
              "builder": "TransferLearning.Builder(base)"
                         ".set_feature_extractor(0).n_out_replace(2, "
                         f"{v}).build()",
              "layer0_bitwise_unchanged": frozen_same,
              "base_bitwise_unchanged": base_same,
              "termination_reason": res.termination_reason,
              "termination_details": res.termination_details,
              "held_out_loss_by_epoch": scores,
              "best_model_epoch": res.best_model_epoch,
              "best_model_score": res.best_model_score,
              "total_epochs": epochs_run,
              "loss_floor_per_batch": floor * CHARRNN["seq_len"],
              "restored_best_output_bitwise": best_bits,
              "trace_file": trace_name,
              "trace_lstm_kernel_events": {"lstm_cell_fwd": trace_kernels[0],
                                           "lstm_cell_bwd": trace_kernels[1]},
              "trace_window": [tr["profile_start"] + 1,
                               tr["profile_start"] + tr["profile_iterations"]],
              "kernel_launches": {"lstm_cell_fwd": launches[0],
                                  "lstm_cell_bwd": launches[1],
                                  "counted_by": "the wrappers"},
              "ms_per_batch": wall / batches * 1e3,
              "fit_ms_per_batch_median": float(np.median(fit_s)) * 1e3,
              "fit_ms_first_batch_with_profile": fit_s[0] * 1e3,
              "epoch_wall_s": [b - a for a, b in zip([t0] + epoch_ends,
                                                       epoch_ends)],
              "fine_tune_wall_s": wall,
              "seconds": time.perf_counter() - t_phase, "card": card}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase gradcheck: the gradient checker on the card in float64
# ---------------------------------------------------------------------------
def _gradcheck_nets():
    """(name, MultiLayerNetwork or ComputationGraph configuration, data)
    of the checks that must pass on the card."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration as B)
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, DenseLayer, OutputLayer,
        SubsamplingLayer, VariationalAutoencoder)
    r = np.random.RandomState(SEED + 18)
    out = []
    for loss, act in (("mse", "identity"), ("l1", "identity"),
                      ("xent", "sigmoid"), ("mcxent", "softmax"),
                      ("squared_hinge", "identity"),
                      ("poisson", "softplus"),
                      ("cosine_proximity", "identity")):
        conf = (B.Builder().seed(42).list()
                .layer(DenseLayer(n_in=3, n_out=6, activation="tanh"))
                .layer(OutputLayer(n_out=4, activation=act, loss=loss))
                .build())
        y = {"xent": lambda: (r.rand(5, 4) > 0.5).astype(float),
             "mcxent": lambda: np.eye(4)[r.randint(0, 4, 5)],
             "squared_hinge": lambda: 2.0 * (r.rand(5, 4) > 0.5) - 1.0,
             "poisson": lambda: r.poisson(2.0, (5, 4)).astype(float)}.get(
                 loss, lambda: r.randn(5, 4))()
        out.append((f"mlp_{loss}", conf, (r.randn(5, 3), y)))
    cnn = (B.Builder().seed(42).list()
           .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                   activation="tanh"))
           .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                   stride=(2, 2)))
           .layer(BatchNormalization())
           .layer(DenseLayer(n_out=5, activation="tanh"))
           .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
           .set_input_type(InputType.convolutional(6, 6, 2)).build())
    out.append(("cnn_conv_pool_bn_dense", cnn,
                (r.randn(4, 6, 6, 2), np.eye(2)[r.randint(0, 2, 4)])))
    vae = (B.Builder().seed(42).list()
           .layer(VariationalAutoencoder(n_in=4, n_out=3,
                                         encoder_layer_sizes=(5,),
                                         decoder_layer_sizes=(5,),
                                         activation="tanh"))
           .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
           .build())
    out.append(("vae_supervised", vae,
                (r.randn(5, 4), np.eye(2)[r.randint(0, 2, 5)])))
    graph = (B.Builder().seed(3).graph_builder().add_inputs("a", "b")
             .add_layer("da", DenseLayer(n_in=3, n_out=4, activation="tanh"),
                        "a")
             .add_layer("db", DenseLayer(n_in=2, n_out=4,
                                         activation="sigmoid"), "b")
             .add_vertex("merge", MergeVertex(), "da", "db")
             .add_layer("out", OutputLayer(n_in=8, n_out=2,
                                           activation="softmax"), "merge")
             .set_outputs("out").build())
    out.append(("graph_merge", graph,
                MultiDataSet([r.randn(5, 3), r.randn(5, 2)],
                             [np.eye(2)[r.randint(0, 2, 5)]])))
    return out


def phase_gradcheck(card):
    import numpy as np
    from deeplearning4j_tpu_torch.gradientcheck import (
        gradient_check_util as gc)
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration as B)
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    t_phase = time.perf_counter()
    checks = {}
    for name, conf, data in _gradcheck_nets():
        is_graph = not isinstance(data, tuple)
        nets = {}
        for device in (DEVICE, "cpu"):
            net = (ComputationGraph if is_graph else MultiLayerNetwork)(
                conf, device=device).init()
            if device != DEVICE:
                net.set_params(nets[DEVICE].params())
            nets[device] = net
        card_net = nets[DEVICE]
        t0 = time.perf_counter()
        if is_graph:
            ok, max_rel, fails = gc.check_gradients_graph(
                card_net, data, max_rel_error=GRADCHECK_MAX_REL)
            grads = [gc.analytic_gradient(*gc._graph_loss(n, data))
                     for n in (card_net, nets["cpu"])]
        else:
            ok, max_rel, fails = gc.check_gradients(
                card_net, *data, max_rel_error=GRADCHECK_MAX_REL)
            grads = [gc.analytic_gradient(*gc._mln_loss(n, *data))
                     for n in (card_net, nets["cpu"])]
        dt = time.perf_counter() - t0
        assert ok, (name, max_rel, fails)
        rel = _rel(grads[0], grads[1])
        assert rel <= GRADCHECK_CARD_CPU, (name, rel)
        checks[name] = {"passed": ok, "max_rel_error": max_rel,
                        "params": card_net.num_params(),
                        "analytic_card_vs_cpu_rel": rel, "seconds": dt}
    lstm = (B.Builder().seed(42).list()
            .layer(GravesLSTM(n_in=3, n_out=4, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")).build())
    r = np.random.RandomState(SEED + 19)
    net = MultiLayerNetwork(lstm, device=DEVICE).init()
    try:
        gc.check_gradients(net, r.randn(3, 4, 3),
                           np.eye(2)[r.randint(0, 2, (3, 4))])
    except TypeError as e:
        refusal = str(e)
    else:
        raise AssertionError("a float64 LSTM check ran on the card")
    assert "float32 or bfloat16" in refusal, refusal
    result = {"phase": "gradcheck", "dtype": "float64",
              "max_rel_error_bar": GRADCHECK_MAX_REL,
              "card_vs_cpu_bar": GRADCHECK_CARD_CPU, "checks": checks,
              "lstm_float64_refusal": refusal,
              "seconds": time.perf_counter() - t_phase, "card": card}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase tsne_kmeans: k-means and t-SNE on the whole digits fixture
# ---------------------------------------------------------------------------
def all_digits():
    """The fixture's 1,797 digits (scikit-learn's; train then test) as
    [n, 64] f32 in [0, 1]."""
    import numpy as np
    (x, _), (xt, _) = digits()
    out = np.concatenate([x, xt]).reshape(-1, 64).astype(np.float32) / 255
    assert out.shape == (1797, 64)
    return out


def phase_tsne_kmeans(card):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
    t_phase = time.perf_counter()
    x = all_digits()
    km = {}
    for device in (DEVICE, "cpu"):
        k = KMeansClustering.setup(KMEANS["k"], KMEANS["max_iterations"],
                                   seed=SEED, device=device)
        t0 = time.perf_counter()
        cs = k.apply_to(x)
        dt = time.perf_counter() - t0
        assign = np.empty(len(x), np.int64)
        for c in cs.clusters:
            for p in c.points:
                assign[int(p.id)] = c.idx
        km[device] = (assign, cs.get_centers(), k.iterations_done, dt)
    agree = float((km[DEVICE][0] == km["cpu"][0]).mean())
    assert agree >= KMEANS["agreement_bar"], agree
    centers = km[DEVICE][1]
    cost = float(np.linalg.norm(x - centers[km[DEVICE][0]], axis=1).sum())
    ts = {}
    for device in (DEVICE, "cpu"):
        t = Tsne(max_iter=TSNE["max_iter"], perplexity=TSNE["perplexity"],
                 seed=SEED, device=device)
        t0 = time.perf_counter()
        y = t.fit(x)
        if device == DEVICE:
            torch.cuda.synchronize()
        ts[device] = (y, t.kl_, time.perf_counter() - t0)
    assert np.isfinite(ts[DEVICE][0]).all()
    kl_rel = abs(ts[DEVICE][1] - ts["cpu"][1]) / ts["cpu"][1]
    assert kl_rel <= TSNE["kl_rel_bar"], (ts[DEVICE][1], ts["cpu"][1])
    bh = BarnesHutTsne(theta=BH_TSNE["theta"], max_iter=BH_TSNE["max_iter"],
                       perplexity=TSNE["perplexity"], seed=SEED)
    xb = x[:BH_TSNE["points"]]
    t0 = time.perf_counter()
    yb = bh.fit(xb)
    bh_s = time.perf_counter() - t0
    assert np.isfinite(yb).all() and np.isfinite(bh.kl_)
    result = {"phase": "tsne_kmeans",
              "data": "tests/fixtures/real_digits, all 1,797 x 64, "
                      "scaled to [0, 1]",
              "kmeans": {**KMEANS, "iterations_card": km[DEVICE][2],
                         "iterations_cpu": km["cpu"][2],
                         "assignment_agreement": agree,
                         "assignments_identical": agree == 1.0,
                         "cost_card": cost, "card_s": km[DEVICE][3],
                         "cpu_s": km["cpu"][3]},
              "tsne_exact": {**TSNE, "kl_card": ts[DEVICE][1],
                             "kl_cpu": ts["cpu"][1], "kl_rel": kl_rel,
                             "card_s": ts[DEVICE][2], "cpu_s": ts["cpu"][2],
                             "card_ms_per_iteration_incl_p":
                                 ts[DEVICE][2] / TSNE["max_iter"] * 1e3},
              "tsne_barnes_hut": {**BH_TSNE, "kl": bh.kl_, "host_s": bh_s,
                                  "cut": BH_TSNE_CUT},
              "seconds": time.perf_counter() - t_phase, "card": card}
    emit(result)
    return result



# ---------------------------------------------------------------------------
# phase dp: data parallelism over torch.distributed. (a) a world of one
# rank over NCCL in this process: the slice's LM at every ZeRO level
# against the unsharded LM, and ParallelWrapper over the char-RNN through
# the fused loop against net.fit; (b) a world of two gloo ranks, two
# processes sharing the card (NCCL refuses two ranks on one device)
# ---------------------------------------------------------------------------
def _dp_device_arg():
    """What the ranks pass as ``device``: None (the card) on the card, the
    CPU device in a rehearsal."""
    return None if DEVICE == "cuda" else DEVICE


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _charrnn_conf():
    from deeplearning4j_tpu_torch.models import zoo
    return zoo.char_rnn(vocab_size=CHARRNN["vocab_size"],
                        hidden=CHARRNN["hidden"],
                        tbptt_length=CHARRNN["tbptt_length"],
                        learning_rate=CHARRNN["learning_rate"])


def _charrnn_data(n):
    """Phase charrnn's seeded batches (its first ``n``)."""
    import numpy as np
    return markov_batches(n, np.random.RandomState(SEED + 3))[0]


def _lm_batch(conf):
    """Phase train's batch of next-token rows."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 1)
    return torch.from_numpy(rng.randint(0, conf.vocab_size,
                                        (TRAIN_BATCH, conf.max_len)))


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _peak_bytes(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _reset_peak(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_world1_lm(dev):
    """The slice's LM, unsharded and at each level of a world-1 plan, from
    the same parameters on the same batch: DP_LM_WARMUP + DP_LM_STEPS
    ``fit_batch`` steps each, the timed steps' launches by the wrappers.
    A plan of width 1 skips every collective and slice, so each level's
    losses and parameters must equal the unsharded run's bit for bit."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, _flatten)
    conf = TransformerConfig(**SLICE)
    batch = _lm_batch(conf).to(dev)
    tokens = TRAIN_BATCH * (conf.max_len - 1)
    runs, want = {}, None
    for level in (None,) + DP_LEVELS:
        lm = TransformerLM(conf, device=dev).init()
        if level is not None:
            lm.shard(level=level, device=dev)
            assert lm._shard_plan.n == 1 and lm._shard_plan.level == level
        losses = [float(lm.fit_batch(batch)) for _ in range(DP_LM_WARMUP)]
        _reset_peak(dev)
        reset_launches()                      # the main path starts here
        t0 = time.perf_counter()
        scores = [lm.fit_batch(batch) for _ in range(DP_LM_STEPS)]
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_launches()            # ... and ends here
        peak = _peak_bytes(dev)
        losses += [float(s) for s in scores]
        assert all(math.isfinite(x) for x in losses), losses
        assert launches == (conf.n_layers * DP_LM_STEPS,) * 3, launches
        params = {k: v.detach() for k, v in _flatten(lm.params).items()}
        name = "unsharded" if level is None else f"level{level}"
        rec = {"losses": losses, "step_ms": wall / DP_LM_STEPS * 1e3,
               "tokens_per_s": tokens * DP_LM_STEPS / wall,
               "peak_memory_bytes": peak,
               "param_bytes": _nbytes(lm._plan_leaves("params")),
               "optimizer_bytes": _nbytes(lm._plan_leaves("opt_state")),
               "kernel_launches": dict(zip(
                   ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"),
                   launches))}
        if level is None:
            want = (losses, {k: v.clone() for k, v in params.items()})
        else:
            rec["losses_bitwise"] = losses == want[0]
            rec["params_bitwise"] = all(torch.equal(params[k], v)
                                        for k, v in want[1].items())
            assert rec["losses_bitwise"] and rec["params_bitwise"], level
        runs[name] = rec
        del lm, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    total = [sum(r["kernel_launches"][k] for n, r in runs.items()
                 if n != "unsharded") for k in ("flash_attn_fwd",
                                                "flash_attn_dq",
                                                "flash_attn_dkv")]
    return {"config": SLICE, "batch": TRAIN_BATCH, "warmup_steps":
            DP_LM_WARMUP, "timed_steps": DP_LM_STEPS, "runs": runs,
            "launches_sharded_runs": total,
            "collectives": "none: a plan of width 1 skips them (as XLA "
                           "does on one device); world 2 runs them"}


def dp_world1_charrnn(dev, tries=5):
    """ParallelWrapper over the full-width char-RNN at width 1 through
    ``fit()``: the fused loop, each tBPTT window a replayed CUDA graph
    captured in the warm-up, the timed run profiled (a replay calls no
    wrapper, so the LSTM kernels are counted by name); the parameters
    against ``net.fit`` on the same stream, bit for bit."""
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    conf = _charrnn_conf()
    data = _charrnn_data(CHARRNN_WARMUP + CHARRNN_BATCHES)
    warm, timed = data[:CHARRNN_WARMUP], data[CHARRNN_WARMUP:]
    _fit_path(True)
    ref = MultiLayerNetwork(conf, device=dev).init()
    ref.fit(ListDataSetIterator(warm))
    ref.fit(ListDataSetIterator(timed))
    want = ref.params()
    del ref
    for _ in range(tries):
        net = MultiLayerNetwork(conf, device=dev).init()
        pw = ParallelWrapper(net, device=dev)
        pw.fit(ListDataSetIterator(warm))
        captures_warm = net._fused.captures
        _reset_peak(dev)
        reset_launches()                      # the main path starts here
        before = read_lstm_launches()
        wall, names, _ = profiled(
            lambda: pw.fit(ListDataSetIterator(timed)))
        calls = tuple(a - b for a, b in zip(read_lstm_launches(), before))
        if names:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no device event in "
                             f"{tries} runs of the wrapper's fused fit")
    peak = _peak_bytes(dev)
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    n_layers = sum(hasattr(l, "initial_carry") for l in conf.layers)
    per_batch = (n_layers * windows, n_layers * CHARRNN["seq_len"])
    launches = lstm_kernels(names)
    assert launches == tuple(x * CHARRNN_BATCHES for x in per_batch), \
        launches
    assert calls == (0, 0), calls             # replays only
    assert captures_warm == net._fused.captures == 1, net._fused.captures
    got = net.params()
    assert (got == want).all(), float(abs(got - want).max())
    return {"config": CHARRNN, "workers": pw.workers, "path": "fused",
            "timed_batches": CHARRNN_BATCHES,
            "ms_per_batch": wall / CHARRNN_BATCHES * 1e3,
            "chars_per_s": CHARRNN["batch"] * CHARRNN["seq_len"]
            * CHARRNN_BATCHES / wall,
            "kernel_launches": {"lstm_cell_fwd": launches[0],
                                "lstm_cell_bwd": launches[1],
                                "counted_by": "torch.profiler, the timed "
                                              "run"},
            "kernel_launches_per_batch": dict(zip(
                ("lstm_cell_fwd", "lstm_cell_bwd"), per_batch)),
            "graphs_captured_in_warmup": captures_warm,
            "peak_memory_bytes": peak, "params_bitwise_net_fit": True}


def _one_window(data):
    """The first batch cut to one tBPTT window: one update."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    seg = CHARRNN["tbptt_length"]
    return DataSet(data[0].features[:, :seg].copy(),
                   data[0].labels[:, :seg].copy())


def _dp_lbfgs_conf():
    """Phase solvers' LeNet under lbfgs (DP_SOLVER["iterations"] solver
    iterations a batch)."""
    from deeplearning4j_tpu_torch.models import zoo
    conf = zoo.lenet_mnist()
    conf.optimization_algo = "lbfgs"
    conf.iterations = DP_SOLVER["iterations"]
    return conf


def _dp_lbfgs_data():
    """The first DP_SOLVER["batches"] global batches of the fixture's
    digits."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    _, _, feats, labels = lenet_images()
    b = DP_SOLVER["batch"]
    return [DataSet(feats[i:i + b], labels[i:i + b])
            for i in range(0, b * DP_SOLVER["batches"], b)]


def _dp_vae_conf():
    """Phase pretrain's VAE (784 -> 256, 256 -> 2 -> 256, 256 ->
    Bernoulli)."""
    return (_vae_builder().list().layer(vae_layer()).pretrain(True)
            .backprop(False).build())


def _dp_vae_data():
    """The first DP_VAE["batches"] global batches of the digits, [B, 784]."""
    x, _ = mnist_flat()
    b = DP_VAE["batch"]
    return [x[i:i + b] for i in range(0, b * DP_VAE["batches"], b)]


def _dp_lbfgs_vae_world1(dev):
    """World 1 on the global batches: the LeNet under lbfgs through
    ParallelWrapper (one solver call a batch, as at world 2) and the VAE
    pretrained, each also from its initial parameters perturbed by
    DP_W2_PERTURB (seeded)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    out = {}
    for name, conf in (("lbfgs", _dp_lbfgs_conf()),
                       ("vae", _dp_vae_conf())):
        runs = []
        for scale in (0.0, DP_W2_PERTURB):
            net = MultiLayerNetwork(conf, device=dev).init()
            if scale:
                p0 = net.params()
                rng = np.random.default_rng(SEED + 18)
                net.set_params((p0 * (1 + scale * rng.standard_normal(
                    p0.size))).astype(np.float32))
            if name == "lbfgs":
                ParallelWrapper(net, device=dev).fit(
                    ListDataSetIterator(_dp_lbfgs_data()))
            else:
                net.pretrain([DataSet(x, None) for x in _dp_vae_data()],
                             epochs=DP_VAE["epochs"])
            runs.append((net.params(), float(net.score_)))
        out[name] = {"params": runs[0][0], "score": runs[0][1],
                     "perturbed": runs[1][0]}
    return out


def dp_world1_reference(dev):
    """World 1's results on what world 2 trains (per batch): the char-RNN's
    parameters after one window and after the first DP_CHARRNN_BATCHES
    batches, the latter also from the initial parameters perturbed by
    DP_W2_PERTURB (relative, seeded: the yardstick of f32 rounding's
    growth), and the 2-layer LM's DP_LM2_STEPS losses."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    conf, data = _charrnn_conf(), _charrnn_data(DP_CHARRNN_BATCHES)
    _fit_path(False)
    try:
        net = MultiLayerNetwork(conf, device=dev).init()
        p0 = net.params()
        net.fit(_one_window(data))
        step = net.params()
        net = MultiLayerNetwork(conf, device=dev).init()
        net.fit(ListDataSetIterator(data))
        rng = np.random.default_rng(SEED + 17)
        p1 = (p0 * (1 + DP_W2_PERTURB * rng.standard_normal(p0.size))
              ).astype(np.float32)
        other = MultiLayerNetwork(conf, device=dev).init(params=p1)
        other.fit(ListDataSetIterator(data))
    finally:
        _fit_path(True)
    lconf = TransformerConfig(**DP_LM2)
    lm = TransformerLM(lconf, device=dev).init()
    batch = _lm_batch(lconf).to(dev)
    losses = [float(lm.fit_batch(batch)) for _ in range(DP_LM2_STEPS)]
    return {"step": step, "params": net.params(),
            "perturbed": other.params(), "lm_losses": losses,
            **_dp_lbfgs_vae_world1(dev)}


def dp_rank_main(rank, port, out, device):
    """One rank of phase dp's world 2 (``chip_smoke.py --dp-rank``): gloo,
    this rank's device (``cuda:(rank % device count)`` on the card, so
    both ranks share one card). The char-RNN through ParallelWrapper and
    the 2-layer LM through ``shard``, at each level of DP_GLOO_LEVELS;
    the launches, state bytes and peak memory of this rank; rank 0 writes
    the parameters."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models._layered import tensor_leaves
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    dev = multihost.initialize(f"127.0.0.1:{port}", 2, rank,
                               device=None if device == "cuda" else device,
                               backend="gloo")
    res = {"rank": rank, "device": str(dev), "charrnn": {}, "lm": {}}
    conf = _charrnn_conf()
    data = _charrnn_data(DP_CHARRNN_BATCHES)
    for lv in DP_GLOO_LEVELS:
        net = MultiLayerNetwork(conf, device=dev).init()
        ParallelWrapper(net, dp_shard=lv, device=dev).fit(_one_window(data))
        step = net.params()
        if rank == 0:
            np.save(f"{out}/charrnn_step_level{lv}.npy", step)
        net = MultiLayerNetwork(conf, device=dev).init()
        pw = ParallelWrapper(net, dp_shard=lv, device=dev)
        _reset_peak(dev)
        reset_launches()
        t0 = time.perf_counter()
        pw.fit(ListDataSetIterator(data))
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_lstm_launches()
        params = net.params()                 # whole: every rank gathers
        res["charrnn"][str(lv)] = {
            "ms_per_batch": wall / DP_CHARRNN_BATCHES * 1e3,
            "rows_per_rank": CHARRNN["batch"] // 2,
            "kernel_launches": dict(zip(("lstm_cell_fwd", "lstm_cell_bwd"),
                                        launches)),
            "param_bytes": _nbytes(tensor_leaves(net.params_list)),
            "updater_bytes": _nbytes(tensor_leaves(net.updater_states)),
            "peak_memory_bytes": _peak_bytes(dev)}
        if rank == 0:
            np.save(f"{out}/charrnn_level{lv}.npy", params)
        del net, pw
    lconf = TransformerConfig(**DP_LM2)
    batch = _lm_batch(lconf)
    for lv in DP_GLOO_LEVELS:
        lm = TransformerLM(lconf, device=dev).init().shard(level=lv,
                                                           device=dev)
        _reset_peak(dev)
        reset_launches()
        t0 = time.perf_counter()
        losses = [float(lm.fit_batch(batch)) for _ in range(DP_LM2_STEPS)]
        wall = time.perf_counter() - t0
        res["lm"][str(lv)] = {
            "losses": losses, "step_ms": wall / DP_LM2_STEPS * 1e3,
            "kernel_launches": dict(zip(
                ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"),
                read_launches())),
            "param_bytes": _nbytes(lm._plan_leaves("params")),
            "optimizer_bytes": _nbytes(lm._plan_leaves("opt_state")),
            "peak_memory_bytes": _peak_bytes(dev)}
        del lm
    res.update(_dp_rank_lbfgs_vae(rank, dev, out))
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    multihost.shutdown()
    return 0


def _dp_rank_lbfgs_vae(rank, dev, out):
    """This rank's LeNet under lbfgs through ParallelWrapper (level
    DP_SOLVER["level"]) and the VAE pretrained under an injected plan
    (level DP_VAE["level"]) on its rows; rank 0 writes the parameters."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding_core import (
        ShardingCore, build_mesh)
    res = {}
    net = MultiLayerNetwork(_dp_lbfgs_conf(), device=dev).init()
    data = _dp_lbfgs_data()
    _sync(dev)
    t0 = time.perf_counter()
    ParallelWrapper(net, dp_shard=DP_SOLVER["level"], device=dev).fit(
        ListDataSetIterator(data))
    _sync(dev)
    res["lbfgs"] = {"ms_per_batch": (time.perf_counter() - t0)
                    / len(data) * 1e3, "score": float(net.score_)}
    params = net.params()                     # whole: every rank gathers
    if rank == 0:
        np.save(f"{out}/lbfgs.npy", params)
    core = ShardingCore(build_mesh(), level=DP_VAE["level"])
    vae = MultiLayerNetwork(_dp_vae_conf(), device=dev).init()
    vae._enter_plan(core)
    rows = core.data_sharding()
    batches = [DataSet(rows.take(x), None) for x in _dp_vae_data()]
    _sync(dev)
    t0 = time.perf_counter()
    vae.pretrain(batches, epochs=DP_VAE["epochs"])
    _sync(dev)
    res["vae"] = {"ms_per_batch": (time.perf_counter() - t0)
                  / (len(batches) * DP_VAE["epochs"]) * 1e3,
                  "score": float(vae.score_),
                  "rows_per_rank": DP_VAE["batch"] // 2,
                  "plan_kept": vae._shard_plan is core}
    params = vae.params()
    if rank == 0:
        np.save(f"{out}/vae.npy", params)
    return res


def dp_world2(ref):
    """Phase dp's world 2: two rank processes, both on the card, over gloo
    (DP_GLOO_LEVELS). Returns (record, failures): rank 0's char-RNN
    parameters against world 1's after one update (DP_W2_STEP_RTOL of
    their max abs) and after DP_CHARRNN_BATCHES batches (relative L2
    within DP_W2_CHAOS times the perturbed world-1 run's), each rank's
    LSTM launches for its 16 rows, its state bytes against level 0's (the
    updater state halves from level 1, the parameters at 3); the ranks'
    LM losses equal and within DP_W2_LOSS_RTOL of world 1's, 2 launches
    of each flash kernel a step a rank."""
    import tempfile
    import numpy as np
    port = _free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-rank",
             str(r), str(port), out, DEVICE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        deadline = time.monotonic() + DP_WORLD2_TIMEOUT_S
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"dp rank {r} failed:\n{log[-4000:]}"
        ranks = [json.load(open(f"{out}/rank{r}.json")) for r in range(2)]
        params = {lv: (np.load(f"{out}/charrnn_step_level{lv}.npy"),
                       np.load(f"{out}/charrnn_level{lv}.npy"))
                  for lv in DP_GLOO_LEVELS}
        extra = {k: np.load(f"{out}/{k}.npy") for k in ("lbfgs", "vae")}
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    n_layers = 2
    want_launch = {"lstm_cell_fwd": n_layers * windows * DP_CHARRNN_BATCHES,
                   "lstm_cell_bwd": n_layers * CHARRNN["seq_len"]
                   * DP_CHARRNN_BATCHES}
    yard = rel_l2(ref["perturbed"], ref["params"])
    step_scale = float(np.abs(ref["step"]).max())
    charrnn, lm = {}, {}
    for lv in DP_GLOO_LEVELS:
        k = str(lv)
        rows = [rk["charrnn"][k] for rk in ranks]
        for r, row in enumerate(rows):
            check(row["kernel_launches"] == want_launch,
                  f"char-RNN level {lv} rank {r} launches {row}")
        step, full = params[lv]
        step_err = float(np.abs(step - ref["step"]).max())
        dist = rel_l2(full, ref["params"])
        check(step_err <= DP_W2_STEP_RTOL * step_scale,
              f"char-RNN level {lv} one update {step_err}")
        check(dist <= DP_W2_CHAOS * yard,
              f"char-RNN level {lv} 4 batches {dist} vs yardstick {yard}")
        base = ranks[0]["charrnn"]["0"]
        charrnn[k] = {"rank0": rows[0], "rank1": rows[1],
                      "one_update_max_abs_diff": step_err,
                      "rel_l2_vs_world1": dist,
                      "max_abs_diff_vs_world1":
                          float(np.abs(full - ref["params"]).max()),
                      "updater_bytes_vs_level0":
                          rows[0]["updater_bytes"] / base["updater_bytes"],
                      "param_bytes_vs_level0":
                          rows[0]["param_bytes"] / base["param_bytes"]}
        if lv >= 1:
            check(charrnn[k]["updater_bytes_vs_level0"] <= 0.51,
                  f"char-RNN level {lv} updater bytes")
        if lv >= 3:
            check(charrnn[k]["param_bytes_vs_level0"] <= 0.51,
                  f"char-RNN level {lv} parameter bytes")
        lrows = [rk["lm"][k] for rk in ranks]
        check(lrows[0]["losses"] == lrows[1]["losses"],
              f"LM level {lv}: the ranks' losses differ")
        rel = max(abs(a - b) / abs(b) for a, b in zip(lrows[0]["losses"],
                                                      ref["lm_losses"]))
        check(rel <= DP_W2_LOSS_RTOL, f"LM level {lv} loss {rel}")
        per = DP_LM2["n_layers"] * DP_LM2_STEPS
        for r, row in enumerate(lrows):
            check(all(v == per for v in row["kernel_launches"].values()),
                  f"LM level {lv} rank {r} launches {row}")
        lbase = ranks[0]["lm"]["0"]
        lm[k] = {"rank0": lrows[0], "rank1": lrows[1],
                 "loss_max_rel_vs_world1": rel,
                 "optimizer_bytes_vs_level0":
                     lrows[0]["optimizer_bytes"] / lbase["optimizer_bytes"],
                 "param_bytes_vs_level0":
                     lrows[0]["param_bytes"] / lbase["param_bytes"]}
        if lv >= 1:
            check(lm[k]["optimizer_bytes_vs_level0"] <= 0.51,
                  f"LM level {lv} optimizer bytes")
        if lv >= 3:
            check(lm[k]["param_bytes_vs_level0"] <= 0.51,
                  f"LM level {lv} parameter bytes")
    under_plan = {}
    for k in ("lbfgs", "vae"):
        dist = rel_l2(extra[k], ref[k]["params"])
        yard_k = rel_l2(ref[k]["perturbed"], ref[k]["params"])
        check(dist <= DP_W2_CHAOS * yard_k,
              f"{k} at world 2 {dist} vs yardstick {yard_k}")
        check(ranks[0][k]["score"] == ranks[1][k]["score"],
              f"{k}: the ranks' scores differ")
        under_plan[k] = {"rank0": ranks[0][k], "rank1": ranks[1][k],
                         "world1_score": ref[k]["score"],
                         "rel_l2_vs_world1": dist,
                         "yardstick_rel_l2": yard_k,
                         "max_abs_diff_vs_world1": float(np.abs(
                             extra[k] - ref[k]["params"]).max())}
    check(ranks[0]["vae"]["plan_kept"], "the VAE left its plan")
    rec = {"ranks": 2, "backend": "gloo",
           "devices": [rk["device"] for rk in ranks],
           "lbfgs_lenet": dict(under_plan["lbfgs"], config=DP_SOLVER),
           "vae_pretrain": dict(under_plan["vae"], config=DP_VAE),
           "levels": list(DP_GLOO_LEVELS),
           "levels_cpu_tests_only": [lv for lv in DP_LEVELS
                                     if lv not in DP_GLOO_LEVELS],
           "charrnn": {"batches": DP_CHARRNN_BATCHES,
                       "global_batch": CHARRNN["batch"],
                       "one_update_rtol": DP_W2_STEP_RTOL,
                       "yardstick_rel_l2": yard,
                       "chaos_factor": DP_W2_CHAOS,
                       "world1_param_max_abs": float(
                           np.abs(ref["params"]).max()),
                       "levels": charrnn},
           "lm": {"config": DP_LM2, "steps": DP_LM2_STEPS,
                  "world1_losses": ref["lm_losses"],
                  "loss_rtol_vs_world1": DP_W2_LOSS_RTOL, "levels": lm}}
    return rec, failures


def phase_dp(card):
    """(a) in this process, a world of one rank over NCCL; (b) two rank
    processes over gloo sharing the card."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    dev = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                               device=_dp_device_arg())
    try:
        backend = dist.get_backend()
        lm = dp_world1_lm(dev)
        rnn = dp_world1_charrnn(dev)
    finally:
        multihost.shutdown()
    ref = dp_world1_reference(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    world2, failures = dp_world2(ref)
    world2["seconds"] = time.perf_counter() - t2
    result = {"phase": "dp",
              "world1": {"backend": backend, "lm": lm, "charrnn": rnn},
              "world2": world2, "failures": failures,
              "seconds": time.perf_counter() - t_phase, "card": card}
    emit(result)
    assert not failures, failures
    return result


# ---------------------------------------------------------------------------
# phase scaleout: the training master (threads and processes), the
# parameter server, the collective coordinator and distributed Word2Vec
# ---------------------------------------------------------------------------
def _bits_or_values(a, b):
    """'bitwise', 'equal' (the same values, a zero's sign aside) or None."""
    import numpy as np
    if a.dtype == b.dtype and np.array_equal(a.view(np.uint32),
                                             b.view(np.uint32)):
        return "bitwise"
    return "equal" if np.array_equal(a, b) else None


def _max_rel(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def scaleout_parity(conf, data):
    """(a) One thread worker averaging every batch against plain
    ``fit_batch`` over the same batches: parameters bit for bit, the
    updater vector within SCALEOUT_UPDATER_TOL."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.parallel.training_master import (
        DistributedMultiLayerNetwork, ParameterAveragingTrainingMaster,
        _updater_vec)
    n = SCALEOUT["parity_batches"]
    local = MultiLayerNetwork(conf, device=DEVICE).init()
    for ds in data[:n]:
        local.fit_batch(ds.features, ds.labels)
    tm = ParameterAveragingTrainingMaster(
        n_workers=1, batch_size_per_worker=SCALEOUT["batch"],
        averaging_frequency=1)
    dist = DistributedMultiLayerNetwork(
        MultiLayerNetwork(conf, device=DEVICE).init(), tm)
    dist.fit(data[:n])
    got, want = dist.network.params(), local.params()
    upd = float(np.abs(_updater_vec(dist.network)
                       - _updater_vec(local)).max())
    out = {"batches": n, "coordinator": tm.coordinator_kind,
           "params_bitwise": _bits_or_values(got, want) == "bitwise",
           "params_max_abs_diff": float(np.abs(got - want).max()),
           "updater_max_abs_diff": upd,
           "updater_tolerance": SCALEOUT_UPDATER_TOL,
           # the master counts batches (the reference's), fit_batch
           # tBPTT windows; rmsprop at a fixed rate reads neither
           "iteration": dist.network.iteration,
           "fit_batch_iteration": local.iteration}
    assert out["params_bitwise"] and upd <= SCALEOUT_UPDATER_TOL, out
    assert tm.coordinator_kind == "native", out
    return out


def tm_yardstick(conf, batches, n_workers, freq):
    """The training master's arithmetic written out in this process: per
    split, each replica fits its round-robin batches from the broadcast
    state, and the float32 sums of parameters and updater vectors are
    divided by the workers that trained."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.parallel.training_master import (
        _set_updater_vec, _updater_vec)
    master = MultiLayerNetwork(conf, device=DEVICE).init()
    p, u, it = master.params(), _updater_vec(master), 0
    reps = [MultiLayerNetwork(conf, device=DEVICE).init()
            for _ in range(n_workers)]
    per_split = n_workers * freq
    for s in range(0, len(batches), per_split):
        split = batches[s:s + per_split]
        ps, us = [], []
        for w, rep in enumerate(reps):
            mine = split[w::n_workers]
            if not mine:
                continue
            rep.set_params(p)
            _set_updater_vec(rep, u)
            rep.iteration = it
            for ds in mine:
                rep.fit_batch(ds.features, ds.labels)
            ps.append(rep.params())
            us.append(_updater_vec(rep))
        p = np.sum(np.stack(ps), axis=0, dtype=np.float32) / len(ps)
        u = np.sum(np.stack(us), axis=0, dtype=np.float32) / len(us)
        it += freq
    return p, u


def _tm_run(conf, batches, **kw):
    """One fit through ParameterAveragingTrainingMaster on a fresh net on
    the card: (the net, the master, wall seconds)."""
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.parallel.training_master import (
        DistributedMultiLayerNetwork, ParameterAveragingTrainingMaster)
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    tm = ParameterAveragingTrainingMaster(
        n_workers=SCALEOUT["workers"], batch_size_per_worker=SCALEOUT["batch"],
        averaging_frequency=SCALEOUT["averaging_frequency"],
        collect_training_stats=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    DistributedMultiLayerNetwork(net, tm).fit(batches)
    torch.cuda.synchronize()
    return net, tm, time.perf_counter() - t0


def _phase_seconds(tm):
    out = {}
    for phase, sec in tm.stats:
        out.setdefault(phase, []).append(sec)
    return out


def scaleout_threads(conf, data):
    """(b) Two thread workers averaging every 5 batches over 20 batches
    (2 splits): the first run against the yardstick, the second timed,
    with the LSTM launches by the wrappers counted over it (the main
    path), and the same bits as the first; a third under
    ``torch.profiler`` for the card's busy share."""
    from deeplearning4j_tpu_torch.parallel.training_master import _updater_vec
    c = SCALEOUT
    batches = data[:c["batches"]]
    net1, tm1, wall1 = _tm_run(conf, batches)
    want_p, want_u = tm_yardstick(conf, batches, c["workers"],
                                  c["averaging_frequency"])
    got_p, got_u = net1.params(), _updater_vec(net1)
    reset_launches()                  # the main path starts here
    net2, tm2, wall = _tm_run(conf, batches)
    fwd, bwd = read_lstm_launches()
    flash = read_launches()           # ... and ends here
    # a third run under the profiler: the card's busy share of the run
    # (both workers' kernels on the one default stream)
    wall_p, names, ops = profiled(lambda: _tm_run(conf, batches))
    share = device_share(names, ops, c["batches"],
                         wall * 1e3 / c["batches"])
    splits = c["batches"] // (c["workers"] * c["averaging_frequency"])
    n_layers = sum(hasattr(l, "initial_carry") for l in conf.layers)
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    want_launches = (n_layers * windows * c["batches"],
                     n_layers * CHARRNN["seq_len"] * c["batches"])
    chars = c["batches"] * c["batch"] * CHARRNN["seq_len"]
    stats = _phase_seconds(tm2)
    out = {"workers": c["workers"],
           "averaging_frequency": c["averaging_frequency"],
           "batches": c["batches"], "splits": splits,
           "coordinator": tm2.coordinator_kind,
           "params_vs_yardstick": _bits_or_values(got_p, want_p),
           "params_max_rel_vs_yardstick": _max_rel(got_p, want_p),
           "updater_vs_yardstick": _bits_or_values(got_u, want_u),
           "updater_max_rel_vs_yardstick": _max_rel(got_u, want_u),
           "yardstick_rtol": SCALEOUT_YARDSTICK_RTOL,
           "second_run_bitwise": _bits_or_values(net2.params(),
                                                 got_p) == "bitwise",
           "wall_s": wall, "first_run_wall_s": wall1,
           "ms_per_split": wall / splits * 1e3,
           "chars_per_s": chars / wall,
           "broadcast_s": stats.get("broadcast"),
           "aggregate_s": stats.get("aggregate"),
           "lstm_launches": {"lstm_cell_fwd": fwd, "lstm_cell_bwd": bwd},
           "lstm_launches_expected": list(want_launches),
           "flash_launches": list(flash),
           "profiled_wall_s": wall_p, "device_share": share,
           "iteration": net2.iteration,
           "score": net2.score_}
    assert out["params_vs_yardstick"] or \
        out["params_max_rel_vs_yardstick"] <= SCALEOUT_YARDSTICK_RTOL, out
    assert out["updater_vs_yardstick"] or \
        out["updater_max_rel_vs_yardstick"] <= SCALEOUT_YARDSTICK_RTOL, out
    assert out["second_run_bitwise"], out
    # a CPU rehearsal (DEVICE "cpu") launches no kernel
    assert (fwd, bwd) == (want_launches if DEVICE == "cuda" else (0, 0)) \
        and flash == (0, 0, 0), out
    assert net2.iteration == c["batches"] // c["workers"], out
    assert math.isfinite(out["score"]) and tm2.coordinator_kind == "native"
    out["params"] = got_p
    return out


def scaleout_processes(conf, data, thread_params, tmp):
    """(c) The same splits through two worker processes on the card in
    Export mode: parameters within SCALEOUT_PROCESS_TOL of (b)'s; the
    workers' own launch counts; seconds with and without the spawn."""
    import numpy as np
    c = SCALEOUT
    export = Path(tmp) / "export"
    net, tm, wall = _tm_run(conf, data[:c["batches"]], mode="process",
                            export_dir=str(export))
    counts = [json.loads((export / f"worker_{w}" /
                          "kernel_launches.json").read_text())
              for w in range(c["workers"])]
    stats = _phase_seconds(tm)
    agg = stats["aggregate"]
    # the first split's aggregate waits for the workers to start (import,
    # CUDA context, replica): its excess over the second's is the spawn
    spawn = max(agg[0] - agg[1], 0.0)
    diff = float(np.abs(net.params() - thread_params).max())
    out = {"workers": c["workers"], "coordinator": tm.coordinator_kind,
           "params_max_abs_vs_threads": diff,
           "tolerance": SCALEOUT_PROCESS_TOL,
           "params_vs_threads": _bits_or_values(net.params(), thread_params),
           "wall_s": wall, "export_s": stats["export"][0],
           "aggregate_s": agg, "broadcast_s": stats["broadcast"],
           "spawn_s_estimate": spawn,
           "wall_s_without_spawn_estimate": wall - spawn,
           "worker_kernel_launches": counts}
    n_layers = sum(hasattr(l, "initial_carry") for l in conf.layers)
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    per_worker = c["batches"] // c["workers"] if DEVICE == "cuda" else 0
    for w in counts:
        assert w["lstm_cell_fwd"] == n_layers * windows * per_worker, out
        assert w["lstm_cell_bwd"] == n_layers * CHARRNN["seq_len"] \
            * per_worker, out
    assert diff <= SCALEOUT_PROCESS_TOL and tm.coordinator_kind == "native", \
        out
    return out


def ps_yardstick(conf, batches):
    """One trainer through the parameter server's arithmetic, written out
    in this process: after each ``fit_batch`` the delta goes onto the
    server's float32 copy, and the trainer pulls it back."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    server = net.params()
    for ds in batches:
        before = net.params()
        net.fit_batch(ds.features, ds.labels)
        server = server + (net.params() - before)
        net.set_params(server)
    return np.asarray(server)


def scaleout_param_server(conf, data):
    """(d) One trainer pulling every step: after one batch within
    SCALEOUT_PS_TOL of sequential ``fit_batch`` (the reference's bar);
    over SCALEOUT["ps_equal_batches"] batches bit for bit the sequential
    fit through the server's float32 arithmetic (``ps_yardstick``), and
    its distance from plain sequential ``fit_batch`` reported (each pull
    rounds the parameters, and training grows that rounding, as phase
    ``dp`` measured). Two trainers over 16 batches lower the held-out
    loss."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.parallel.param_server_wrapper import (
        ParameterServerParallelWrapper)
    c = SCALEOUT
    n = c["ps_equal_batches"]

    def sequential(k):
        net = MultiLayerNetwork(conf, device=DEVICE).init()
        for ds in data[:k]:
            net.fit_batch(ds.features, ds.labels)
        return net.params()

    def one_trainer(k):
        net = MultiLayerNetwork(conf, device=DEVICE).init()
        w = ParameterServerParallelWrapper(net, workers=1, pull_frequency=1)
        w.fit(iter(data[:k]))
        return net.params(), w.coordinator_kind
    first, kind1 = one_trainer(1)
    diff1 = float(np.abs(first - sequential(1)).max())
    got, _ = one_trainer(n)
    want = ps_yardstick(conf, data[:n])
    plain = float(np.abs(got - sequential(n)).max())
    held = data[-1]
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    before = float(net.score(held))
    w2 = ParameterServerParallelWrapper(net, workers=c["ps_workers"],
                                        pull_frequency=1)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w2.fit(iter(data[:c["ps_batches"]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = read_lstm_launches()
    after = float(net.score(held))
    chars = c["ps_batches"] * c["batch"] * CHARRNN["seq_len"]
    out = {"one_trainer": {
               "after_1_batch_max_abs_vs_sequential": diff1,
               "tolerance": SCALEOUT_PS_TOL, "batches": n,
               "vs_server_arithmetic": _bits_or_values(got, want),
               "max_abs_vs_server_arithmetic":
                   float(np.abs(got - want).max()),
               "max_abs_vs_plain_sequential": plain,
               "coordinator": kind1},
           "two_trainers": {"batches": c["ps_batches"],
                            "held_out_loss_before": before,
                            "held_out_loss_after": after,
                            "wall_s": wall, "chars_per_s": chars / wall,
                            "lstm_launches": [fwd, bwd],
                            "coordinator": w2.coordinator_kind}}
    assert diff1 <= SCALEOUT_PS_TOL, out
    assert out["one_trainer"]["vs_server_arithmetic"], out
    assert after < before and math.isfinite(after), out
    assert kind1 == w2.coordinator_kind == "native", out
    return out


def _topic_corpus(n, seed):
    """tests/test_nlp_distributed.py's corpus: three topics of five words,
    8 words a sentence."""
    import numpy as np
    rng = np.random.RandomState(seed)
    topics = [t.split() for t in ("cat dog bird fish horse",
                                  "bread milk cheese apple rice",
                                  "code chip data model tensor")]
    return [" ".join(rng.choice(topics[i % 3], 8)) for i in range(n)]


def scaleout_word2vec():
    """(e) Distributed Word2Vec at phase word2vec's configuration: one
    worker against ``Word2Vec.fit`` bit for bit; two worker threads
    (each capturing its own graphs) against the same two replicas fitted
    one after the other and averaged, and their words/s; then the
    reference test's topic check on the card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                       _tokenize_to_sequences)
    c = W2V
    kw = dict(layer_size=c["layer_size"], window=c["window"],
              negative=c["negative"], use_hierarchic_softmax=False,
              min_word_frequency=c["min_word_frequency"],
              sampling=c["sampling"], seed=c["seed"],
              batch_size=c["batch_size"], device=DEVICE)
    sents = w2v_corpus(c["vocab"], c["total"], c["sent_len"],
                       c["corpus_seed"])
    single = Word2Vec(epochs=1, **kw)
    t0 = time.perf_counter()
    single.fit_corpus(sents)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    one = DistributedWord2Vec(n_workers=1, epochs=1, **kw)
    one.fit_corpus(sents)
    tables = ("syn0", "syn1neg")
    one_bits = {t: bool(torch.equal(getattr(one.lookup_table, t),
                                    getattr(single.lookup_table, t)))
                for t in tables}
    two = DistributedWord2Vec(n_workers=2, epochs=1, **kw)
    t0 = time.perf_counter()
    two.fit_corpus(sents)
    torch.cuda.synchronize()
    two_s = time.perf_counter() - t0
    # the yardstick: the two workers' replicas one after the other, in
    # this thread, averaged as the coordinator averages
    seqs = list(_tokenize_to_sequences(sents, two.tokenizer_factory))
    total = max(two.vocab.total_word_count, 1.0)
    reps = []
    for w in range(2):
        sv = two._make_worker(w)
        sv._fit_epoch(seqs[w::2], np.random.RandomState(sv.seed), 0.0,
                      total / 2)
        reps.append({t: getattr(sv.lookup_table, t).float().cpu().numpy()
                     for t in tables})
    two_vs = {}
    for t in tables:
        want = (reps[0][t] + reps[1][t]) / 2
        got = getattr(two.lookup_table, t).float().cpu().numpy()
        two_vs[t] = _bits_or_values(got, want) or _max_rel(got, want)
    finite = all(bool(torch.isfinite(getattr(two.lookup_table, t)).all())
                 for t in tables)
    tc = SCALEOUT_TOPICS
    topic = DistributedWord2Vec(
        n_workers=2, epochs=tc["epochs"], layer_size=tc["layer_size"],
        window=tc["window"], negative=tc["negative"],
        use_hierarchic_softmax=False,
        min_word_frequency=tc["min_word_frequency"], seed=tc["seed_fit"],
        batch_size=tc["batch_size"], device=DEVICE)
    topic.fit_corpus(_topic_corpus(tc["sentences"], tc["seed"]))

    def sim(a, b):
        va, vb = topic.word_vector(a), topic.word_vector(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
    same = float(np.mean([sim("cat", "dog"), sim("bread", "milk"),
                          sim("code", "chip")]))
    cross = float(np.mean([sim("cat", "bread"), sim("milk", "chip"),
                           sim("code", "fish")]))
    nearest = topic.words_nearest("cat", 8)
    out = {"config": "W2V (phase word2vec's, uncut)",
           "coordinator": [one.coordinator_kind, two.coordinator_kind],
           "single_fit_s": single_s,
           "single_words_per_s": c["total"] / single_s,
           "one_worker_bitwise": one_bits,
           "two_workers_s": two_s,
           "two_workers_words_per_s": c["total"] / two_s,
           "two_workers_vs_yardstick": two_vs, "two_workers_finite": finite,
           "topics": {"same_topic_sim": same, "cross_topic_sim": cross,
                      "nearest_to_cat": nearest,
                      "coordinator": topic.coordinator_kind}}
    assert all(one_bits.values()), out
    assert all(v in ("bitwise", "equal") for v in two_vs.values()), out
    assert finite and same > cross and "dog" in nearest, out
    assert {one.coordinator_kind, two.coordinator_kind,
            topic.coordinator_kind} == {"native"}, out
    return out


def phase_scaleout(card):
    """The scaleout stack on phase charrnn's net at full width: (a) the
    parity gate, (b) thread workers (the main path: its launches feed the
    kernels line), (c) process workers, (d) the parameter server, (e)
    distributed Word2Vec. The coordinator must be the native one."""
    import tempfile
    import torch
    seconds = {}
    t_phase = time.perf_counter()
    conf = _charrnn_conf()
    data = _charrnn_data(SCALEOUT["batches"] + 1)
    result = {"phase": "scaleout", "config": CHARRNN, "scaleout": SCALEOUT,
              "card": card}
    for key, fn in (("parity", lambda: scaleout_parity(conf, data)),
                    ("threads", lambda: scaleout_threads(conf, data))):
        t0 = time.perf_counter()
        result[key] = fn()
        seconds[key] = time.perf_counter() - t0
    thread_params = result["threads"].pop("params")
    emit({"phase": "scaleout", "part": "parity, threads",
          "parity": result["parity"], "threads": result["threads"]})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="scaleout_") as tmp:
        t0 = time.perf_counter()
        result["processes"] = scaleout_processes(conf, data, thread_params,
                                                 tmp)
        seconds["processes"] = time.perf_counter() - t0
    emit({"phase": "scaleout", "part": "processes",
          "processes": result["processes"]})
    for key, fn in (("param_server",
                     lambda: scaleout_param_server(conf, data)),
                    ("word2vec", scaleout_word2vec)):
        t0 = time.perf_counter()
        result[key] = fn()
        seconds[key] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    result["seconds"] = seconds
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase elastic: elastic data parallelism (parallel/elastic.py) on phase
# charrnn's net and batches, uncut; trainers are processes that share the
# card, members threads of this process, the coordinator the Python one
# ---------------------------------------------------------------------------
def _ready_wait(out, names, timeout=ELASTIC_TIMEOUT_S):
    """Wait until each ``<out>/<name>`` file exists."""
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(os.path.join(out, n)) for n in names):
        if time.monotonic() > deadline:
            raise AssertionError(f"no {names} in {timeout} s")
        time.sleep(0.01)


def _touch(out, name):
    with open(os.path.join(out, name), "w") as f:
        f.write("1")


def _wave_ms_per_batch(entry):
    """A wave's host ms a dispatch (one batch: the per-batch loop), from
    the differences of its heartbeat times; None under two beats."""
    beats = entry.get("beats") or []
    if len(beats) < 2:
        return None
    return (beats[-1] - beats[0]) / (len(beats) - 1) * 1e3


def _copy_checkpoint(src, dst):
    """A directory holding only the checkpoint ``src``: a resume from it
    takes exactly that state."""
    import shutil
    os.makedirs(dst, exist_ok=True)
    shutil.copy(src, dst)
    return dst


def elastic_rank_main(case, wid, port, out, device):
    """One trainer process of phase elastic (``chip_smoke.py
    --elastic-rank``): warm the process, wait for the phase's go, run the
    ElasticTrainer over the char-RNN's batches (the per-batch loop, ZeRO
    level ELASTIC["level"]), count its LSTM launches, and hold its end
    state against a ParallelWrapper run resumed from the checkpoint the
    last wave resumed from, in that wave's group. ``case``: "kill"
    (trainer 1 dies at heartbeat ELASTIC_KILL_AT), "scale" (trainer 1
    joins once a checkpoint past the start has landed), "slow" (one
    trainer beside a slow member)."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DL4J_TORCH_FUSE_STEPS"] = "1"
    os.environ["DL4J_TORCH_CKPT_KEEP"] = "100"
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
    from deeplearning4j_tpu_torch.testing import faults
    from deeplearning4j_tpu_torch.utils import training_checkpoint as tck
    dev = torch.device("cuda", 0) if device == "cuda" \
        else torch.device(device)
    conf = _charrnn_conf()
    data = _charrnn_data(ELASTIC["batches"])
    # the CUDA context, cuBLAS and the LSTM kernels' libraries loaded
    # before the first wave's deadlines run
    MultiLayerNetwork(conf, device=dev).init().fit(_one_window(data))
    _sync(dev)
    ck = os.path.join(out, f"ck_{case}")
    _touch(out, f"ready_{case}_{wid}")
    _ready_wait(out, [f"go_{case}"])
    if case == "kill" and wid == 1:
        faults.install(f"kill-peer[1]@{ELASTIC_KILL_AT}")
    joiner = case == "scale" and wid == 1
    if joiner:
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while not [i for i, _ in tck.checkpoint_files(ck) if i > 0]:
            assert time.monotonic() < deadline, "no checkpoint to join"
            time.sleep(0.005)
    net = MultiLayerNetwork(conf, device=dev).init()
    slow = case == "slow"
    tr = ElasticTrainer(
        net, "127.0.0.1", port, worker_id=None if joiner else wid,
        dp_shard=ELASTIC["level"], device=dev,
        timeout=ELASTIC_SLOW["timeout"] if slow else ELASTIC["timeout"],
        reform_timeout=ELASTIC["reform"])
    reset_launches()                          # the main path starts here
    _sync(dev)
    t0 = time.perf_counter()
    tr.fit(lambda: ListDataSetIterator(data), epochs=1, checkpoint_dir=ck,
           checkpoint_every=ELASTIC["every"],
           max_reforms=2 if joiner else None)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_lstm_launches()
    rec = {"case": case, "worker_id": wid, "device": str(dev),
           "wall_s": wall, "group_rank": tr.group_rank,
           "log": tr.reform_log,
           "ms_per_batch_by_wave": [_wave_ms_per_batch(e)
                                    for e in tr.reform_log],
           "kernel_launches": dict(zip(("lstm_cell_fwd", "lstm_cell_bwd"),
                                       launches)),
           "batches_trained": len([b for e in tr.reform_log
                                   for b in e["beats"]])}
    got = net.params()
    if case in ("kill", "scale") and tr.group_rank is not None:
        rec.update(_elastic_oracle(case, tr, conf, data, got, out, dev))
    tr.close()
    with open(os.path.join(out, f"{case}_{wid}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _elastic_oracle(case, tr, conf, data, got, out, dev):
    """The end state against a ParallelWrapper resumed, in the last wave's
    group, from a copy of the checkpoint that wave resumed from; on a
    scale-up also the yardstick of a run resumed from it with parameters
    perturbed by DP_W2_PERTURB."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.utils import training_checkpoint as tck
    src = tr.reform_log[-1]["checkpoint"]
    width = tr.reform_log[-1]["width"]
    d = os.path.join(out, f"oracle_{case}")
    dp = os.path.join(out, f"oracle_{case}_perturbed")
    if tr.group_rank == 0:
        _copy_checkpoint(src, d)
        if case == "scale":
            # the same state, every parameter moved by DP_W2_PERTURB
            moved = MultiLayerNetwork(conf, device=dev).init()
            cursor = tck.apply_training_checkpoint(moved, src)
            p = moved.params()
            rng = np.random.default_rng(SEED + 19)
            moved.set_params((p * (1 + DP_W2_PERTURB * rng.standard_normal(
                p.size))).astype(np.float32))
            tck.save_training_checkpoint(moved, dp, cursor=cursor)
    if width > 1:
        torch.distributed.barrier()

    def resumed(path):
        other = MultiLayerNetwork(conf, device=dev).init()
        ParallelWrapper(other, dp_shard=ELASTIC["level"], device=dev).fit(
            ListDataSetIterator(data), resume_from=path)
        return other.params()
    want = resumed(d)
    rec = {"oracle_width": width,
           "oracle_checkpoint": os.path.basename(src),
           "bitwise_vs_oracle": bool(np.array_equal(got.view(np.uint32),
                                                    want.view(np.uint32))),
           "max_abs_diff_vs_oracle": float(np.abs(got - want).max()),
           "rel_l2_vs_oracle": float(np.linalg.norm(got - want)
                                     / np.linalg.norm(want))}
    if case == "scale":
        pert = resumed(dp)
        rec["yardstick_rel_l2"] = float(np.linalg.norm(pert - want)
                                        / np.linalg.norm(want))
    return rec


def _elastic_case(case, members, trainers, timeout):
    """Run one case: an elastic Python coordinator in this process, the
    ``members`` (initial worker ids) as ElasticMember threads here, the
    ``trainers`` (worker ids) as processes; returns (the trainers'
    records by id, their exit codes, the members, the coordinator's
    elastic metrics)."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.parallel.coordinator import PyCoordinator
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticMember
    _release_card()
    leaves0 = obs.metrics.value("elastic.events_total.leave")
    joins0 = obs.metrics.value("elastic.events_total.join")
    coord = PyCoordinator(len(members) + len(trainers), elastic=True,
                          min_workers=1, timeout=timeout,
                          reform_timeout=ELASTIC["reform"])
    out = tempfile.mkdtemp(prefix="elastic_")
    procs, mem, logs = [], [], []
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--elastic-rank",
             case, str(w), str(coord.port), out, DEVICE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for w in trainers]
        _ready_wait(out, [f"ready_{case}_{w}" for w in trainers])
        mem = [ElasticMember("127.0.0.1", coord.port, m, timeout=timeout,
                             reform_timeout=ELASTIC["reform"]).start()
               for m in members]
        _touch(out, f"go_{case}")
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
        for m in mem:
            m.join(timeout=30)
    finally:
        for m in mem:
            m.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        coord.stop()
    recs = {}
    for w, p, log in zip(trainers, procs, logs):
        path = os.path.join(out, f"{case}_{w}.json")
        if os.path.exists(path):
            with open(path) as f:
                recs[w] = json.load(f)
        recs.setdefault(w, {})["log_tail"] = log[-1500:]
    shutil.rmtree(out, ignore_errors=True)
    metrics = {"leave_events": obs.metrics.value("elastic.events_total.leave")
               - leaves0,
               "join_events": obs.metrics.value("elastic.events_total.join")
               - joins0,
               "world_size": obs.metrics.value("elastic.world_size")}
    return recs, [p.returncode for p in procs], mem, metrics


def _wave_rows(log):
    """The printed figures of each wave: epoch, world, width, the wave's
    join seconds, the group's start seconds, its backend and ms a
    batch."""
    return [{"epoch": e["epoch"], "world": e["world"], "width": e["width"],
             "trainers": e["trainers"], "wave_s": e["seconds"],
             "group_start_s": e["group_seconds"], "backend": e["backend"],
             "ms_per_batch": _wave_ms_per_batch(e),
             "batches": len(e["beats"]),
             "checkpoint": None if e["checkpoint"] is None
             else os.path.basename(e["checkpoint"])} for e in log]


def phase_elastic(card):
    """(a) kill: two trainers and a member at world 3, width 2; trainer 1
    dies at its heartbeat ELASTIC_KILL_AT; the survivors re-form at world
    2, width 1, and end bitwise a width-1 ParallelWrapper run resumed
    from the same checkpoint. (b) scale-up: one trainer at world 1, a
    second joins after the first checkpoint: width 2, held against a
    width-2 run resumed from the re-form checkpoint within DP_W2_CHAOS
    times a perturbed run's drift. (c) a member that sleeps
    ELASTIC_SLOW["sleep"] s past a ELASTIC_SLOW["timeout"] s round
    deadline is expelled, and the run finishes. (d) each wave's seconds,
    the groups' start seconds, ms a batch before and after each re-form,
    and the trainers' LSTM launches."""
    from deeplearning4j_tpu_torch.parallel.elastic import KILLED_EXIT
    from deeplearning4j_tpu_torch.testing import faults
    t_phase = time.perf_counter()
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    per_batch = {"lstm_cell_fwd": 2 * windows,
                 "lstm_cell_bwd": 2 * CHARRNN["seq_len"]}
    n = ELASTIC["batches"]

    # (a) kill
    t0 = time.perf_counter()
    recs, codes, mem, metrics = _elastic_case(
        "kill", [2], [0, 1], ELASTIC["timeout"])
    kill = {"exit_codes": codes, "metrics": metrics,
            "member": {"error": repr(mem[0].error), "killed": mem[0].killed,
                       "expelled": mem[0].expelled is not None}}
    r0 = recs[0]
    check(codes == [0, KILLED_EXIT], f"kill exit codes {codes}: "
          f"{recs[0].get('log_tail')} {recs[1].get('log_tail')}")
    if codes[0] == 0:
        log = r0["log"]
        check([e["world"] for e in log] == [3, 2], f"kill worlds {log}")
        check([e["width"] for e in log] == [2, 1], f"kill widths {log}")
        check(r0["bitwise_vs_oracle"],
              f"kill not bitwise its oracle: {r0['max_abs_diff_vs_oracle']}")
        check(mem[0].error is None and not mem[0].killed,
              f"kill member {kill['member']}")
        # trainer 0 trained every batch: its rows at width 2, all at 1
        check(r0["kernel_launches"] == {k: v * n
                                        for k, v in per_batch.items()},
              f"kill launches {r0['kernel_launches']}")
        kill.update({"waves": _wave_rows(log),
                     "kernel_launches_trainer0": r0["kernel_launches"],
                     "bitwise_vs_width1_oracle": r0["bitwise_vs_oracle"],
                     "oracle_checkpoint": r0["oracle_checkpoint"],
                     "wall_s": r0["wall_s"]})
    kill["seconds"] = time.perf_counter() - t0

    # (b) scale-up
    t0 = time.perf_counter()
    recs, codes, _, metrics = _elastic_case("scale", [], [0, 1],
                                            ELASTIC["timeout"])
    scale = {"exit_codes": codes, "metrics": metrics}
    check(codes == [0, 0], f"scale exit codes {codes}: "
          f"{recs[0].get('log_tail')} {recs[1].get('log_tail')}")
    if codes == [0, 0]:
        log, r1 = recs[0]["log"], recs[1]
        check([e["width"] for e in log] == [1, 2], f"scale widths {log}")
        check([e["width"] for e in r1["log"]] == [2],
              f"joiner widths {r1['log']}")
        r0 = recs[0]
        dist, yard = r0["rel_l2_vs_oracle"], r0["yardstick_rel_l2"]
        check(r0["bitwise_vs_oracle"] or dist <= DP_W2_CHAOS * yard,
              f"scale {dist} vs yardstick {yard}")
        check(r1["bitwise_vs_oracle"] == r0["bitwise_vs_oracle"],
              "the scale-up's ranks disagree")
        scale.update({"waves": _wave_rows(log),
                      "joiner_waves": _wave_rows(r1["log"]),
                      "kernel_launches_trainer0": r0["kernel_launches"],
                      "kernel_launches_joiner": r1["kernel_launches"],
                      "rel_l2_vs_oracle": dist, "yardstick_rel_l2": yard,
                      "chaos_factor": DP_W2_CHAOS,
                      "bitwise_vs_width2_oracle": r0["bitwise_vs_oracle"],
                      "oracle_checkpoint": r0["oracle_checkpoint"],
                      "wall_s": r0["wall_s"]})
    scale["seconds"] = time.perf_counter() - t0

    # (c) a slow member, expelled
    t0 = time.perf_counter()
    faults.install(f"slow-peer[1]@{ELASTIC_SLOW['at']}:"
                   f"{ELASTIC_SLOW['sleep']}")
    try:
        recs, codes, mem, metrics = _elastic_case(
            "slow", [1], [0], ELASTIC_SLOW["timeout"])
    finally:
        faults.clear()
    slow = {"exit_codes": codes, "metrics": metrics,
            "member": {"error": repr(mem[0].error),
                       "expelled": mem[0].expelled is not None}}
    check(codes == [0], f"slow exit code {codes}: {recs[0].get('log_tail')}")
    check(mem[0].expelled is not None and mem[0].error is None,
          f"slow member {slow['member']}")
    if codes == [0]:
        log = recs[0]["log"]
        check(log[0]["world"] == 2 and log[-1]["world"] == 1,
              f"slow worlds {log}")
        slow.update({"waves": _wave_rows(log), "wall_s": recs[0]["wall_s"],
                     "batches_trained": recs[0]["batches_trained"]})
    slow["seconds"] = time.perf_counter() - t0

    result = {"phase": "elastic",
              "config": dict(ELASTIC, charrnn=CHARRNN,
                             kill_at_heartbeat=ELASTIC_KILL_AT,
                             slow=ELASTIC_SLOW),
              "kill": kill, "scale_up": scale, "slow_peer": slow,
              "kernel_launches_per_batch_whole_rows": per_batch,
              "failures": failures,
              "seconds": time.perf_counter() - t_phase, "card": card}
    emit(result)
    assert not failures, failures
    return result


# ---------------------------------------------------------------------------
# phase shard_ckpt: per-rank shard checkpoints (utils/orbax_io.py) of the
# slice's LM at full width, world 2, ZeRO level 3
# ---------------------------------------------------------------------------
def _gathered_state(lm):
    """The LM's parameters and AdamW state, whole, on its device (a
    collective under a plan)."""
    return [t.detach().clone() for attr in ("params", "opt_state")
            for t in lm._gathered(attr)]


def _bits_equal(a, b):
    import torch
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().view(torch.uint8),
                        y.contiguous().view(torch.uint8))
        for x, y in zip(a, b))


def shard_rank_main(rank, out, device):
    """One rank of phase shard_ckpt (``chip_smoke.py --shard-rank``):
    the slice's LM at level 3 over gloo (both ranks on the card), trained
    SHARD_CKPT["steps"] steps, saved as shards; restored at world 2 level
    1 and, on rank 0 alone, at width 1; each restore's parameters and
    AdamW state held bitwise against the saved ones, gathered."""
    import glob
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.utils import orbax_io
    dev, backend = multihost.reform(
        os.path.join(out, "store"), 2, rank,
        device=None if device == "cuda" else device,
        timeout=WORLD2_GROUP_TIMEOUT_S)
    conf = TransformerConfig(**dict(SLICE, n_layers=SHARD_CKPT["n_layers"]))
    lm = TransformerLM(conf, device=dev).init().shard(level=3, device=dev)
    batch = _lm_batch(conf)
    reset_launches()
    for _ in range(SHARD_CKPT["steps"]):
        lm.fit_batch(batch)
    launches = read_launches()
    saved = _gathered_state(lm)
    ck = os.path.join(out, "shards")
    torch.distributed.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    path = orbax_io.save_checkpoint(lm, ck, step=SHARD_CKPT["steps"])
    write_s = time.perf_counter() - t0
    mine = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(path, f"*.rank{rank}.bin")))
    whole = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(path, "*.whole.bin"))) if rank == 0 else 0
    rec = {"rank": rank, "device": str(dev), "backend": backend,
           "write_s": write_s,
           "shard_bytes_written": mine, "whole_bytes_written": whole,
           "flash_launches": dict(zip(("flash_attn_fwd", "flash_attn_dq",
                                       "flash_attn_dkv"), launches)),
           "param_bytes_at_rest": _nbytes(lm._plan_leaves("params")),
           "optimizer_bytes_at_rest": _nbytes(lm._plan_leaves("opt_state"))}
    del lm
    back = TransformerLM(TransformerConfig(
        **dict(SLICE, n_layers=SHARD_CKPT["n_layers"], seed=SEED + 1)),
        device=dev).init().shard(level=1, device=dev)
    torch.distributed.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    orbax_io.restore_checkpoint(back, ck, step=SHARD_CKPT["steps"])
    _sync(dev)
    rec["restore_world2_level1_s"] = time.perf_counter() - t0
    rec["world2_level1_bitwise"] = _bits_equal(_gathered_state(back), saved)
    rec["world2_level1_iteration"] = back.iteration
    del back
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        alone = TransformerLM(TransformerConfig(
            **dict(SLICE, n_layers=SHARD_CKPT["n_layers"], seed=SEED + 2)),
            device=dev).init()
        _sync(dev)
        t0 = time.perf_counter()
        orbax_io.restore_checkpoint(alone, ck, step=SHARD_CKPT["steps"])
        _sync(dev)
        rec["restore_width1_s"] = time.perf_counter() - t0
        rec["width1_bitwise"] = _bits_equal(_gathered_state(alone), saved)
        rec["width1_iteration"] = alone.iteration
        del alone
    torch.distributed.barrier()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    multihost.shutdown()
    return 0


def _release_card():
    """Give the card's cached blocks of this process back before rank
    processes start (they share the card); returns what this process
    still reserves, in bytes (None on the CPU)."""
    import torch
    if DEVICE != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _world(n, flag, out, timeout):
    """Run this script's ``flag`` rank mode as ``n`` processes that meet
    over a ``FileStore`` in ``out``; returns their JSON records
    (``<out>/rank<r>.json``). A rank that
    exits with an error ends the others at once (a rank left waiting for
    a dead peer in the rendezvous would wait out torch's default
    timeout), and the error carries every rank's log."""
    logs = [os.path.join(out, f"rank{r}.log") for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), flag, str(r),
                 out, DEVICE], stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs
                   if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * n:
        tails = []
        for r, path in enumerate(logs):
            with open(path, errors="replace") as f:
                tails.append(f"--- {flag} rank {r} (exit {codes[r]}):\n"
                             + f.read()[-4000:])
        raise AssertionError("\n".join(tails))
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(n)]


def phase_shard_ckpt(card):
    import shutil
    import tempfile
    t0 = time.perf_counter()
    reserved = _release_card()
    with tempfile.TemporaryDirectory() as out:
        free = shutil.disk_usage(out).free
        ranks = _world(2, "--shard-rank", out, SHARD_CKPT_TIMEOUT_S)
    r0, r1 = ranks
    failures = [what for ok, what in (
        (r0["world2_level1_bitwise"] and r1["world2_level1_bitwise"],
         "world 2 level 1 restore not bitwise"),
        (r0["width1_bitwise"], "width 1 restore not bitwise"),
        (r0["world2_level1_iteration"] == SHARD_CKPT["steps"] ==
         r0["width1_iteration"], "restored iteration"),
        (all(v == SHARD_CKPT["n_layers"] * SHARD_CKPT["steps"]
             for v in r0["flash_launches"].values()),
         f"flash launches {r0['flash_launches']}")) if not ok]
    result = {"phase": "shard_ckpt",
              "config": dict(SHARD_CKPT, model=dict(
                  SLICE, n_layers=SHARD_CKPT["n_layers"]), level=3,
                  world=2, backend=r0["backend"]),
              "ranks": ranks,
              "bytes_written_per_rank": [r0["shard_bytes_written"]
                                         + r0["whole_bytes_written"],
                                         r1["shard_bytes_written"]],
              "write_s": max(r0["write_s"], r1["write_s"]),
              "restore_world2_level1_s": max(r0["restore_world2_level1_s"],
                                             r1["restore_world2_level1_s"]),
              "restore_width1_s": r0["restore_width1_s"],
              "parent_reserved_bytes": reserved,
              "disk_free_bytes_before": free,
              "failures": failures,
              "seconds": time.perf_counter() - t0, "card": card}
    emit(result)
    assert not failures, failures
    return result


# ---------------------------------------------------------------------------
# phase tp: Megatron tensor parallelism (parallel/tensor_parallel.py,
# parallel/tp_transformer.py) at the slice's widths, TP 2 over two ranks
# that share the card over gloo
# ---------------------------------------------------------------------------
def _tp_conf(**kw):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**dict(SLICE, n_layers=TP["n_layers"],
                                    block_size=None, **kw))


def _tp_f32():
    """The f32 check's configuration (SLICE's widths, f32 compute) and
    its rows of phase train's batch."""
    conf = _tp_conf(compute_dtype=None)
    return conf, _lm_batch(conf)[:TP_F32["rows"]]


def _tp_mlp_data():
    import numpy as np
    rng = np.random.RandomState(SEED + 21)
    n_in, _, n_out = TP_MLP["dims"]
    x = rng.normal(size=(TP_MLP["batch"], n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, n_out)).astype(np.float32)
    return x, np.eye(n_out, dtype=np.float32)[np.argmax(x @ w, 1)]


def _tp_mlp_init():
    import numpy as np
    rng = np.random.RandomState(SEED + 22)
    n_in, h, n_out = TP_MLP["dims"]
    return {"W1": (rng.normal(size=(n_in, h))
                   * (2.0 / (n_in + h)) ** 0.5).astype(np.float32),
            "b1": np.zeros(h, np.float32),
            "W2": (rng.normal(size=(h, n_out))
                   * (2.0 / (h + n_out)) ** 0.5).astype(np.float32),
            "b2": np.zeros(n_out, np.float32)}


def _flat_tree(tree):
    import numpy as np
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flat_tree(v) if isinstance(v, dict) else \
            [np.asarray(v, np.float32).ravel()]
    return out


def tp_rank_main(rank, out, device):
    """One rank of phase tp (``chip_smoke.py --tp-rank``): the slice's
    TPTransformerLM at TP 2 from the slice LM's initial parameters, TP
    ["steps"] steps at phase train's batch (each step's ms and its share
    in the all-reduces); the f32 check's run and its negative control
    (copy_to_model's backward all-reduce dropped); then the
    TensorParallelMLP at TP 2 from TP_MLP's parameters; rank 0 writes the
    whole parameters and the f32 runs' logits."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.parallel import multihost, tp_transformer
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        TensorParallelMLP, tp_mesh)
    from deeplearning4j_tpu_torch.parallel.tp_transformer import \
        TPTransformerLM
    dev, backend = multihost.reform(
        os.path.join(out, "store"), 2, rank,
        device=None if device == "cuda" else device,
        timeout=WORLD2_GROUP_TIMEOUT_S)
    conf = _tp_conf()
    mesh = tp_mesh(1, 2)
    tp = TPTransformerLM(mesh, conf, device=dev)
    batch = _lm_batch(conf)
    losses, step_ms, coll_ms = [], [], []
    for _ in range(TP["steps"]):
        c0 = mesh.collective_seconds
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(float(tp.fit_batch(batch)))
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append((mesh.collective_seconds - c0) * 1e3)
    mine, whole = tp.param_bytes()
    rec = {"rank": rank, "device": str(dev), "backend": backend,
           "losses": losses,
           "step_ms": step_ms, "allreduce_ms": coll_ms,
           "param_bytes_rank": mine, "param_bytes_whole": whole,
           "shard_fraction": tp.shard_fraction(),
           "peak_memory_bytes": _peak_bytes(dev)}
    params = np.concatenate(_flat_tree(tp.gathered_params()))
    del tp
    f32, toks = _tp_f32()
    keep = tp_transformer.copy_to_model
    for name in ("f32", "f32_no_backward_allreduce"):
        if name != "f32":
            # the negative control: Megatron's f without its backward
            # all-reduce, so each rank's gradient below a column-parallel
            # region holds only its own heads' share
            tp_transformer.copy_to_model = lambda x, mesh: x
        try:
            m = TPTransformerLM(mesh, f32, device=dev)
            before = m.gathered_logits(toks[:, :-1])
            rec[f"{name}_losses"] = [float(m.fit_batch(toks))
                                     for _ in range(TP["steps"])]
            logits = m.gathered_logits(toks[:, :-1])
        finally:
            tp_transformer.copy_to_model = keep
        if rank == 0:
            np.save(os.path.join(out, f"{name}_logits_before.npy"), before)
            np.save(os.path.join(out, f"{name}_logits.npy"), logits)
        del m, before, logits
    x, y = _tp_mlp_data()
    mlp = TensorParallelMLP(mesh, *TP_MLP["dims"], lr=TP_MLP["lr"],
                            params=_tp_mlp_init(), device=dev)
    rec["mlp_losses"] = [float(mlp.fit_batch(x, y))
                         for _ in range(TP_MLP["steps"])]
    mlp_params = np.concatenate(_flat_tree(mlp.gathered_params()))
    if rank == 0:
        np.save(os.path.join(out, "lm_params.npy"), params)
        np.save(os.path.join(out, "mlp_params.npy"), mlp_params)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    multihost.shutdown()
    return 0


def tp_single_device(dev):
    """The port's single-device TransformerLM (dense attention) from the
    same initial parameters on the same batch, TP["steps"] steps, and the
    same run from parameters perturbed by TP_PERTURB (the yardstick),
    each with its parameters before the steps; the f32 check's run and
    its run from parameters perturbed by TP_F32["perturb"] (losses, and
    logits before and after the steps); the
    TensorParallelMLP on one rank from TP_MLP's parameters, and its run
    perturbed by DP_W2_PERTURB."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerLM, _flatten, _tree_map)
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        TPMesh, TensorParallelMLP)
    conf = _tp_conf()
    batch = _lm_batch(conf).to(dev)
    out = {}
    for name, scale in (("single", 0.0), ("perturbed", TP_PERTURB)):
        lm = TransformerLM(conf, device=dev).init()
        if scale:
            g = torch.Generator(device=dev).manual_seed(SEED + 23)
            with torch.no_grad():
                for p in _flatten(lm.params).values():
                    p.mul_(1 + scale * torch.randn(
                        p.shape, generator=g, device=dev))
        start = np.concatenate(_flat_tree(_tree_map(
            lambda a: a.detach().cpu().numpy(), lm.params)))
        losses, step_ms = [], []
        for _ in range(TP["steps"]):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(float(lm.fit_batch(batch)))
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        params = np.concatenate(_flat_tree(_tree_map(
            lambda a: a.detach().cpu().numpy(), lm.params)))
        out[name] = {"losses": losses, "params": params, "start": start,
                     "step_ms": step_ms}
        del lm
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    f32, toks = _tp_f32()   # host tokens: output() copies them over
    for name, scale in (("f32", 0.0), ("f32_perturbed", TP_F32["perturb"])):
        lm = TransformerLM(f32, device=dev).init()
        if scale:
            g = torch.Generator(device=dev).manual_seed(SEED + 25)
            with torch.no_grad():
                for p in _flatten(lm.params).values():
                    p.mul_(1 + scale * torch.randn(
                        p.shape, generator=g, device=dev))
        before = lm.output(toks[:, :-1])
        losses = [float(lm.fit_batch(toks.to(dev)))
                  for _ in range(TP["steps"])]
        out[name] = {"losses": losses, "logits_before": before,
                     "logits": lm.output(toks[:, :-1])}
        del lm
    x, y = _tp_mlp_data()
    for name, scale in (("mlp", 0.0), ("mlp_perturbed", DP_W2_PERTURB)):
        init = _tp_mlp_init()
        if scale:
            rng = np.random.default_rng(SEED + 24)
            init = {k: (v * (1 + scale * rng.standard_normal(v.shape)))
                    .astype(np.float32) for k, v in init.items()}
        mlp = TensorParallelMLP(TPMesh(1, 1, 0, 0), *TP_MLP["dims"],
                                lr=TP_MLP["lr"], params=init, device=dev)
        losses = [float(mlp.fit_batch(x, y)) for _ in range(TP_MLP["steps"])]
        out[name] = {"losses": losses, "params": np.concatenate(
            _flat_tree(mlp.gathered_params()))}
    return out


def phase_tp(card):
    """TPTransformerLM at TP 2 (two ranks on the card, gloo) against the
    single-device LM from the same parameters: in bf16, the update's
    relative L2 distance within TP_CHAOS times that of the single-device
    run from parameters perturbed by TP_PERTURB (a bar that must reject
    an unchanged state), each step's loss within DP_W2_LOSS_RTOL; in f32
    on TP_F32["rows"] rows, the forward's logits and the losses within
    TP_F32["rel"] of their max abs and the logits after the steps within
    TP_CHAOS times a TP_F32["perturb"] run's drift, bars that must reject
    an unchanged state and a run without copy_to_model's backward
    all-reduce; ms a step, tokens/s,
    parameter bytes a rank against the whole and the all-reduces' share
    of the step. The TensorParallelMLP at TP 2 against its single-rank
    run (DP_W2_CHAOS times a run perturbed by DP_W2_PERTURB)."""
    import tempfile
    import numpy as np
    import torch
    t0 = time.perf_counter()
    dev = torch.device(DEVICE if DEVICE != "cuda" else "cuda:0")
    single = tp_single_device(dev)
    reserved = _release_card()
    with tempfile.TemporaryDirectory() as out:
        ranks = _world(2, "--tp-rank", out, TP_TIMEOUT_S)
        lm_params = np.load(os.path.join(out, "lm_params.npy"))
        mlp_params = np.load(os.path.join(out, "mlp_params.npy"))
        f32_logits = {(name, when): np.load(os.path.join(
            out, f"{name}_logits{when}.npy"))
            for name in ("f32", "f32_no_backward_allreduce")
            for when in ("_before", "")}
    r0, r1 = ranks

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    s, p = single["single"], single["perturbed"]
    # on the update: an unchanged state is at distance 1
    d_single = s["params"] - s["start"]
    dist = rel_l2(lm_params - s["start"], d_single)
    yard = rel_l2(p["params"] - p["start"], d_single)
    f, fp = single["f32"], single["f32_perturbed"]

    def max_abs(a):
        return float(np.max(np.abs(np.asarray(a))))
    f32_bar = {"logits_before": TP_F32["rel"] * max_abs(f["logits_before"]),
               "losses": TP_F32["rel"] * max_abs(f["losses"]),
               "logits": TP_CHAOS * max_abs(fp["logits"] - f["logits"])}

    def f32_diff(name):
        return {"logits_before": max_abs(f32_logits[name, "_before"]
                                         - f["logits_before"]),
                "losses": max_abs(np.asarray(r0[f"{name}_losses"])
                                  - f["losses"]),
                "logits": max_abs(f32_logits[name, ""] - f["logits"])}

    def f32_within(diff):
        return all(diff[k] <= f32_bar[k] for k in f32_bar)
    f32 = f32_diff("f32")
    no_ar = f32_diff("f32_no_backward_allreduce")
    unchanged = {"logits": max_abs(f["logits_before"] - f["logits"])}
    loss_diff = max(abs(a - b) / abs(b)
                    for a, b in zip(r0["losses"], s["losses"]))
    loss_yard = max(abs(a - b) / abs(b)
                    for a, b in zip(p["losses"], s["losses"]))
    mlp_dist = rel_l2(mlp_params, single["mlp"]["params"])
    mlp_yard = rel_l2(single["mlp_perturbed"]["params"],
                      single["mlp"]["params"])
    timed = r0["step_ms"][1:]
    step_ms = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * (SLICE["max_len"] - 1)
    failures = [what for ok, what in (
        (r0["losses"] == r1["losses"], "the ranks' losses differ"),
        (dist <= TP_CHAOS * yard, f"LM update {dist} vs yardstick {yard}"),
        (TP_CHAOS * yard < 1.0, f"the LM update bar {TP_CHAOS * yard} "
         "does not reject an unchanged state"),
        (f32_within(f32), f"f32 TP {f32} vs bar {f32_bar}"),
        (unchanged["logits"] > f32_bar["logits"],
         f"the f32 bar does not reject an unchanged state: {unchanged}"),
        (not f32_within(no_ar), "the f32 bar does not reject a run "
         f"without the backward all-reduce: {no_ar} vs {f32_bar}"),
        (loss_diff <= DP_W2_LOSS_RTOL, f"LM loss {loss_diff}"),
        (mlp_dist <= DP_W2_CHAOS * mlp_yard,
         f"MLP params {mlp_dist} vs yardstick {mlp_yard}"),
        (r0["mlp_losses"][-1] < r0["mlp_losses"][0], "MLP loss did not fall"),
        (r0["shard_fraction"] < 0.8, "parameters not sharded")) if not ok]
    result = {"phase": "tp",
              "config": dict(TP, model=dict(SLICE, n_layers=TP["n_layers"],
                                            block_size=None),
                             batch=TRAIN_BATCH, tp=2, backend=r0["backend"],
                             perturb=TP_PERTURB, chaos=TP_CHAOS, mlp=TP_MLP),
              "losses": r0["losses"], "single_device_losses": s["losses"],
              "step_ms_by_step": r0["step_ms"], "ms_per_step": step_ms,
              "tokens_per_s": tokens / step_ms * 1e3,
              # the first step of each run (cuBLAS's and the
              # allocator's first use) is left out of both means
              "single_device_ms_per_step": sum(s["step_ms"][1:])
              / len(s["step_ms"][1:]),
              "single_device_step_ms_by_step": s["step_ms"],
              "allreduce_share_of_step": sum(r0["allreduce_ms"][1:])
              / sum(timed),
              "param_bytes_rank": r0["param_bytes_rank"],
              "param_bytes_whole": r0["param_bytes_whole"],
              "param_fraction_rank": r0["shard_fraction"],
              "peak_memory_bytes_rank0": r0["peak_memory_bytes"],
              "update_rel_l2_vs_single": dist,
              "yardstick_update_rel_l2": yard,
              "f32": {"rows": TP_F32["rows"], "rel": TP_F32["rel"],
                      "perturb": TP_F32["perturb"], "chaos": TP_CHAOS,
                      "bar": f32_bar, "max_abs_diff_vs_single": f32,
                      "losses": r0["f32_losses"],
                      "single_device_losses": f["losses"],
                      "unchanged_state_max_abs_diff": unchanged,
                      "no_backward_allreduce_max_abs_diff": no_ar},
              "loss_max_rel_diff_vs_single": loss_diff,
              "loss_rtol": DP_W2_LOSS_RTOL,
              "perturbed_loss_max_rel_diff": loss_yard,
              "mlp": {"losses": r0["mlp_losses"],
                      "single_rank_losses": single["mlp"]["losses"],
                      "params_rel_l2_vs_single_rank": mlp_dist,
                      "yardstick_rel_l2": mlp_yard},
              "parent_reserved_bytes": reserved,
              "ranks": ranks, "failures": failures,
              "seconds": time.perf_counter() - t0, "card": card}
    emit(result)
    assert not failures, failures
    return result



# ---------------------------------------------------------------------------
# phases pp, sp and ep: pipeline, sequence and expert parallelism
# (parallel/pipeline_parallel.py, pp_transformer.py, sp_transformer.py,
# sequence_parallel.py, expert_parallel.py, ep_transformer.py), each on
# ranks that share the card over gloo
# ---------------------------------------------------------------------------
def _perturb(params, scale, seed, dev):
    """Every leaf of ``params`` moved by ``scale`` relative (a seeded
    normal draw an element), in place."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import _flatten
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in _flatten(params).values():
            p.mul_(1 + scale * torch.randn(p.shape, generator=g, device=dev))


def _flat_params(tree):
    """The leaves of a tree of tensors or arrays as one f32 vector
    (``_flat_tree``'s order)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.transformer import _tree_map
    return np.concatenate(_flat_tree(_tree_map(
        lambda a: a.detach().cpu().numpy() if hasattr(a, "detach")
        else np.asarray(a), tree)))


def _timed_steps(fit, batch, steps, dev, mesh=None):
    """``steps`` calls of ``fit(batch)``: losses and each step's ms, and
    with a grid its all-reduce (and all-to-all) and point-to-point ms."""
    rec = {"losses": [], "step_ms": [], "allreduce_ms": [], "p2p_ms": []}
    for _ in range(steps):
        c0 = mesh.collective_seconds if mesh else 0.0
        q0 = mesh.p2p_seconds if mesh else 0.0
        _sync(dev)
        t0 = time.perf_counter()
        rec["losses"].append(float(fit(batch)))
        _sync(dev)
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if mesh:
            rec["allreduce_ms"].append((mesh.collective_seconds - c0) * 1e3)
            rec["p2p_ms"].append((mesh.p2p_seconds - q0) * 1e3)
    return rec


def _single_device_runs(make, conf, f32, batch, rows, dev, floor=False):
    """The single-device model (``make(conf)``, initialised on ``dev``)
    from the phase's parameters, MP["steps"] steps at ``batch``, and the
    same from parameters perturbed by TP_PERTURB (the update's
    yardstick) and, with ``floor``, by EP_FLOOR_PERTURB, each with its
    parameters before and after; then the f32 copy on ``rows`` (losses,
    logits before and after) and its run from parameters perturbed by
    TP_F32["perturb"]."""
    import torch
    out = {}
    runs = [("single", conf, batch, 0.0, 0),
            ("perturbed", conf, batch, TP_PERTURB, SEED + 23),
            ("f32", f32, rows, 0.0, 0),
            ("f32_perturbed", f32, rows, TP_F32["perturb"], SEED + 25)]
    if floor:
        runs.append(("perturbed_floor", conf, batch, EP_FLOOR_PERTURB,
                     SEED + 23))
    for name, c, toks, scale, seed in runs:
        lm = make(c)
        if scale:
            _perturb(lm.params, scale, seed, dev)
        f32_run = name.startswith("f32")
        rec = ({"logits_before": lm.output(toks[:, :-1])} if f32_run
               else {"start": _flat_params(lm.params)})
        rec.update(_timed_steps(lm.fit_batch, toks.to(dev), MP["steps"],
                                dev))
        if f32_run:
            rec["logits"] = lm.output(toks[:, :-1])
        else:
            rec["params"] = _flat_params(lm.params)
        out[name] = rec
        del lm
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _mp_rank_runs(make, conf, f32, batch, rows, control, dev, mesh, out,
                  rank):
    """One rank's runs of a model-parallel trainer (``make(conf)``):
    MP["steps"] timed steps at ``batch`` with the flash launch counts set
    to 0 just before and read just after, the staged transfers, the
    parameters (rank 0 writes them); the same steps with the strategy's
    collective removed (``control(trainer)``, a context); the f32 copy on
    ``rows`` and its control (losses, logits before and after). Returns
    the rank's record."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.parallel import multihost
    tr = make(conf)
    staged = dict(multihost.staging)
    reset_launches()
    rec = _timed_steps(tr.fit_batch, batch, MP["steps"], dev, mesh)
    rec["flash_launches"] = dict(zip(FLASH, read_launches()))
    rec["staged"] = {k: multihost.staging[k] - staged[k] for k in staged}
    rec["peak_memory_bytes"] = _peak_bytes(dev)
    if hasattr(tr, "shard_fraction"):
        rec["shard_fraction"] = tr.shard_fraction()
    if hasattr(tr, "routed"):
        rec["tokens_per_expert"] = tr.routed.cpu().numpy().tolist()
    arrays = {"params": _flat_params(tr.gathered_params())}
    del tr
    tr = make(conf)
    with control(tr):
        rec["control_losses"] = [float(tr.fit_batch(batch))
                                 for _ in range(MP["steps"])]
    arrays["control_params"] = _flat_params(tr.gathered_params())
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for name in ("f32", "f32_control"):
        tr = make(f32)
        arrays[f"{name}_logits_before"] = tr.gathered_logits(rows[:, :-1])
        with (control(tr) if name == "f32_control" else nullcontext()):
            rec[f"{name}_losses"] = [float(tr.fit_batch(rows))
                                     for _ in range(MP["steps"])]
        arrays[f"{name}_logits"] = tr.gathered_logits(rows[:, :-1])
        del tr
    if rank == 0:
        for k, v in arrays.items():
            np.save(os.path.join(out, f"{k}.npy"), v)
    return rec


def _mp_bars(single, ranks, out, update_bar=True):
    """Phase tp's bars on a model-parallel run against the single-device
    model's: the bf16 update's relative L2 distance within TP_CHAOS times
    the perturbed run's (with ``update_bar``: a bar that must reject an
    unchanged state, whose distance is 1; without, the distances are
    reported only), each step's loss within DP_W2_LOSS_RTOL, and an
    unchanged state (its losses the first step's) and the run with the
    collective removed each outside a gated bf16 bar; in f32 the
    forward's logits and the losses within TP_F32["rel"] of their max
    abs, the logits after the steps within TP_CHAOS times the
    TP_F32["perturb"] run's drift, a bar that must reject an unchanged
    state and the run with the collective removed. Returns (record,
    failures)."""
    import numpy as np
    arr = {k[:-4]: np.load(os.path.join(out, k)) for k in os.listdir(out)
           if k.endswith(".npy")}
    r0 = ranks[0]

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def max_abs(a):
        return float(np.max(np.abs(np.asarray(a))))
    s, p = single["single"], single["perturbed"]
    d_single = s["params"] - s["start"]
    dist = rel_l2(arr["params"] - s["start"], d_single)
    control = rel_l2(arr["control_params"] - s["start"], d_single)
    yard = rel_l2(p["params"] - p["start"], d_single)
    f, fp = single["f32"], single["f32_perturbed"]
    f32_bar = {"logits_before": TP_F32["rel"] * max_abs(f["logits_before"]),
               "losses": TP_F32["rel"] * max_abs(f["losses"]),
               "logits": TP_CHAOS * max_abs(fp["logits"] - f["logits"])}

    def f32_diff(name):
        return {"logits_before": max_abs(arr[f"{name}_logits_before"]
                                         - f["logits_before"]),
                "losses": max_abs(np.asarray(r0[f"{name}_losses"])
                                  - f["losses"]),
                "logits": max_abs(arr[f"{name}_logits"] - f["logits"])}

    def within(diff):
        return all(diff[k] <= f32_bar[k] for k in f32_bar)
    f32, f32_control = f32_diff("f32"), f32_diff("f32_control")
    unchanged = max_abs(f["logits_before"] - f["logits"])
    def loss_diff(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, s["losses"]))
    bar = TP_CHAOS * yard if update_bar else math.inf
    control_loss = loss_diff(r0["control_losses"])
    unchanged_loss = loss_diff([s["losses"][0]] * len(s["losses"]))
    failures = [what for ok, what in (
        (all(r["losses"] == r0["losses"] for r in ranks),
         "the ranks' losses differ"),
        (dist <= bar, f"update {dist} vs yardstick {yard}"),
        (bar < 1.0 or unchanged_loss > DP_W2_LOSS_RTOL,
         f"the bf16 bars do not reject an unchanged state: update bar "
         f"{bar}, its losses {unchanged_loss} off"),
        (loss_diff(r0["losses"]) <= DP_W2_LOSS_RTOL,
         f"loss {loss_diff(r0['losses'])}"),
        (control > bar or control_loss > DP_W2_LOSS_RTOL,
         f"the bf16 bars do not reject the run without the collective: "
         f"update {control}, loss {control_loss}"),
        (within(f32), f"f32 {f32} vs bar {f32_bar}"),
        (unchanged > f32_bar["logits"],
         f"the f32 bar does not reject an unchanged state: {unchanged}"),
        (not within(f32_control), "the f32 bar does not reject the run "
         f"without the collective: {f32_control}")) if not ok]
    timed = r0["step_ms"][1:]
    rec = {"losses": r0["losses"], "single_device_losses": s["losses"],
           "step_ms_by_step": r0["step_ms"],
           "ms_per_step": sum(timed) / len(timed),
           "single_device_ms_per_step": sum(s["step_ms"][1:])
           / len(s["step_ms"][1:]),
           "allreduce_share_of_step": sum(r0["allreduce_ms"][1:])
           / sum(timed),
           "p2p_share_of_step": sum(r0["p2p_ms"][1:]) / sum(timed),
           "update_rel_l2_vs_single": dist,
           "yardstick_update_rel_l2": yard,
           "update_bar": bar if update_bar else None,
           "yardstick_floor_update_rel_l2": rel_l2(
               single["perturbed_floor"]["params"]
               - single["perturbed_floor"]["start"], d_single)
           if "perturbed_floor" in single else None,
           "unchanged_state_loss_max_rel_diff": unchanged_loss,
           "control_update_rel_l2": control,
           "control_rejected_by_update_bar": control > bar,
           "control_losses": r0["control_losses"],
           "control_loss_max_rel_diff": control_loss,
           "loss_max_rel_diff_vs_single": loss_diff(r0["losses"]),
           "loss_rtol": DP_W2_LOSS_RTOL,
           "f32": {"bar": f32_bar, "max_abs_diff_vs_single": f32,
                   "losses": r0["f32_losses"],
                   "single_device_losses": f["losses"],
                   "unchanged_state_max_abs_diff": unchanged,
                   "control_max_abs_diff": f32_control}}
    return rec, failures


def _mp_phase(name, n_ranks, flag, single, extra_checks, card, t0,
              config, update_bar=True):
    """Start the phase's ranks, hold the runs against ``single`` on
    _mp_bars, add the phase's own checks (``extra_checks(ranks, out)``:
    (record, failures)), print the record and fail on any failure."""
    import tempfile
    reserved = _release_card()
    with tempfile.TemporaryDirectory() as out:
        ranks = _world(n_ranks, flag, out, MP_TIMEOUT_S)
        rec, failures = _mp_bars(single, ranks, out, update_bar)
        more, more_failures = extra_checks(ranks, out)
    r0 = ranks[0]
    result = {"phase": name, "config": dict(config, backend=r0["backend"],
                                            ranks=n_ranks,
                                            perturb=TP_PERTURB,
                                            chaos=TP_CHAOS, f32=TP_F32),
              **rec, **more,
              "flash_launches_by_rank": [r["flash_launches"] for r in ranks],
              "staged_by_rank": [r["staged"] for r in ranks],
              "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                            for r in ranks],
              "parent_reserved_bytes": reserved, "ranks": ranks,
              "failures": failures + more_failures,
              "seconds": time.perf_counter() - t0, "card": card}
    emit(result)
    assert not result["failures"], result["failures"]
    return result


def _mp_rank_start(rank, out, device, n):
    """A phase rank's process group (gloo: the ranks share the card) and
    device; TF32 off, as the parent's parity phases."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.parallel import multihost
    return multihost.reform(os.path.join(out, "store"), n, rank,
                            device=None if device == "cuda" else device,
                            timeout=WORLD2_GROUP_TIMEOUT_S)


def _rank_done(rank, out, rec):
    from deeplearning4j_tpu_torch.parallel import multihost
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    multihost.shutdown()
    return 0


def _lm_conf(**kw):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**dict(SLICE, **kw))


def _lm_init(dev):
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    return lambda c: TransformerLM(c, device=dev).init()


# ---- phase pp ---------------------------------------------------------------
def _pp_net_init():
    import numpy as np
    rng = np.random.RandomState(SEED + 26)
    n_in, d, n_out = TP_MLP["dims"]
    S = PP["stages"]
    return {"W": (rng.normal(size=(S, d, d)) * (2.0 / (2 * d)) ** 0.5)
            .astype(np.float32),
            "b": np.zeros((S, d), np.float32),
            "Win": (rng.normal(size=(n_in, d)) * (2.0 / (n_in + d)) ** 0.5)
            .astype(np.float32),
            "Wout": (rng.normal(size=(d, n_out)) * (2.0 / (d + n_out))
                     ** 0.5).astype(np.float32)}


def _pp_net_single(init, dev):
    """PipelineParallelNet's math unpipelined on one device (every stage
    in turn, one loss over the batch, SGD): TP_MLP["steps"] steps'
    losses and the parameters after."""
    import torch
    x, y = (torch.tensor(a, device=dev) for a in _tp_mlp_data())
    p = {k: torch.tensor(v, device=dev, requires_grad=True)
         for k, v in init.items()}
    losses = []
    for _ in range(TP_MLP["steps"]):
        h = torch.tanh(x @ p["Win"])
        for s in range(PP["stages"]):
            h = h + torch.tanh(h @ p["W"][s] + p["b"][s])
        loss = -(y * torch.log_softmax(h @ p["Wout"], -1)).sum() / x.shape[0]
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v.sub_(TP_MLP["lr"] * g)
        losses.append(float(loss.detach()))
    return {"losses": losses, "params": _flat_params(p)}


def _pp_backward_without_sends(pp):
    """The control: PPTransformerLM's backward with its point-to-point
    sends removed (a stage's output gradient zero where the next stage's
    would arrive)."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import _flatten

    def backward(ins, outs):
        leaves = list(_flatten(pp.params).values())
        for m in reversed(range(len(outs))):
            grad = None if pp.stage == pp.S - 1 \
                else torch.zeros_like(outs[m])
            torch.autograd.backward(outs[m], grad, inputs=leaves)
    return mock.patch.object(pp, "_backward", backward)


def pp_rank_main(rank, out, device):
    """One rank of phase pp (``chip_smoke.py --pp-rank``): the slice's
    PPTransformerLM at S PP["stages"] x M PP["micro"] from the slice
    LM's initial parameters, its control and its f32 copy
    (``_mp_rank_runs``), then PipelineParallelNet at TP_MLP's widths."""
    import numpy as np
    dev, backend = _mp_rank_start(rank, out, device, PP["stages"])
    from deeplearning4j_tpu_torch.parallel.pipeline_parallel import (
        PipelineParallelNet, pp_mesh)
    from deeplearning4j_tpu_torch.parallel.pp_transformer import \
        PPTransformerLM
    mesh = pp_mesh(1, PP["stages"])
    conf = _lm_conf()

    def make(c):
        # the f32 copy's 2 rows are 2 microbatches of 1
        micro = PP["micro"] if c.compute_dtype else TP_F32["rows"]
        return PPTransformerLM(mesh, c, micro, device=dev)
    rec = _mp_rank_runs(make, conf, _lm_conf(compute_dtype=None),
                        _lm_batch(conf), _lm_batch(conf)[:TP_F32["rows"]],
                        _pp_backward_without_sends, dev, mesh, out, rank)
    rec.update(rank=rank, device=str(dev), backend=backend)
    x, y = _tp_mlp_data()
    net = PipelineParallelNet(mesh, *TP_MLP["dims"], PP["micro"],
                              lr=TP_MLP["lr"], params=_pp_net_init(),
                              device=dev)
    rec["net_first_unpipelined_loss"] = net.reference_loss(x, y)
    rec["net_losses"] = [float(net.fit_batch(x, y))
                         for _ in range(TP_MLP["steps"])]
    params = _flat_params(net.gathered_params())
    if rank == 0:
        np.save(os.path.join(out, "net_params.npy"), params)
    return _rank_done(rank, out, rec)


def phase_pp(card):
    """PPTransformerLM (GPipe, S 2 x M 4, the flash route) at the slice's
    widths and depth over two ranks sharing the card, against the
    single-device LM from the same parameters on phase tp's bars (see
    PP); ms a step, tokens/s, the parameter share a rank (expected
    PP_SHARD_FRACTION), the point-to-point and all-reduce shares of a
    step, each rank's flash launches (each of the three kernels once a
    layer of its stage a microbatch a step); PipelineParallelNet at
    TP_MLP's widths against its unpipelined math on one rank."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    dev = torch.device(DEVICE if DEVICE != "cuda" else "cuda:0")
    conf = _lm_conf()
    single = _single_device_runs(
        _lm_init(dev), conf, _lm_conf(compute_dtype=None), _lm_batch(conf),
        _lm_batch(conf)[:TP_F32["rows"]], dev)
    init = _pp_net_init()
    net = _pp_net_single(init, dev)
    rng = np.random.default_rng(SEED + 27)
    net_yard = _pp_net_single(
        {k: (v * (1 + DP_W2_PERTURB * rng.standard_normal(v.shape)))
         .astype(np.float32) for k, v in init.items()}, dev)
    per_rank = conf.n_layers // PP["stages"] * PP["micro"] * MP["steps"]

    def checks(ranks, out):
        got = np.load(os.path.join(out, "net_params.npy"))
        dist = float(np.linalg.norm(got - net["params"])
                     / np.linalg.norm(net["params"]))
        yard = float(np.linalg.norm(net_yard["params"] - net["params"])
                     / np.linalg.norm(net["params"]))
        r0 = ranks[0]
        failures = [what for ok, what in (
            (all(r["flash_launches"] == dict.fromkeys(FLASH, per_rank)
                 for r in ranks),
             f"flash launches {[r['flash_launches'] for r in ranks]}, "
             f"want {per_rank} of each a rank"),
            (abs(r0["shard_fraction"] - PP_SHARD_FRACTION) < 1e-9,
             f"parameter share {r0['shard_fraction']}"),
            (dist <= DP_W2_CHAOS * yard,
             f"PipelineParallelNet {dist} vs yardstick {yard}"),
            (abs(r0["net_losses"][0] - r0["net_first_unpipelined_loss"])
             <= 1e-5 * abs(r0["net_first_unpipelined_loss"]),
             "the pipelined loss is not the unpipelined one"),
            (r0["net_losses"][-1] < r0["net_losses"][0],
             "PipelineParallelNet's loss did not fall")) if not ok]
        return {"tokens_per_s": TRAIN_BATCH * (SLICE["max_len"] - 1)
                / (sum(r0["step_ms"][1:]) / len(r0["step_ms"][1:])) * 1e3,
                "shard_fraction": r0["shard_fraction"],
                "expected_flash_launches_per_rank": per_rank,
                "net": {"losses": r0["net_losses"],
                        "single_rank_losses": net["losses"],
                        "first_unpipelined_loss":
                            r0["net_first_unpipelined_loss"],
                        "params_rel_l2_vs_single_rank": dist,
                        "yardstick_rel_l2": yard}}, failures
    return _mp_phase("pp", PP["stages"], "--pp-rank", single, checks, card,
                     t0, dict(PP, model=SLICE, batch=TRAIN_BATCH,
                              net=dict(TP_MLP, micro=PP["micro"])))


# ---- phase sp ---------------------------------------------------------------
def _sp_batch(conf, rows=TRAIN_BATCH):
    """Rows of SP["t"] + 1 tokens (next-token setup: T = max_len)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 28)
    return torch.from_numpy(rng.randint(0, conf.vocab_size,
                                        (rows, SP["t"] + 1)))


class _NoRotate:
    """The control: the ring's rotation replaced by the identity (each
    rank attends its own K/V block at every step)."""

    @staticmethod
    def apply(x, mesh, axis):
        return x


def _attention_case(mesh, dev):
    """ring (``sequence_parallel_attention``) and Ulysses attention at
    one layer's shape (SP_ATTN, f32, causal) on the card against
    ``dense_attention``: the largest difference, and each one's ms."""
    import torch
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        dense_attention, sequence_parallel_attention, ulysses_attention)
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    q, k, v = (torch.randn(SP_ATTN, generator=g, device=dev)
               for _ in range(3))
    heads = [a.transpose(1, 2).contiguous() for a in (q, k, v)]
    rec = {}
    for name, fn in (
            ("dense", lambda: dense_attention(q, k, v, causal=True)),
            ("ring", lambda: sequence_parallel_attention(q, k, v, mesh,
                                                         causal=True)),
            ("ulysses", lambda: ulysses_attention(
                *heads, mesh, causal=True).transpose(1, 2))):
        o = fn()     # a first call, then the timed one
        _sync(dev)
        t0 = time.perf_counter()
        o = fn()
        _sync(dev)
        rec[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        if name == "dense":
            dense = o
        else:
            rec[f"{name}_max_abs_diff"] = float((o - dense).abs().max())
    rec["bar"] = TP_F32["rel"] * float(dense.abs().max())
    return rec


def sp_rank_main(rank, out, device):
    """One rank of phase sp (``chip_smoke.py --sp-rank``): the slice's
    SPTransformerLM at N SP["ranks"], its control and its f32 copy
    (``_mp_rank_runs``), then ring and Ulysses attention at a layer's
    shape."""
    dev, backend = _mp_rank_start(rank, out, device, SP["ranks"])
    from deeplearning4j_tpu_torch.parallel import sequence_parallel
    from deeplearning4j_tpu_torch.parallel.sp_transformer import \
        SPTransformerLM
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import tp_mesh
    mesh = tp_mesh(1, SP["ranks"], ("data", "seq"))
    conf = _sp_conf()
    rec = _mp_rank_runs(
        lambda c: SPTransformerLM(mesh, c, device=dev), conf,
        _sp_conf(compute_dtype=None), _sp_batch(conf),
        _sp_batch(conf, TP_F32["rows"]),
        lambda tr: mock.patch.object(sequence_parallel, "_Rotate", _NoRotate),
        dev, mesh, out, rank)
    rec.update(rank=rank, device=str(dev), backend=backend,
               attention=_attention_case(mesh, dev))
    return _rank_done(rank, out, rec)


def _sp_conf(**kw):
    return _lm_conf(**dict(dict(block_size=None), **kw))


def phase_sp(card):
    """SPTransformerLM (ring attention, N 2, T 512) at the slice's widths
    and depth over two ranks sharing the card against the single-device
    dense LM from the same parameters on phase tp's bars (see SP); ms a
    step, tokens/s, the rotations' and the all-reduce's shares of a
    step; ring and Ulysses attention at a layer's shape against dense
    attention."""
    import torch
    t0 = time.perf_counter()
    dev = torch.device(DEVICE if DEVICE != "cuda" else "cuda:0")
    conf = _sp_conf()
    single = _single_device_runs(
        _lm_init(dev), conf, _sp_conf(compute_dtype=None), _sp_batch(conf),
        _sp_batch(conf, TP_F32["rows"]), dev)

    def checks(ranks, out):
        r0 = ranks[0]
        att = [r["attention"] for r in ranks]
        failures = [what for ok, what in (
            (all(a[f"{k}_max_abs_diff"] <= a["bar"] for a in att
                 for k in ("ring", "ulysses")),
             f"ring or Ulysses attention against dense: {att}"),
            (all(v == 0 for r in ranks for v in r["flash_launches"].values()),
             "a flash kernel launched on the ring's path")) if not ok]
        return {"tokens_per_s": TRAIN_BATCH * SP["t"]
                / (sum(r0["step_ms"][1:]) / len(r0["step_ms"][1:])) * 1e3,
                "attention": att}, failures
    return _mp_phase("sp", SP["ranks"], "--sp-rank", single, checks, card,
                     t0, dict(SP, model=dict(SLICE, block_size=None),
                              batch=TRAIN_BATCH, attention_shape=SP_ATTN))


# ---- phase ep ---------------------------------------------------------------
def _ep_conf(**kw):
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerConfig
    return MoETransformerConfig(**dict(MOE, block_size=None, **kw))


def _ep_moe_data():
    import numpy as np
    rng = np.random.RandomState(SEED + 30)
    d, n_out = EP_MOE["d"], EP_MOE["n_out"]
    x = rng.normal(size=(EP_MOE["batch"], d)).astype(np.float32)
    w = rng.normal(size=(d, n_out)).astype(np.float32)
    return x, np.eye(n_out, dtype=np.float32)[np.argmax(x @ w, 1)]


def _ep_moe_init():
    """ExpertParallelMoE's parameters at the reference's scales, from a
    numpy seed."""
    import numpy as np
    rng = np.random.RandomState(SEED + 31)
    d, h, n, E = EP_MOE["d"], EP_MOE["hidden"], EP_MOE["n_out"], EP["ranks"]
    return {"gate": (0.1 * rng.normal(size=(d, E))).astype(np.float32),
            "W1": (rng.normal(size=(E, d, h)) * (2.0 / (d + h)) ** 0.5)
            .astype(np.float32),
            "W2": (rng.normal(size=(E, h, d)) * (2.0 / (h + d)) ** 0.5)
            .astype(np.float32),
            "head": (rng.normal(size=(d, n)) * (2.0 / (d + n)) ** 0.5)
            .astype(np.float32)}


def _ep_moe_single(init, dev):
    """ExpertParallelMoE's math on one device, every expert on every
    token and the routed one selected (top-1, the gate probability as
    its weight), SGD: EP_MOE["steps"] steps' losses and the parameters
    after."""
    import torch
    x, y = (torch.tensor(a, device=dev) for a in _ep_moe_data())
    p = {k: torch.tensor(v, device=dev, requires_grad=True)
         for k, v in init.items()}
    losses = []
    rows = torch.arange(x.shape[0], device=dev)
    for _ in range(EP_MOE["steps"]):
        prob, e = torch.softmax(x @ p["gate"], -1).max(-1)
        hid = torch.relu(torch.einsum("nd,edh->neh", x, p["W1"]))
        moe = torch.einsum("neh,ehd->ned", hid, p["W2"])[rows, e]
        logits = (x + prob[:, None] * moe) @ p["head"]
        loss = -(y * torch.log_softmax(logits, -1)).sum() / x.shape[0]
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v.sub_(EP_MOE["lr"] * g)
        losses.append(float(loss.detach()))
    return {"losses": losses, "params": _flat_params(p)}


def ep_rank_main(rank, out, device):
    """One rank of phase ep (``chip_smoke.py --ep-rank``): the MoE LM's
    EPTransformerLM at E EP["ranks"], its control and its f32 copy
    (``_mp_rank_runs``; the f32 copy at aux 0, where the math is exact),
    then ExpertParallelMoE at world 4."""
    import numpy as np
    dev, backend = _mp_rank_start(rank, out, device, EP["ranks"])
    from deeplearning4j_tpu_torch.parallel import expert_parallel
    from deeplearning4j_tpu_torch.parallel.ep_transformer import \
        EPTransformerLM
    from deeplearning4j_tpu_torch.parallel.expert_parallel import (
        ExpertParallelMoE, ep_mesh)
    mesh = ep_mesh(EP["ranks"])
    conf = _ep_conf()
    rec = _mp_rank_runs(
        lambda c: EPTransformerLM(mesh, c, device=dev), conf,
        _ep_conf(compute_dtype=None, aux_weight=0.0), _lm_batch(conf),
        _lm_batch(conf)[:EP_F32_ROWS],
        lambda tr: mock.patch.object(expert_parallel, "all_to_all",
                            lambda x, *a: x),
        dev, mesh, out, rank)
    rec.update(rank=rank, device=str(dev), backend=backend)
    x, y = _ep_moe_data()
    moe = ExpertParallelMoE(mesh, EP_MOE["d"], EP_MOE["hidden"],
                            EP_MOE["n_out"], lr=EP_MOE["lr"],
                            params=_ep_moe_init(), device=dev)
    rec["moe_forward_max_abs_diff"] = float(np.abs(
        moe.predict(x) - moe.reference_forward(x)).max())
    rec["moe_losses"] = [float(moe.fit_batch(x, y))
                         for _ in range(EP_MOE["steps"])]
    params = _flat_params(moe.gathered_params())
    if rank == 0:
        np.save(os.path.join(out, "moe_params.npy"), params)
    return _rank_done(rank, out, rec)


def phase_ep(card):
    """EPTransformerLM (all-to-all Switch dispatch, E 4 over four ranks
    sharing the card) at phase moe's configuration against the dense
    MoETransformerLM from the same parameters on phase tp's bars (see
    EP); ms a step, tokens/s, the all-to-alls' and all-reduce's share of
    a step, tokens a expert; ExpertParallelMoE at world 4 against its
    dense oracle and its dense math on one rank."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerLM
    t0 = time.perf_counter()
    dev = torch.device(DEVICE if DEVICE != "cuda" else "cuda:0")
    conf = _ep_conf()
    single = _single_device_runs(
        lambda c: MoETransformerLM(c, device=dev).init(), conf,
        _ep_conf(compute_dtype=None, aux_weight=0.0), _lm_batch(conf),
        _lm_batch(conf)[:EP_F32_ROWS], dev, floor=True)
    init = _ep_moe_init()
    moe = _ep_moe_single(init, dev)
    rng = np.random.default_rng(SEED + 32)
    moe_yard = _ep_moe_single(
        {k: (v * (1 + DP_W2_PERTURB * rng.standard_normal(v.shape)))
         .astype(np.float32) for k, v in init.items()}, dev)

    def checks(ranks, out):
        got = np.load(os.path.join(out, "moe_params.npy"))
        dist = float(np.linalg.norm(got - moe["params"])
                     / np.linalg.norm(moe["params"]))
        yard = float(np.linalg.norm(moe_yard["params"] - moe["params"])
                     / np.linalg.norm(moe["params"]))
        r0 = ranks[0]
        routed = np.asarray(r0["tokens_per_expert"])
        fwd = max(r["moe_forward_max_abs_diff"] for r in ranks)
        failures = [what for ok, what in (
            (np.all(routed.sum(1) == TRAIN_BATCH * (SLICE["max_len"] - 1)),
             f"tokens a expert {routed.tolist()}"),
            (fwd <= 1e-5, f"ExpertParallelMoE forward {fwd} from its oracle"),
            (dist <= DP_W2_CHAOS * yard,
             f"ExpertParallelMoE {dist} vs yardstick {yard}"),
            (r0["moe_losses"][-1] < r0["moe_losses"][0],
             "ExpertParallelMoE's loss did not fall")) if not ok]
        return {"tokens_per_s": TRAIN_BATCH * (SLICE["max_len"] - 1)
                / (sum(r0["step_ms"][1:]) / len(r0["step_ms"][1:])) * 1e3,
                "tokens_per_expert_by_moe_layer": routed.tolist(),
                "moe": {"forward_max_abs_diff_vs_oracle": fwd,
                        "losses": r0["moe_losses"],
                        "single_rank_losses": moe["losses"],
                        "params_rel_l2_vs_single_rank": dist,
                        "yardstick_rel_l2": yard}}, failures
    return _mp_phase("ep", EP["ranks"], "--ep-rank", single, checks, card,
                     t0, dict(EP, model=dict(MOE, block_size=None),
                              batch=TRAIN_BATCH, f32_rows=EP_F32_ROWS,
                              moe=EP_MOE, floor_perturb=EP_FLOOR_PERTURB),
                     update_bar=False)


# ---------------------------------------------------------------------------
# ui, streaming, nlp_text: the training UI, the streaming routes and the
# text modules on the card
# ---------------------------------------------------------------------------
UI = dict(batches=8, warmup=2, frequencies=(1, 10), lenet_batches=4,
          lenet_batch=64)
STREAMING = dict(messages=16, row=128, prompt=16, n_new=8)
NLP_TEXT = dict(bpe_vocab=512, steps=3, batch=TRAIN_BATCH,
                tfidf_epochs=20, tfidf_hidden=64, w2v_epochs=3,
                w2v_layer_size=32, w2v_copies=20)
NLP_TFIDF_TOL = 1e-5      # the classifier's output, card against the CPU
JA_TEXTS = ["私は日本語です", "カタカナとABC123", "東京 大阪", "機械学習",
            "今日は日本です", "私は東京で機械学習を勉強しています。",
            "ひらがなカタカナ漢字ABCdef123、テスト"]
KO_TEXTS = ["사람은", "나는", "나은", "학교에서 공부", "TPU는 빠르다123",
            "저는 학교에 갑니다", "책을 읽었다 그리고 친구가 왔다"]


class _Tee:
    """A stats router that hands every report to each of ``routers``
    (one listener, so one host copy a report, into two storages)."""

    def __init__(self, *routers):
        self.routers = routers

    def put_static_info(self, p):
        for r in self.routers:
            r.put_static_info(p)

    def put_update(self, p):
        for r in self.routers:
            r.put_update(p)


def _http(port, path, data=None, timeout=60):
    """(status, content type, body) of one loopback request."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _stored_records(st):
    """Every record of a stats storage, encoded, in query order."""
    out = []
    for s in st.list_session_ids():
        for t in st.list_type_ids(s):
            for w in st.list_worker_ids(s, t):
                info = st.get_static_info(s, t, w)
                out.append(None if info is None else info.encode())
                out.extend(p.encode()
                           for p in st.get_all_updates_after(s, t, w, -1))
    return out


def _summaries_now(named, cfg):
    """``_summary`` of each tensor of a ``[(name, {key: tensor})]`` tree,
    each fetched on its own in float64."""
    from deeplearning4j_tpu_torch.ui import stats
    return {name: {k: stats._summary(v.detach().double().cpu().numpy(), cfg)
                   for k, v in d.items()} for name, d in named if d}


def ui_charrnn(tmp, server, tries=5):
    """The full-width char-RNN through the fused loop with and without a
    StatsListener. Returns the phase's char-RNN record."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.ui import codec, stats, storage
    from deeplearning4j_tpu_torch.ui.server import RemoteUIStatsStorageRouter

    conf = zoo.char_rnn(vocab_size=CHARRNN["vocab_size"],
                        hidden=CHARRNN["hidden"],
                        tbptt_length=CHARRNN["tbptt_length"],
                        learning_rate=CHARRNN["learning_rate"])
    data, _ = markov_batches(UI["warmup"] + UI["batches"],
                             np.random.RandomState(SEED + 40))
    warm, timed = data[:UI["warmup"]], data[UI["warmup"]:]
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    net.fit(ListDataSetIterator(warm))           # captures the window graph
    torch.cuda.synchronize()
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]

    def turn(listener, profile):
        """One run of UI["batches"] batches with the counts set to 0 just
        before it and read just after: (ms a batch, the profile's LSTM
        kernels or None, the wrappers' counts)."""
        net.set_listeners([listener] if listener else [])
        try:
            for _ in range(tries):
                reset_launches()              # this path starts here
                if profile:
                    wall, names, _ = profiled(
                        lambda: net.fit(ListDataSetIterator(timed)))
                else:
                    t0 = time.perf_counter()
                    net.fit(ListDataSetIterator(timed))
                    torch.cuda.synchronize()
                    wall, names = time.perf_counter() - t0, None
                calls = read_lstm_launches()  # ... and ends here
                if names is None or names:
                    break
            else:
                raise AssertionError("torch.profiler recorded no device "
                                     f"event in {tries} runs")
        finally:
            net.set_listeners([])
        return (wall / UI["batches"] * 1e3,
                None if names is None else lstm_kernels(names), calls)

    # the StatsListener at frequency 1 into a file storage and, through
    # the remote router, into the UI server's storage
    remote = storage.InMemoryStatsStorage()
    server.attach(remote)
    fst = storage.FileStatsStorage(os.path.join(tmp, "stats.bin"))
    router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{server.port}")
    cfg = stats.StatsUpdateConfiguration()
    listener = stats.StatsListener(_Tee(fst, router), cfg,
                                   session_id="charrnn_ui")
    try:
        _, base_kernels, base_calls = turn(None, True)
        ms1, kernels1, calls1 = turn(listener, True)
        # the last report against the model's own tensors, fetched now
        last = fst.get_latest_update("charrnn_ui", stats.TYPE_ID, "single")
        want_params = _summaries_now(stats._named_params(net), cfg)
        want_grads = _summaries_now(stats._named_grads(net), cfg)
        params_equal = codec.encode(last.content["params"]) == \
            codec.encode(want_params)
        grads_equal = codec.encode(last.content["gradients"]) == \
            codec.encode(want_grads)
        router.flush()
        deadline = time.monotonic() + 60
        while (len(_stored_records(remote)) < len(_stored_records(fst))
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        router.close()
    reports = fst.get_all_updates_after("charrnn_ui", stats.TYPE_ID,
                                        "single", -1)
    remote_equal = _stored_records(remote) == _stored_records(fst)
    fst.close()
    mem = last.content["memory"]
    # unprofiled runs, the runs without a listener first and last
    ms = {"none": turn(None, False)[0]}
    for f in UI["frequencies"]:
        lst = stats.StatsListener(
            storage.InMemoryStatsStorage(),
            stats.StatsUpdateConfiguration(reporting_frequency=f),
            session_id=f"charrnn_f{f}")
        ms[f"frequency_{f}"] = turn(lst, False)[0]
    ms["none_again"] = turn(None, False)[0]
    bare = (ms["none"] + ms["none_again"]) / 2
    want_launches = (2 * windows * UI["batches"],
                     2 * CHARRNN["seq_len"] * UI["batches"])
    rec = {"config": dict(CHARRNN, path="the fused loop"),
           "batches": UI["batches"], "reports": len(reports),
           "updates": UI["batches"] * windows,
           "kernel_launches": {"lstm_cell_fwd": kernels1[0],
                               "lstm_cell_bwd": kernels1[1],
                               "counted_by": "torch.profiler, the run "
                               "with the listener"},
           "kernel_launches_without_listener": {
               "lstm_cell_fwd": base_kernels[0],
               "lstm_cell_bwd": base_kernels[1]},
           "wrapper_calls": {"with_listener": list(calls1),
                             "without": list(base_calls)},
           "ms_per_batch": ms, "ms_per_batch_profiled_frequency_1": ms1,
           "listener_ms_per_batch": {
               k: v - bare for k, v in ms.items()
               if k.startswith("frequency")},
           "last_report_params_equal": params_equal,
           "last_report_gradients_equal": grads_equal,
           "memory": {k: mem[k] for k in sorted(mem)},
           "remote_records": len(_stored_records(remote)),
           "remote_equal_file": remote_equal,
           "remote_dropped": router.dropped}
    # a replay calls no wrapper: the profile counts the kernels, the same
    # with and without the listener
    assert kernels1 == base_kernels == want_launches, rec
    assert calls1 == base_calls == (0, 0), rec
    assert len(reports) == UI["batches"] * windows, rec
    assert params_equal and grads_equal, rec
    assert 0 < mem["device0_bytes_in_use"] <= mem["device0_bytes_limit"], rec
    assert remote_equal and router.dropped == 0, rec
    return rec


def ui_lenet(server):
    """LeNet on the fixture's digits with a ConvolutionalIterationListener
    into the UI server's storage: the served PNG against the CPU port's
    grid from the same parameters. Returns (record, the net)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.ui import conv_listener, storage
    from deeplearning4j_tpu_torch.utils.pngio import decode_png

    train, _, feats, labels = lenet_images()
    n = UI["lenet_batches"] * UI["lenet_batch"]
    st = storage.InMemoryStatsStorage()
    server.attach(st)
    probe = train.features[:1]
    net = MultiLayerNetwork(zoo.lenet_mnist(), device=DEVICE).init()
    net.set_listeners([conv_listener.ConvolutionalIterationListener(
        st, probe, frequency=1, session_id="lenet_ui")])
    net.fit(ArrayDataSetIterator(feats[:n], labels[:n], UI["lenet_batch"]))
    net.set_listeners([])
    status, ctype, body = _http(server.port,
                                "/train/activations?sessionId=lenet_ui")
    assert status == 200 and ctype == "image/png", (status, ctype)
    got = decode_png(body).astype(np.int64)
    cpu = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    cpu.set_params(net.params())
    maps = conv_listener.ConvolutionalIterationListener(
        storage.InMemoryStatsStorage(), probe)._conv_activation(cpu)
    want = conv_listener.activations_to_grid(maps).astype(np.int64)
    grey = int(np.abs(got - want).max()) if got.shape == want.shape else None
    rec = {"config": "zoo.lenet_mnist on tests/fixtures/real_mnist",
           "batches": UI["lenet_batches"], "batch": UI["lenet_batch"],
           "reports": len(st.get_all_updates_after(
               "lenet_ui", conv_listener.TYPE_ID, "worker_0", -1)),
           "png_bytes": len(body), "grid_shape": list(got.shape),
           "max_grey_level_diff_vs_cpu": grey}
    assert grey is not None and grey <= 1, rec
    assert rec["reports"] == net.iteration == UI["lenet_batches"], rec
    return rec, net


UI_GETS = ["/", "/train", "/train/overview", "/train/sessions", "/metrics",
           "/train/metrics/data", "/serve/data",
           "/train/overview/data?sessionId=charrnn_ui",
           "/train/model/data?sessionId=charrnn_ui",
           "/train/system/data?sessionId=charrnn_ui",
           "/train/histogram/data?sessionId=charrnn_ui",
           "/train/flow/data?sessionId=charrnn_ui",
           "/train/tsne/data", "/train/activations",
           "/train/activations?sessionId=lenet_ui"]


def phase_ui(card):
    """The training UI on the card (the module docstring's phase 29)."""
    import tempfile
    from deeplearning4j_tpu_torch.ui.server import UIServer
    t0 = time.perf_counter()
    server = UIServer(port=0).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            charrnn = ui_charrnn(tmp, server)
        lenet, net = ui_lenet(server)
        statuses = {p: _http(server.port, p)[0] for p in UI_GETS}
    finally:
        server.stop()
    rec = {"phase": "ui", "charrnn": charrnn, "lenet": lenet,
           "get_statuses": statuses, "card": card,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    assert set(statuses.values()) == {200}, statuses
    rec["lenet_net"] = net
    return rec


def phase_streaming(card, lenet):
    """The serve route and the HTTP server on the card (the module
    docstring's phase 30); ``lenet``: phase ``ui``'s LeNet."""
    import json as _json
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.streaming import (
        DL4JServeRoute, InferenceHTTPServer, MessageBroker, TopicConsumer,
        TopicPublisher, deserialize_array, serialize_array)
    t0 = time.perf_counter()
    c = STREAMING
    conf = TransformerConfig(**SLICE)
    lm = TransformerLM(conf, device=DEVICE).init()
    rng = np.random.RandomState(SEED + 41)
    rows = rng.randint(0, conf.vocab_size,
                       (c["messages"], 1, c["row"])).astype(np.int32)
    lat, preds = [], []
    with MessageBroker() as broker:
        with DL4JServeRoute(lm, "127.0.0.1", broker.port) as route, \
                TopicConsumer("127.0.0.1", broker.port, "dl4j-out",
                              timeout=300) as out, \
                TopicPublisher("127.0.0.1", broker.port, "dl4j-in") as pub:
            pub.publish(serialize_array(rows[0]))       # warm-up
            out.poll()
            torch.cuda.synchronize()
            reset_launches()                  # the route's path starts here
            t_run = time.perf_counter()
            for r in rows:
                t_msg = time.perf_counter()
                pub.publish(serialize_array(r))
                preds.append(deserialize_array(out.poll()))
                lat.append(time.perf_counter() - t_msg)
            wall = time.perf_counter() - t_run
            pub.publish(b"poison!")
            deadline = time.monotonic() + 60
            while route.errors < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            launches = read_launches()        # ... and ends here
            served, errors, last_error = route.served, route.errors, \
                route.last_error
    bitwise = all(np.array_equal(p, lm.output(r)) for p, r in zip(preds, rows))
    route_rec = {"messages": c["messages"], "tokens_per_message": c["row"],
                 "served": served, "errors": errors,
                 "last_error": repr(last_error),
                 "messages_per_s": c["messages"] / wall,
                 "latency_s_p50": float(np.percentile(lat, 50)),
                 "latency_s_p99": float(np.percentile(lat, 99)),
                 "prediction_bytes": int(preds[0].nbytes),
                 "kernel_launches": dict(zip(FLASH, launches)),
                 "predictions_bitwise_output": bitwise}
    # the HTTP server: /predict on phase ui's LeNet, /generate on the LM
    x = np.random.RandomState(SEED + 42).rand(8, 28, 28, 1).astype(
        np.float32)
    prompt = rng.randint(0, conf.vocab_size, (1, c["prompt"])).astype(
        np.int32)
    with InferenceHTTPServer(lenet) as srv:
        s_pred, _, body = _http(srv.port, "/predict", serialize_array(x))
        pred = deserialize_array(body) if s_pred == 200 else None
    with InferenceHTTPServer(lm) as srv:
        s_gen, _, gbody = _http(srv.port, "/generate", _json.dumps(
            {"prompt": prompt.tolist(), "n_new": c["n_new"],
             "temperature": 0.0}).encode(), timeout=300)
        s_bad, _, bad = _http(srv.port, "/generate", b"garbage")
        http_errors = srv.errors
    gen = np.asarray(_json.loads(gbody)["tokens"]) if s_gen == 200 else None
    want_gen = lm.generate(prompt, c["n_new"], temperature=0.0)
    http_rec = {"predict_status": s_pred,
                "predict_bitwise_output": pred is not None and bool(
                    np.array_equal(pred, lenet.output(x))),
                "generate_status": s_gen,
                "generate_equals_direct": gen is not None and bool(
                    np.array_equal(gen, want_gen)),
                "garbage_status": s_bad, "garbage_body": bad.decode()[:120],
                "errors": http_errors}
    rec = {"phase": "streaming", "config": SLICE, "route": route_rec,
           "http": http_rec, "card": card,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    assert bitwise and served == c["messages"] + 1, rec
    assert errors == 1 and isinstance(last_error, ValueError) \
        and "magic" in str(last_error), rec
    assert launches == (c["messages"] * conf.n_layers, 0, 0), rec
    assert http_rec["predict_bitwise_output"], rec
    assert http_rec["generate_equals_direct"], rec
    assert s_bad == 400 and http_errors == 1, rec
    return rec


def nlp_lm(ids, vocab_size, rng):
    """The slice's LM at the BPE vocabulary, trained on rows of ``ids``:
    one warm-up and NLP_TEXT["steps"] timed ``fit_batch`` steps at batch
    32 x 512, then the f32 two-layer check card against CPU on 2 rows."""
    import math
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    c = NLP_TEXT
    conf = TransformerConfig(**dict(SLICE, vocab_size=vocab_size))
    t = conf.max_len
    starts = rng.randint(0, len(ids) - t, (c["steps"] + 1, c["batch"]))
    batches = [torch.from_numpy(ids[s[:, None] + np.arange(t)]).to(DEVICE)
               for s in starts]
    lm = TransformerLM(conf, device=DEVICE).init()
    losses = [float(lm.fit_batch(batches[0]))]
    torch.cuda.synchronize()
    reset_launches()                          # the LM's path starts here
    t0 = time.perf_counter()
    scores = [lm.fit_batch(b) for b in batches[1:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                # ... and ends here
    losses += [float(s) for s in scores]
    rows = ids[rng.randint(0, len(ids) - CPU_CHECK_T - 1, 2)[:, None]
               + np.arange(CPU_CHECK_T + 1)]
    rec = {"vocab_size": conf.vocab_size, "batch": c["batch"],
           "tokens_per_row": t, "steps": c["steps"], "losses": losses,
           "step_ms": wall / c["steps"] * 1e3,
           "tokens_per_s": c["batch"] * (t - 1) * c["steps"] / wall,
           "kernel_launches": dict(zip(FLASH, launches))}
    del lm, batches
    torch.cuda.empty_cache()
    rec["f32_card_vs_cpu"] = train_card_vs_cpu(conf, rng,
                                               torch.from_numpy(rows))
    assert all(math.isfinite(x) for x in losses), rec
    assert losses[-1] < losses[0], rec
    assert launches == (c["steps"] * conf.n_layers,) * 3, rec
    return rec


def nlp_tfidf():
    """TF-IDF vectors of the treebank fixture's sentences (labelled by
    whether the gold tree holds a PP) through a dense classifier on the
    card and on the CPU from the same parameters."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nlp import trees
    from deeplearning4j_tpu_torch.nlp.vectorizer import TfidfVectorizer
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    with open(_repo_path("tests", "fixtures", "mini_treebank.txt")) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    sents = [" ".join(trees.Tree.from_bracket(ln).yield_()) for ln in lines]
    tv = TfidfVectorizer().fit(sents)
    x = tv.transform_documents(sents)
    y = np.eye(2, dtype=np.float32)[[int("(PP" in ln) for ln in lines]]
    conf = (NeuralNetConfiguration.Builder().seed(SEED + 43)
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_in=x.shape[1], n_out=NLP_TEXT["tfidf_hidden"],
                              activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .build())
    card = MultiLayerNetwork(conf, device=DEVICE).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.set_params(card.params())
    for _ in range(NLP_TEXT["tfidf_epochs"]):
        for net in (card, cpu):
            net.fit(DataSet(x, y))
    got, want = card.output(x), cpu.output(x)
    err = float(np.abs(got - want).max())
    rec = {"sentences": len(sents), "vocabulary": tv.vocab.num_words(),
           "epochs": NLP_TEXT["tfidf_epochs"],
           "train_accuracy": float((got.argmax(1) == y.argmax(1)).mean()),
           "card_vs_cpu_max_abs_err": err}
    assert np.isfinite(got).all() and err <= NLP_TFIDF_TOL, rec
    return rec


def nlp_word2vec():
    """Word2Vec on the card over the Japanese and the Korean tokenizers'
    streams, and TreeVectorizer with the Japanese one as its lookup."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp import trees
    from deeplearning4j_tpu_torch.nlp.japanese import JapaneseTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.korean import KoreanTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    c = NLP_TEXT
    rec, models = {}, {}
    for lang, factory, texts in (("japanese", JapaneseTokenizerFactory(),
                                  JA_TEXTS),
                                 ("korean", KoreanTokenizerFactory(),
                                  KO_TEXTS)):
        corpus = texts * c["w2v_copies"]
        w2v = Word2Vec(tokenizer_factory=factory,
                       layer_size=c["w2v_layer_size"], window=2,
                       min_word_frequency=1, epochs=c["w2v_epochs"],
                       batch_size=64, seed=SEED + 44, device=DEVICE)
        t0 = time.perf_counter()
        w2v.fit_corpus(corpus)
        seconds = time.perf_counter() - t0
        tokens = {tok for text in corpus
                  for tok in factory.create(text).get_tokens()}
        table = w2v.lookup_table.all_vectors()
        rec[lang] = {"sentences": len(corpus), "vocabulary": len(tokens),
                     "fit_s": seconds,
                     "vocab_equals_tokenizer":
                         set(w2v.vocab.words()) == tokens,
                     "table_finite": bool(np.isfinite(table).all())}
        assert rec[lang]["vocab_equals_tokenizer"] and \
            rec[lang]["table_finite"], rec
        models[lang] = w2v
    w2v = models["japanese"]
    table = w2v.lookup_table.all_vectors()
    tv = trees.TreeVectorizer(lookup=w2v)
    leaves = [leaf for t in tv.get_trees(" ".join(JA_TEXTS))
              for leaf in t.leaves()]
    attached = 0
    for leaf in leaves:
        i = w2v.vocab.index_of(leaf.value)
        if i < 0:
            assert leaf.vector is None, leaf.value
        else:
            assert np.array_equal(leaf.vector, table[i]), leaf.value
            attached += 1
    rec["tree_vectorizer"] = {"leaves": len(leaves),
                              "vectors_attached": attached}
    assert attached >= 3, rec
    return rec


def phase_nlp_text(card):
    """The text modules feeding models on the card (the module
    docstring's phase 31)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.bpe import BpeTokenizer
    t0 = time.perf_counter()
    with open(_repo_path("SURVEY.md")) as f:
        text = f.read()
    t_bpe = time.perf_counter()
    bpe = BpeTokenizer.train(text.splitlines(),
                             vocab_size=NLP_TEXT["bpe_vocab"])
    bpe_s = time.perf_counter() - t_bpe
    ids = np.asarray(bpe.encode(text), np.int64)
    assert bpe.decode(bpe.encode("the port")) == "the port"
    rec = {"phase": "nlp_text", "card": card,
           "bpe": {"corpus": "SURVEY.md", "chars": len(text),
                   "vocab_size": bpe.vocab_size(), "merges": len(bpe.merges),
                   "ids": int(ids.size), "train_s": bpe_s}}
    rng = np.random.RandomState(SEED + 45)
    rec["lm"] = nlp_lm(ids, bpe.vocab_size(), rng)
    rec["tfidf"] = nlp_tfidf()
    rec["word2vec"] = nlp_word2vec()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# watch: the runtime watchers over the card's serving and char-RNN paths
# ---------------------------------------------------------------------------
WATCH = dict(generations=8, temperature=0.8, prompt=32, n_new=16, slots=8,
             chunk=8, messages=4, row=128, charrnn_warmup=2,
             charrnn_batches=4, fuse_k=4, mln=(256, 512, 10),
             mln_batch=64, mln_batches=2, cost_turns=3, cost_groups=3,
             cost_request_copies=2, budget_s=90.0)

# (e)'s configurations: the watchers installed in each cost turn
WATCH_COST_CONFIGS = {
    "bare": (),
    "watched": ("lockwatch", "leakwatch", "compilewatch", "rngwatch"),
    "lockwatch_only": ("lockwatch",)}


def _fixture(*parts):
    """A module of ``tests/fixtures`` loaded by its path: the JAX
    package's lockwatch and leakwatch fixtures import nothing of either
    package, the torch fixtures only the port. Returns (module, path)."""
    import importlib.util
    path = _repo_path("tests", "fixtures", *parts)
    name = "watch_fixture_" + "_".join(parts).replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def _watchers(on, which=WATCH_COST_CONFIGS["watched"]):
    """Install (``on``) or uninstall the port's runtime watchers named in
    ``which``, then drop the device locks (no program runs meanwhile).
    The next program makes its device's RLock anew: watched when
    lockwatch is installed, raw when it is not. A lock made under
    lockwatch stays wrapped after ``uninstall()`` and would keep its
    bookkeeping on every later replay and capture."""
    import importlib
    from deeplearning4j_tpu_torch.models import _cuda_graph
    for name in which:
        w = importlib.import_module("deeplearning4j_tpu_torch.testing."
                                    + name)
        (w.install if on else w.uninstall)()
    with _cuda_graph._LOCK:
        _cuda_graph._DEVICE_LOCKS.clear()


def watch_serve_turn(lm, rows):
    """One InferenceServer over ``lm`` (made, warmed and stopped here)
    answering ``rows`` as concurrent requests, the flash counts set to 0
    just before the requests and read just after: (requests/s, the
    served rows, the batches ``output()`` ran as (tokens, logits), the
    (forward, dQ, dK/dV) launches)."""
    import torch
    from deeplearning4j_tpu_torch.serving import InferenceServer
    srv = InferenceServer(lm, buckets=(BUCKET,), device=DEVICE)
    batches = []
    served_output = lm.output

    def recording_output(x):
        y = served_output(x)
        batches.append((x, y))
        return y
    lm.output = recording_output
    try:
        srv.warm_start([(rows[0].size,)])
        torch.cuda.synchronize()
        del batches[:]
        reset_launches()                       # the main path starts here
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(rows)) as pool:
            served = list(pool.map(lambda x: srv.infer(x, timeout=600),
                                   rows))
        wall = time.perf_counter() - t0
        launches = read_launches()             # ... and ends here
    finally:
        srv.stop()
        del lm.output                          # back to the class method
    return len(rows) / wall, served, batches, launches


def watch_decode_turn(lm, prompts, steady=None):
    """A ContinuousLM over ``lm``: ``warm_start()``, then the sampled
    generations (temperature WATCH["temperature"], seed i for prompt i)
    as concurrent submits, inside ``steady`` if given. Returns (the
    decode inventory, the slot pool's budget, tokens/s, the rows)."""
    import torch
    from deeplearning4j_tpu_torch.serving import ContinuousLM
    srv = ContinuousLM(lm, slots=WATCH["slots"], chunk=WATCH["chunk"],
                       device=DEVICE)
    try:
        srv.warm_start()
        torch.cuda.synchronize()
        inventory = srv.graph_inventory()
        budget = 3 * len(srv._kv_ladder) + 2 * len(srv._prefill_ladder) + 1
        with steady() if steady else nullcontext():
            t0 = time.perf_counter()
            futs = [srv.submit(p, WATCH["n_new"],
                               temperature=WATCH["temperature"], seed=i)
                    for i, p in enumerate(prompts)]
            rows = [f.result(300) for f in futs]
            wall = time.perf_counter() - t0
    finally:
        srv.stop()
    return inventory, budget, len(prompts) * WATCH["n_new"] / wall, rows


def watch_route(lm, rows):
    """The phase-``streaming`` serve route over ``lm`` answering ``rows``
    (after a warm-up message), shut down: whether each prediction is
    ``output()`` of its message, bitwise, and the messages served."""
    import numpy as np
    from deeplearning4j_tpu_torch.streaming import (
        DL4JServeRoute, MessageBroker, TopicConsumer, TopicPublisher,
        deserialize_array, serialize_array)
    preds = []
    with MessageBroker() as broker:
        with DL4JServeRoute(lm, "127.0.0.1", broker.port) as route, \
                TopicConsumer("127.0.0.1", broker.port, "dl4j-out",
                              timeout=300) as out, \
                TopicPublisher("127.0.0.1", broker.port, "dl4j-in") as pub:
            pub.publish(serialize_array(rows[0]))       # warm-up
            out.poll()
            for r in rows:
                pub.publish(serialize_array(r))
                preds.append(deserialize_array(out.poll()))
            served = route.served
    bitwise = all(np.array_equal(p, lm.output(r)) for p, r in zip(preds, rows))
    return bitwise, served


def watch_charrnn_turn(net, data, steady=None, profile=False):
    """``net.fit`` over ``data`` (one fused group of WATCH["fuse_k"]),
    inside ``steady`` if given, the LSTM counts set to 0 just before and
    read just after: (ms a batch, the profile's (sequence, backward)
    kernels or None, the wrappers' counts)."""
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    with steady() if steady else nullcontext():
        reset_launches()                       # this path starts here
        if profile:
            wall, names, _ = profiled(
                lambda: net.fit(ListDataSetIterator(data)))
            kernels = lstm_kernels(names)
        else:
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator(data))
            torch.cuda.synchronize()
            wall, kernels = time.perf_counter() - t0, None
        calls = read_lstm_launches()           # ... and ends here
    return wall / len(data) * 1e3, kernels, calls


def _watch_mln():
    """A small MLN with dropout (WATCH["mln"]: inputs, hidden, classes),
    its data: the fused loop's masks come from the device draw counter."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn import layers as players
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    n_in, hidden, n_out = WATCH["mln"]
    conf = (NeuralNetConfiguration.Builder().seed(SEED + 50)
            .learning_rate(0.05).updater("sgd").list()
            .layer(players.DenseLayer(n_in=n_in, n_out=hidden,
                                      activation="relu", dropout=0.5))
            .layer(players.OutputLayer(n_out=n_out, activation="softmax",
                                       loss="mcxent"))
            .build())
    rng = np.random.RandomState(SEED + 50)
    data = [DataSet(rng.randn(WATCH["mln_batch"], n_in).astype(np.float32),
                    np.eye(n_out, dtype=np.float32)[
                        rng.randint(0, n_out, WATCH["mln_batch"])])
            for _ in range(WATCH["mln_batches"])]
    return MultiLayerNetwork(conf, device=DEVICE).init(), data


def watch_controls(tmp):
    """Phase watch (d): each watcher catches its defect on the card's
    process at the fixture's line, and each clean twin stays clean.
    Returns the record; the watchers are installed and reset here."""
    import threading
    import warnings
    import torch
    from deeplearning4j_tpu_torch.testing import (compilewatch, leakwatch,
                                                  lockwatch, rngwatch)
    rec = {}
    # lockwatch: the reference's inversion fixture
    lockwatch.reset()
    inv_mod, inv_path = _fixture("lockwatch", "inversion.py")
    inv = inv_mod.Inverted()
    inv.forward()
    clean = len(lockwatch.violations())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inv.backward()
    rec["lockwatch"] = {"clean_twin_violations": clean, "caught": [
        [os.path.relpath(s.rsplit(":", 1)[0], _repo_path()) + ":"
         + s.rsplit(":", 1)[1] for s in v["locks"]]
        for v in lockwatch.violations()]}
    lockwatch.reset()
    # leakwatch: the reference's leak fixture
    leaky, _ = _fixture("leakwatch", "leaky.py")
    src = os.path.join(tmp, "src.txt")
    with open(src, "w") as f:
        f.write("hello\n")
    snap = leakwatch.snapshot()
    leaky.copy_first_line(src, os.path.join(tmp, "dst.txt"))
    leaky.open_socket().close()
    evt = threading.Event()
    t = leaky.start_waiter(evt)
    evt.set()
    t.join(5)
    clean = len(leakwatch.live(since=snap))
    snap = leakwatch.snapshot()
    try:
        leaky.copy_first_line(os.path.join(tmp, "missing.txt"),
                              os.path.join(tmp, "dst2.txt"))
    except OSError as e:
        err = e
    sock = leaky.open_socket()
    evt = threading.Event()
    t = leaky.start_waiter(evt)
    caught = sorted([r.kind, os.path.relpath(r.site.rsplit(":", 1)[0],
                                             _repo_path())
                     + ":" + r.site.rsplit(":", 1)[1]]
                    for r in leakwatch.live(since=snap))
    sock.close()
    evt.set()
    t.join(5)
    err.__traceback__.tb_next.tb_frame.f_locals["out"].close()
    del err
    rec["leakwatch"] = {"clean_twin_live": clean, "caught": caught,
                        "live_after_release": len(leakwatch.live(
                            since=snap))}
    leakwatch.reset()
    # compilewatch: a StaticGraph built anew on every call
    recap, recap_path = _fixture("torch_watch", "recapture.py")
    compilewatch.extend_watch_paths(recap_path)
    d = recap.Doubler(DEVICE)
    d.reuse()                                  # captures once: warm-up
    snap = compilewatch.snapshot()
    with compilewatch.steady():
        d.reuse()
        d.reuse()
    clean = len(compilewatch.events(since=snap))
    snap = compilewatch.snapshot()
    with compilewatch.steady():
        d.rebuild_each_call()
        d.rebuild_each_call()
    torch.cuda.synchronize()
    right = bool(torch.equal(d.y, d.x * 2))
    try:
        compilewatch.assert_clean(since=snap)
        raised = False
    except AssertionError:
        raised = True
    rec["compilewatch"] = {
        "clean_twin_events": clean,
        "caught": compilewatch.counts_by_family(since=snap),
        "steady_gate_raised": raised, "values_right": right}
    compilewatch.reset()
    # rngwatch: a CUDA generator's state drawn twice
    rngw, _ = _fixture("torch_watch", "rng_reuse.py")
    rngwatch.reset()
    rngw.draw_on(device=DEVICE)
    rngw.two_models_one_seed(device=DEVICE)
    clean = len(rngwatch.violations())
    rngw.draw_twice(device=DEVICE)
    rec["rngwatch"] = {"clean_twins_violations": clean, "caught": [
        [os.path.relpath(v["first"][1][0], _repo_path()) + ":"
         + str(v["first"][1][1]),
         os.path.relpath(v["second"][1][0], _repo_path()) + ":"
         + str(v["second"][1][1])] for v in rngwatch.violations()]}
    rngwatch.reset()
    return rec


def _watch_control_holds(ctl):
    """The positive controls' holds: each defect at its fixture line."""
    def at(parts, text, offset=0):
        path = _repo_path("tests", "fixtures", *parts)
        with open(path) as f:
            lines = f.read().splitlines()
        hit, = [i + 1 for i, line in enumerate(lines) if text in line]
        return "/".join(("tests", "fixtures") + parts) + f":{hit + offset}"
    inv = ("lockwatch", "inversion.py")
    leak = ("leakwatch", "leaky.py")
    rec = ("torch_watch", "recapture.py")
    rng = ("torch_watch", "rng_reuse.py")
    assert ctl["lockwatch"] == {"clean_twin_violations": 0, "caught": [
        [at(inv, "self._beta_lock = threading.Lock()"),
         at(inv, "self._alpha_lock = threading.Lock()")]]}, ctl
    assert ctl["leakwatch"] == {"clean_twin_live": 0, "caught": [
        ["file", at(leak, "out = open(dst")],
        ["socket", at(leak, "s = socket.socket()")],
        ["thread", at(leak, "t = threading.Thread(")]],
        "live_after_release": 0}, ctl
    assert ctl["compilewatch"] == {
        "clean_twin_events": 0,
        "caught": {at(rec, "StaticGraph(self._run, self.device)()"): 2},
        "steady_gate_raised": True, "values_right": True}, ctl
    # draw_twice: the draw after get_state(), then the one after set_state()
    assert ctl["rngwatch"] == {"clean_twins_violations": 0, "caught": [
        [at(rng, "state = g.get_state()", 1),
         at(rng, "# the same state")]]}, ctl


def phase_watch(card):
    """The runtime watchers on the card (the module docstring's phase
    32): (a) lockwatch and leakwatch over InferenceServer, ContinuousLM
    and the serve route at the slice's width; (b) compilewatch over the
    decode pool's warm-up and steady generations and over the char-RNN's
    fused fit; (c) rngwatch over (a)'s sampled generations and a dropout
    MLN's fused and per-batch steps; (d) each watcher's positive control;
    (e) the watchers' cost on serving, decode and the char-RNN."""
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.testing import (compilewatch, leakwatch,
                                                  lockwatch, rngwatch)
    t0 = time.perf_counter()
    conf = TransformerConfig(**SLICE)
    lm = TransformerLM(conf, device=DEVICE).init()
    rng = np.random.RandomState(SEED + 60)
    rows = [rng.randint(0, conf.vocab_size, conf.max_len).astype(np.int32)
            for _ in range(N_REQUESTS)]
    prompts = [rng.randint(1, conf.vocab_size, WATCH["prompt"]).astype(
        np.int32) for _ in range(WATCH["generations"])]
    messages = rng.randint(0, conf.vocab_size, (WATCH["messages"], 1,
                                                WATCH["row"])).astype(
        np.int32)
    cr_conf = zoo.char_rnn(vocab_size=CHARRNN["vocab_size"],
                           hidden=CHARRNN["hidden"],
                           tbptt_length=CHARRNN["tbptt_length"],
                           learning_rate=CHARRNN["learning_rate"])
    cr_data, _ = markov_batches(WATCH["charrnn_warmup"]
                                + WATCH["charrnn_batches"],
                                np.random.RandomState(SEED + 61))
    warm, timed = (cr_data[:WATCH["charrnn_warmup"]],
                   cr_data[WATCH["charrnn_warmup"]:])
    windows = CHARRNN["seq_len"] // CHARRNN["tbptt_length"]
    fuse_k = mock.patch.dict(os.environ, {
        "DL4J_TORCH_FUSE_STEPS": str(WATCH["fuse_k"])})
    rec = {"phase": "watch", "config": dict(WATCH, slice=SLICE,
                                            charrnn=CHARRNN), "card": card}

    _watchers(True)
    try:
        for w in (lockwatch, compilewatch, rngwatch):
            w.reset()
        leak_snap = leakwatch.snapshot()
        cw_snap = compilewatch.snapshot()
        # (a) serving
        rps, served, batches, launches = watch_serve_turn(lm, rows)
        max_err = 0.0
        for x, y in batches:
            max_err = max(max_err, float(np.abs(lm.output(x) - y).max()))
        for tok, got in zip(rows, served):
            hits = [y[j] for x, y in batches for j in range(len(x))
                    if np.array_equal(x[j], tok)]
            assert hits, "a served row came from no dispatched batch"
            max_err = max(max_err, float(np.abs(got - hits[0]).max()))
        cw_warm = compilewatch.snapshot()
        inventory, budget, dec_tps, gen_rows = watch_decode_turn(
            lm, prompts, steady=compilewatch.steady)
        decode_families = compilewatch.counts_by_family(since=cw_warm)
        steady_events = [e.describe() for e in compilewatch.events(
            since=cw_warm) if e.steady]
        route_bitwise, route_served = watch_route(lm, list(messages))
        # (b) the char-RNN: warm-up (captures the window graph), then the
        # steady group, profiled: a replay calls no wrapper
        with fuse_k:
            net = MultiLayerNetwork(cr_conf, device=DEVICE).init()
            cw_cr = compilewatch.snapshot()
            watch_charrnn_turn(net, warm)
            cr_families = compilewatch.counts_by_family(since=cw_cr)
            cw_cr_steady = compilewatch.snapshot()
            _, cr_kernels, cr_calls = watch_charrnn_turn(
                net, timed, steady=compilewatch.steady, profile=True)
            cr_ms_watched = watch_charrnn_turn(
                net, timed, steady=compilewatch.steady)[0]
            cr_steady_events = len(compilewatch.events(since=cw_cr_steady))
        # (c) a dropout MLN: 2 fused batches, then 2 per batch
        mln, mln_data = _watch_mln()
        from deeplearning4j_tpu_torch.datasets.dataset import (
            ListDataSetIterator)
        with mock.patch.dict(os.environ, {"DL4J_TORCH_FUSE_STEPS": str(
                WATCH["mln_batches"])}):
            mln.fit(ListDataSetIterator(mln_data))
        with mock.patch.dict(os.environ, {"DL4J_TORCH_FUSE_STEPS": "1"}):
            mln.fit(ListDataSetIterator(mln_data))
        torch.cuda.synchronize()
        del net, mln
        # the gates, every server and route shut down
        leaks = [r.describe() for r in leakwatch.live(since=leak_snap)]
        edges = lockwatch.edges()
        repo = _repo_path()
        def label(site):
            path, line = site.rsplit(":", 1)
            return (os.path.relpath(path, repo) if path.startswith(repo)
                    else path) + ":" + line
        edge_labels = sorted([label(a), label(b)] for a, b in edges)
        graph_lock_edges = [e for e in edge_labels
                            if any("_cuda_graph.py" in s for s in e)]
        rec["gates"] = {
            "lock_inversions": len(lockwatch.violations()),
            "lock_edges": len(edges),
            "lock_edge_sites": edge_labels[:50],
            "lock_edges_with_the_graph_lock": graph_lock_edges,
            "live_after_shutdown": leaks,
            "leak_sites_observed": len(leakwatch.observed_sites()),
            "steady_events": steady_events,
            "charrnn_steady_events": cr_steady_events,
            "rng_violations": len(rngwatch.violations()),
            "rng_consumptions": rngwatch.consumptions(),
            "rng_skipped_in_capture": rngwatch.skipped(),
            "rng_generations": len(rngwatch.generations())}
        lock_report = lockwatch.report()
        rng_report = rngwatch.report()
        cw_all = compilewatch.counts_by_family(since=cw_snap)
        # (d) positive controls
        with tempfile.TemporaryDirectory() as tmp:
            controls = watch_controls(tmp)
    finally:
        _watchers(False)
        for w in (lockwatch, leakwatch, compilewatch, rngwatch):
            w.reset()
    watched_s = time.perf_counter() - t0

    # (e) cost: turns of each configuration of WATCH_COST_CONFIGS in
    # rotation after the gated run; each turn makes its own servers (a
    # lock is watched when it is made under lockwatch), serves
    # WATCH["cost_request_copies"] copies of the requests and fits
    # WATCH["cost_groups"] groups
    turns = {k: {"serving": [], "decode": [], "charrnn": []}
             for k in WATCH_COST_CONFIGS}
    cost_rows = rows * WATCH["cost_request_copies"]
    with fuse_k:
        net = MultiLayerNetwork(cr_conf, device=DEVICE).init()
        watch_charrnn_turn(net, warm)
        for _ in range(WATCH["cost_turns"]):
            for key, which in WATCH_COST_CONFIGS.items():
                _watchers(True, which)
                try:
                    turns[key]["serving"].append(
                        watch_serve_turn(lm, cost_rows)[0])
                    turns[key]["charrnn"].append(watch_charrnn_turn(
                        net, timed * WATCH["cost_groups"])[0])
                    turns[key]["decode"].append(
                        watch_decode_turn(lm, prompts)[2])
                finally:
                    _watchers(False)
                    for w in (lockwatch, leakwatch, compilewatch, rngwatch):
                        w.reset()
    del net

    def cost(part, rate):
        """Each configuration's turns, mean and range, its cost against
        the bare turns' mean (the rate's fall, or the time's rise), and
        the bare turns' own spread, (max - min) / mean: a cost inside
        that spread is not resolved by this many turns."""
        bare = np.mean(turns["bare"][part])
        out = {"bare_spread": float(np.ptp(turns["bare"][part]) / bare)}
        for key in WATCH_COST_CONFIGS:
            got = turns[key][part]
            mean = float(np.mean(got))
            out[key] = {"turns": got, "mean": mean, "min": min(got),
                        "max": max(got)}
            if key != "bare":
                out[key]["cost"] = bare / mean - 1 if rate \
                    else mean / bare - 1
        return out
    serve_cost = cost("serving", rate=True)
    dec_cost = cost("decode", rate=True)
    cr_cost = cost("charrnn", rate=False)
    cr_cost["gated_run_ms_per_batch"] = cr_ms_watched
    dec_cost["gated_run_tokens_per_s"] = dec_tps
    serve_cost["gated_run_requests_per_s"] = rps
    want_cr = (2 * windows * WATCH["charrnn_batches"],
               2 * CHARRNN["seq_len"] * WATCH["charrnn_batches"])
    inv = compilewatch.inventory()
    decode_site, = [f for f, what in inv.items()
                    if what == "capture: StaticGraph in _SlotPool.run"]
    layered, = [f for f, what in inv.items()
                if what == "capture: torch.cuda.graph in _WindowGraph.capture"]
    rec.update({
        "serving": {"requests": N_REQUESTS, "batches": len(batches),
                    "requests_per_s": rps,
                    "kernel_launches": dict(zip(FLASH, launches)),
                    "served_vs_output_max_abs_err": max_err},
        "decode": {"inventory_size": len(inventory), "budget": budget,
                   "warm_start_captures_by_family": decode_families,
                   "tokens_per_s": dec_tps,
                   "rows": len(gen_rows), "distinct_rows": len(
                       {tuple(r.tolist()) for r in gen_rows})},
        "route": {"messages": WATCH["messages"], "served": route_served,
                  "predictions_bitwise_output": route_bitwise},
        "charrnn": {"batches": WATCH["charrnn_batches"],
                    "fuse_k": WATCH["fuse_k"],
                    "warmup_captures_by_family": cr_families,
                    "kernel_launches": {
                        "lstm_cell_fwd": cr_kernels[0],
                        "lstm_cell_bwd": cr_kernels[1],
                        "counted_by": "torch.profiler, the steady run"},
                    "wrapper_calls": list(cr_calls)},
        "compile_events_by_family": cw_all,
        "controls": controls,
        "cost": {"serving_requests": len(cost_rows),
                 "serving_requests_per_s": serve_cost,
                 "decode_tokens_per_s": dec_cost,
                 "charrnn_ms_per_batch": cr_cost},
        "kernel_launches": {"flash_attn_fwd": launches[0],
                            "lstm_cell_fwd": cr_kernels[0],
                            "lstm_cell_bwd": cr_kernels[1]},
        "watched_seconds": watched_s,
        "seconds": time.perf_counter() - t0})
    emit(rec)
    g = rec["gates"]
    assert g["lock_inversions"] == 0, lock_report
    assert g["live_after_shutdown"] == [], g["live_after_shutdown"]
    assert max_err == 0.0, max_err
    assert rec["decode"]["distinct_rows"] == WATCH["generations"], \
        rec["decode"]
    assert launches == (conf.n_layers * len(batches), 0, 0) \
        and len(batches) > 0, (launches, len(batches))
    assert len(inventory) == budget and decode_families == {
        decode_site: budget}, (len(inventory), budget, decode_families)
    assert g["steady_events"] == [] and g["charrnn_steady_events"] == 0, g
    assert route_bitwise and route_served == WATCH["messages"] + 1, \
        rec["route"]
    # the warm-up's programs: the window graph (and, in a process that
    # has not launched them yet, the LSTM kernels' loads)
    assert cr_families.get(layered, 0) >= 1 and all(
        f == layered or f.startswith("load:lstm_cell_")
        for f in cr_families), cr_families
    assert tuple(cr_kernels) == want_cr and tuple(cr_calls) == (0, 0), \
        (cr_kernels, cr_calls, want_cr)
    assert g["rng_violations"] == 0, rng_report
    assert g["rng_consumptions"] > 0, g
    _watch_control_holds(controls)
    assert rec["seconds"] <= WATCH["budget_s"], rec["seconds"]
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
    at = phase_attention(card)
    ke = phase_keras(card)
    lp = phase_lm_persist(card)
    rr = phase_records(card)
    phase_glove(card)
    phase_deepwalk(card)
    phase_fused_autotune(card)
    phase_dropout_fused(card)
    gf = phase_graph_fused(card, cr)
    phase_solvers(card)
    phase_pretrain(card)
    tf = phase_transfer(card)
    phase_gradcheck(card)
    phase_tsne_kmeans(card)
    vt = phase_vit(card)
    mo = phase_moe(card)
    dp = phase_dp(card)
    so = phase_scaleout(card)
    el = phase_elastic(card)
    phase_shard_ckpt(card)
    phase_tp(card)
    pp = phase_pp(card)
    phase_sp(card)
    phase_ep(card)
    ui = phase_ui(card)
    st = phase_streaming(card, ui.pop("lenet_net"))
    nt = phase_nlp_text(card)
    wt = phase_watch(card)
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

    def vit_shape(name):
        """The kernel at phase vit's attention (n 768, T 196, d 64,
        non-causal), bf16 (the phase's) and f32: error, ms, bound, the
        twin's and the library's ms."""
        out = {}
        for dt in ("bfloat16", "float32"):
            f, b = kernels[("vit", dt)], kernels[("vit", dt, "bwd")]
            if name == "flash_attn_fwd":
                out[dt] = {"max_abs_err": f["max_abs_err"],
                           "ms": f["kernel_ms"], "bound_ms": f["bound_ms"],
                           "bound_by": f["bound_by"],
                           "plain_ms": f["plain_ms"],
                           "library_ms": f["library_ms"]}
                continue
            which = "dq" if name == "flash_attn_dq" else "dkv"
            grads = ("dq",) if which == "dq" else ("dk", "dv")
            out[dt] = {"max_abs_err": max(b["errors"][g]["max_abs_err"]
                                          for g in grads),
                       "ms": b[f"{which}_ms"],
                       "bound_ms": b[f"{which}_bound_ms"],
                       "bound_by": b[f"{which}_bound_by"],
                       "plain_ms": b["plain_bwd_ms"],
                       "library_ms": b["library_bwd_ms"]}
        return {"shape": kernels[("vit", "float32")]["shape"], **out}

    dp_flash = dict(zip(("flash_attn_fwd", "flash_attn_dq",
                         "flash_attn_dkv"),
                        dp["world1"]["lm"]["launches_sharded_runs"]))
    dp_lstm = dp["world1"]["charrnn"]["kernel_launches"]

    def dp_world2(name):
        """Rank 0's launches in phase dp's world 2 at level 3."""
        w = dp["world2"]
        tree = w["lm"] if name.startswith("flash") else w["charrnn"]
        return tree["levels"]["3"]["rank0"]["kernel_launches"][name]

    def new_callers(name):
        """Phases vit's, moe's, dp's and pp's launches (their timed steps;
        pp's a rank, a stage each) and the kernel at the ViT's shape."""
        return {"launches_vit": vt["kernel_launches"][name],
                "launches_moe": mo["kernel_launches"][name],
                "launches_nlp_text": nt["lm"]["kernel_launches"][name],
                "launches_dp": dp_flash[name],
                "launches_dp_world2_rank0": dp_world2(name),
                "launches_pp_by_rank": [r[name] for r in
                                        pp["flash_launches_by_rank"]],
                "vit_shape": vit_shape(name)}
    def scaleout_launches(name):
        """Phase scaleout's launches: the thread workers' timed run by
        the wrappers, and the process workers' own counts, summed."""
        return {"launches_scaleout": so["threads"]["lstm_launches"][name],
                "launches_scaleout_process": sum(
                    w[name] for w in so["processes"]["worker_kernel_launches"])}
    def elastic_launches(name):
        """Phase elastic's launches by the wrappers in its trainer
        processes: the kill case's survivor (every batch, at width 2 then
        1) and the scale-up's two trainers."""
        sc = el["scale_up"]
        return {"launches_elastic_kill_trainer0":
                el["kill"]["kernel_launches_trainer0"][name],
                "launches_elastic_scale_up":
                sc["kernel_launches_trainer0"][name]
                + sc["kernel_launches_joiner"][name]}
    src = "deeplearning4j_tpu_torch/csrc/"
    ref = "deeplearning4j_tpu/ops/pallas_kernels.py:"
    launches = tr["kernel_launches"]
    emit({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": src + "flash_attn_fwd.cu", "replaces": ref + "73",
         "launches": launches["flash_attn_fwd"],
         "launches_serve": sl["kernel_launches"],
         "launches_attention": at["kernel_launches"]["flash_attn_fwd"],
         "launches_lm_persist": lp["kernel_launches"]["flash_attn_fwd"],
         "launches_streaming":
             st["route"]["kernel_launches"]["flash_attn_fwd"],
         "launches_watch": wt["kernel_launches"]["flash_attn_fwd"],
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["kernel_ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         "design": fwd["design"], "f32_route": "cuda cores",
         "d256": wide("flash_attn_fwd"), **new_callers("flash_attn_fwd")},
        {"name": "flash_attn_dq", "route": "cuda",
         "source": src + "flash_attn_dq.cu", "replaces": ref + "185",
         "launches": launches["flash_attn_dq"],
         "launches_attention": at["kernel_launches"]["flash_attn_dq"],
         "launches_lm_persist": lp["kernel_launches"]["flash_attn_dq"],
         "max_abs_err": bwd["errors"]["dq"]["max_abs_err"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
         "library_ms": bwd["library_bwd_ms"],
         "design": bwd["design"], "f32_route": "cuda cores",
         "d256": wide("flash_attn_dq"), **new_callers("flash_attn_dq")},
        {"name": "flash_attn_dkv", "route": "cuda",
         "source": src + "flash_attn_dkv.cu", "replaces": ref + "235",
         "launches": launches["flash_attn_dkv"],
         "launches_attention": at["kernel_launches"]["flash_attn_dkv"],
         "launches_lm_persist": lp["kernel_launches"]["flash_attn_dkv"],
         "max_abs_err": max(bwd["errors"][g]["max_abs_err"]
                            for g in ("dk", "dv")),
         "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["dkv_bound_ms"], "bound_by": bwd["dkv_bound_by"],
         "library_ms": bwd["library_bwd_ms"],
         "design": bwd["design"], "f32_route": "cuda cores",
         "d256": wide("flash_attn_dkv"), **new_callers("flash_attn_dkv")},
        # the char-RNN's layer window (the sequence kernel) and cell step
        # (the backward); no PyTorch call computes the peephole cell, so
        # library_ms is null and cuDNN's LSTM (another function) is
        # reported beside them
        {"name": "lstm_cell_fwd", "route": "cuda",
         "source": src + "lstm_cell_fwd.cu", "replaces": ref + "508",
         "launches": cr["kernel_launches"]["lstm_cell_fwd"],
         "launches_counted_by": cr["kernel_launches"]["counted_by"],
         "launches_cg": cg["lstm_seq_kernel"],
         "launches_graph_fused": gf["kernel_launches"]["lstm_cell_fwd"],
         "launches_graph_fused_dropout":
             gf["dropout_copy"]["fused_kernel_launches"][0],
         "launches_keras": ke["kernel_launches"]["lstm_cell_fwd"],
         "launches_records": rr["kernel_launches"]["lstm_cell_fwd"],
         "launches_transfer": tf["kernel_launches"]["lstm_cell_fwd"],
         "launches_dp": dp_lstm["lstm_cell_fwd"],
         "launches_ui": ui["charrnn"]["kernel_launches"]["lstm_cell_fwd"],
         "launches_watch": wt["kernel_launches"]["lstm_cell_fwd"],
         "launches_dp_world2_rank0": dp_world2("lstm_cell_fwd"),
         **scaleout_launches("lstm_cell_fwd"),
         **elastic_launches("lstm_cell_fwd"),
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
         "launches_graph_fused": gf["kernel_launches"]["lstm_cell_bwd"],
         "launches_graph_fused_dropout":
             gf["dropout_copy"]["fused_kernel_launches"][1],
         "launches_keras": ke["kernel_launches"]["lstm_cell_bwd"],
         "launches_records": rr["kernel_launches"]["lstm_cell_bwd"],
         "launches_transfer": tf["kernel_launches"]["lstm_cell_bwd"],
         "launches_dp": dp_lstm["lstm_cell_bwd"],
         "launches_ui": ui["charrnn"]["kernel_launches"]["lstm_cell_bwd"],
         "launches_watch": wt["kernel_launches"]["lstm_cell_bwd"],
         "launches_dp_world2_rank0": dp_world2("lstm_cell_bwd"),
         **scaleout_launches("lstm_cell_bwd"),
         **elastic_launches("lstm_cell_bwd"),
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
    # one rank of a phase's world, started by the phase itself
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(dp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5]))
    RANK_MODES = {"--shard-rank": shard_rank_main, "--tp-rank": tp_rank_main,
                  "--pp-rank": pp_rank_main, "--sp-rank": sp_rank_main,
                  "--ep-rank": ep_rank_main}
    if sys.argv[1:2] and sys.argv[1] in RANK_MODES:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(RANK_MODES[sys.argv[1]](int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4]))
    if sys.argv[1:2] == ["--elastic-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(elastic_rank_main(sys.argv[2], int(sys.argv[3]),
                                   int(sys.argv[4]), sys.argv[5],
                                   sys.argv[6]))
    sys.exit(main())
