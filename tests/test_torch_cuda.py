"""The CUDA kernels (flash attention, the LSTM cell) against their plain
twins, on the card; and the LeNet path's layers (convolution, pooling,
normalization through PyTorch) on the card against the CPU.

These tests need an NVIDIA GPU and skip elsewhere. They import neither
JAX nor the JAX package, so they run where only PyTorch is installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 abs (summation order only); lse 1e-5 abs in both
dtypes (f32 on both sides). The bf16 flash kernels run on the tensor
cores and round P, Pᵀ, dSᵀ and dS to bf16 before their products, so they
are held against the twin's unrounded f32 result by the bars derived in
``ops/flash_attention.py``: O within ``BF16_O_BAR`` (max|V| of the kv
head + |O_f32|) element by element, dQ within ``BF16_DQ_BAR`` max|g_f32|,
dK and dV within ``BF16_DKV_BAR`` max|g_f32|. Backward: f32 dq/dk/dv
within 1e-5 of each gradient's max abs (summation order only; f32 against
float64 sits near 1e-6 of it at these shapes).
LSTM cell step: f32 h/c 1e-6 abs up to H 200 (1e-6 sqrt(H/200) beyond:
the dot products' rounding grows with their length), gradients 1e-5 of
each output's max abs; bf16 within one bf16 step of the twin's bf16
result. LSTM window (the sequence kernel, T > 1): f32 out/h/c within
``F32_WINDOW_TOL`` (times sqrt(H/200) beyond H 200), bf16 within
``BF16_WINDOW_BAR`` of each output's max abs, both derived on the CPU in
``ops/lstm_cell.py`` (each step's rounding feeds the next); the window's
f32 gradients within 1e-5 of each gradient's max abs. The kernels sum in
a fixed order (no atomics): two calls on the same inputs, and a CUDA
graph's replay, give bit-identical results. CNN layers: f32 outputs,
gradients and BN's running moments within 1e-5 of each result's max abs
of the CPU's (summation order only); max-pool ties route to the same
element; a LeNet graph replays to the same bits (the fused loops compared
under ``cudnn.deterministic``); a restored archive gives the same output
bits on the card, the reference's archives their recorded outputs within
1e-5. A narrow ResNet (ComputationGraph) trained 3 steps on the card
stays within ``CNN_CARD_CPU_RTOL`` (1e-4 of each leaf's max abs) of the
same steps on the CPU, also after a decode burst in the same process.
The flash kernels are held at head dims 160, 192 and 256 too (their DP
256 instances), and a head dim of 257 is refused. Two ContinuousLM
replicas on the card: one captures while the other replays, and one is
killed behind the router; their rows equal ``generate()``'s. Word2Vec's
``sorted`` scatter gives the same table bits on two fits from one seed.
SelfAttentionLayer through its flash helper (the kernels) against the
built-in dense path (``DL4J_TPU_DISABLE_HELPERS=1``) on the card: f32
output and one step's gradients within 1e-5 of each tensor's max abs,
with the forward and both backward kernels launched once a layer; under
a key mask the helper declines (no launch, counted) and the result is
the built-in route's, bit for bit. The committed Keras files
(``tests/fixtures/keras``) imported on the card give the CPU import's
outputs within 1e-5 of their scale, the LSTM's through the sequence
kernel, the narrow ResNet-50 topology's too. A small f32 ViT (T 49, no
multiple of a tile, non-causal) and MoE LM (flash route, top-2) on the
card against the same weights on the CPU: logits and one step's
gradients within 1e-5 (ViT) and 1e-4 (MoE, as the LM's train bars) of
each tensor's max abs, each layer launching the three kernels once, and
the MoE's routing equal. Data parallelism: a world of one rank over NCCL
trains a narrow LM at every ZeRO level bit for bit as unsharded; two
gloo ranks sharing cuda:0 train an MLP through ParallelWrapper to one
process's parameters within 1e-5 of their max abs. The parameter-averaging
training master with two thread workers on the card repeats bit for bit
and matches the same run on the CPU within 1e-5 of the parameters' max
abs.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as port_fa
from deeplearning4j_tpu_torch.ops import lstm_cell as port_lc
from deeplearning4j_tpu_torch.ops.flash_attention import (
    BF16_DKV_BAR, BF16_DQ_BAR, GRAD_CANCEL, _flash_forward, _kernel_backward,
    bf16_o_limit, bwd_term_sizes, flash_attention,
    flash_attention_bwd_plain)

F32_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (n, kv_n, T, d, causal, window, dtype): the bf16 cases cover one key
# (T 1), a second tile of one row (T 65), rows of 72 bytes that do not start
# on 16-byte boundaries (d 36), GQA 4 with window 1, and non-causal
KERNEL_CASES = [
    (16, 16, 512, 64, True, None, torch.float32),
    (16, 16, 512, 64, True, None, torch.bfloat16),
    (8, 4, 500, 64, True, 24, torch.float32),
    (8, 8, 333, 16, False, None, torch.float32),
    (8, 8, 200, 128, True, None, torch.bfloat16),
    (8, 8, 1, 64, True, None, torch.bfloat16),
    (8, 8, 65, 64, True, None, torch.bfloat16),
    (8, 8, 300, 36, True, None, torch.bfloat16),
    (16, 4, 200, 32, True, 1, torch.bfloat16),
    (8, 2, 333, 16, False, None, torch.bfloat16),
    (8, 4, 500, 64, True, 24, torch.bfloat16),
] + [
    # head dims above 128: the DP 256 instances (d 160 and 192 with their
    # columns up to 256 held at zero), f32 and bf16, causal and not, GQA
    (n, kv_n, t, d, causal, None, dtype)
    for n, kv_n, t, d, causal in ((8, 4, 300, 160, True),
                                  (8, 2, 257, 192, False),
                                  (8, 4, 200, 256, True),
                                  (8, 8, 130, 256, False))
    for dtype in (torch.float32, torch.bfloat16)
]


def _offset_view(x):
    """x's values in a tensor whose data starts one element into its
    storage: contiguous, but its rows are not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _check_forward(got_o, got_lse, q, k, v, kv_group, **kw):
    """The forward kernel's O and lse against the twin on the same inputs:
    f32 O 1e-5 abs; bf16 O within the tensor-core bar of the twin's
    unrounded f32 O; lse 1e-5 abs."""
    want_o, want_lse = port_fa._plain_forward(q, k, v, kv_group=kv_group,
                                              **kw)
    assert got_o.dtype == q.dtype and got_o.shape == q.shape
    err = (got_o.float() - want_o).abs()
    limit = F32_TOL if q.dtype == torch.float32 else \
        bf16_o_limit(v, want_o, kv_group)
    assert bool((err <= limit).all()), err.max().item()
    assert (got_lse - want_lse).abs().max().item() <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,kv_n,t,d,causal,window,dtype", KERNEL_CASES)
def test_kernel_matches_twin_on_card(cuda_device, monkeypatch, n, kv_n, t,
                                     d, causal, window, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    std = 1.0 if dtype == torch.float32 else 0.5
    q, k, v = ((std * torch.randn(shape, generator=g, device=cuda_device))
               .to(dtype) for shape in ((n, t, d), (kv_n, t, d),
                                        (kv_n, t, d)))

    def no_twin(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain twin")
    monkeypatch.setattr(port_fa, "flash_attention_plain", no_twin)
    before = flash_attention.launches
    got_o, got_lse = _flash_forward(q, k, v, causal=causal, window=window,
                                    kv_group=n // kv_n)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _check_forward(got_o, got_lse, q, k, v, n // kv_n, causal=causal,
                   window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_offset_views_match_twin_on_card(cuda_device, dtype):
    """q, k, v, O and dO whose data start one element into their storage
    (rows off 16-byte boundaries) take the element-wise loads and stores
    of the same kernels, with the same bars as aligned inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, kv_n, t, d = 8, 4, 200, 64
    kw = dict(causal=True, window=None)
    q, do = (_offset_view((0.5 * torch.randn((n, t, d), generator=g,
                                             device=cuda_device)).to(dtype))
             for _ in range(2))
    k, v = (_offset_view((0.5 * torch.randn((kv_n, t, d), generator=g,
                                            device=cuda_device)).to(dtype))
            for _ in range(2))
    assert q.storage_offset() == 1 and q.is_contiguous()
    o, lse = _flash_forward(q, k, v, kv_group=n // kv_n, **kw)
    torch.cuda.synchronize()
    _check_forward(o, lse, q, k, v, n // kv_n, **kw)
    o = _offset_view(o)
    got = _kernel_backward(q, k, v, o, lse, do, kv_group=n // kv_n, **kw)
    _check_backward(got, q, k, v, o, lse, do, kv_group=n // kv_n, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_model_views_matches_twin_on_card(cuda_device,
                                                     monkeypatch, dtype):
    """The public wrapper on q/k/v as the model hands them over: [B, T,
    H, hd] activations viewed as [B, H, T, hd]. Its O against the twin's
    unrounded f32 O: f32 1e-5 abs; bf16 within the tensor-core bar."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, t, h, d = 2, 300, 4, 64
    q, k, v = ((0.5 * torch.randn((b, t, h, d), generator=g,
                                  device=cuda_device)).to(dtype)
               .transpose(1, 2) for _ in range(3))
    want, _ = port_fa._plain_forward(
        *(x.reshape(-1, t, d) for x in (q, k, v)), causal=True, window=40,
        kv_group=1)

    def no_twin(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain twin")
    monkeypatch.setattr(port_fa, "flash_attention_plain", no_twin)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    err = (got.reshape(-1, t, d).float() - want.float()).abs()
    limit = F32_TOL if dtype == torch.float32 else \
        bf16_o_limit(v.reshape(-1, t, d), want, 1)
    assert bool((err <= limit).all()), err.max().item()


@pytest.mark.cuda
def test_kernel_skips_lse_when_not_asked(cuda_device):
    q = torch.randn((4, 100, 32), device=cuda_device)
    o, lse = _flash_forward(q, q, q, causal=True, with_lse=False)
    want, _ = _flash_forward(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert lse is None
    assert torch.equal(o, want)


# (n, kv_n, T, d, causal, window, dtype): ragged T, GQA 2 and 4, windows
# 1 and 24, non-causal, every head-dim instantiation; in bf16 also T 1,
# T 65, d 36 (rows off 16-byte boundaries), GQA 4 with window 1
BWD_CASES = [
    (16, 16, 512, 64, True, None, torch.float32),
    (16, 16, 511, 64, True, None, torch.bfloat16),
    (8, 4, 500, 64, True, 24, torch.float32),
    (8, 2, 333, 16, False, None, torch.float32),
    (8, 8, 200, 128, True, None, torch.bfloat16),
    (8, 2, 100, 32, True, 1, torch.bfloat16),
    (8, 8, 1, 64, True, None, torch.bfloat16),
    (8, 8, 65, 64, True, None, torch.bfloat16),
    (8, 8, 300, 36, True, None, torch.bfloat16),
    (16, 4, 200, 32, True, 1, torch.bfloat16),
    (8, 2, 333, 16, False, None, torch.bfloat16),
] + [
    (n, kv_n, t, d, causal, window, dtype)
    for n, kv_n, t, d, causal, window in ((8, 4, 300, 160, True, None),
                                          (8, 2, 257, 192, False, None),
                                          (8, 4, 200, 256, True, None),
                                          (8, 4, 333, 256, True, 40),
                                          (8, 8, 130, 256, False, None))
    for dtype in (torch.float32, torch.bfloat16)
]


def _check_backward(got, q, k, v, o, lse, do, **kw):
    """(dq, dk, dv) of the kernels against the plain backward on the same
    inputs. f32: 1e-5 of each gradient's max abs. bf16 (tensor cores): dq
    within ``BF16_DQ_BAR`` max|g_f32|, dk and dv within ``BF16_DKV_BAR``
    max|g_f32| of the twin's unrounded f32 result. A gradient that cancels
    to f32 rounding (one key a row) is held within ``GRAD_CANCEL`` of its
    terms' size."""
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    want_f32 = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         o.float(), lse, do.float(), **kw)
    sizes = bwd_term_sizes(q, k, v, o, lse, do, **kw)
    for name, a, b, b32, size in zip(("dq", "dk", "dv"), got, want,
                                     want_f32, sizes):
        assert a.dtype == q.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        scale = b32.abs().max().item()
        if scale <= GRAD_CANCEL * size:
            err = (a.float() - b32).abs().max().item()
            assert err <= GRAD_CANCEL * size, (name, err, size)
        elif q.dtype == torch.float32:
            err = (a - b).abs().max().item()
            assert err <= 1e-5 * scale, (name, err, scale)
        else:
            bar = BF16_DQ_BAR if name == "dq" else BF16_DKV_BAR
            err = (a.float() - b32).abs().max().item()
            assert err <= bar * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,kv_n,t,d,causal,window,dtype", BWD_CASES)
def test_backward_kernels_match_twin_on_card(cuda_device, monkeypatch, n,
                                             kv_n, t, d, causal, window,
                                             dtype):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    std = 1.0 if dtype == torch.float32 else 0.5
    q, do = ((std * torch.randn((n, t, d), generator=g, device=cuda_device))
             .to(dtype) for _ in range(2))
    k, v = ((std * torch.randn((kv_n, t, d), generator=g,
                               device=cuda_device)).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, kv_group=n // kv_n)
    o, lse = _flash_forward(q, k, v, **kw)

    def no_twin(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain twin")
    monkeypatch.setattr(port_fa, "flash_attention_bwd_plain", no_twin)
    before = (flash_attention.dq_launches, flash_attention.dkv_launches)
    got = _kernel_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.dq_launches, flash_attention.dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    _check_backward(got, q, k, v, o, lse, do, **kw)


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels_on_card(cuda_device,
                                                    monkeypatch):
    """``torch.autograd.grad`` through the public wrapper on the model's
    transposed views launches the two backward kernels once each, never
    the twin, and gives the twin's gradients."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, t, h, d = 2, 130, 4, 64
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=cuda_device,
                      requires_grad=True)
    cot = torch.randn((b, h, t, d), generator=g, device=cuda_device)

    def heads(x):
        return [a.reshape(b, t, h, d).transpose(1, 2)
                for a in torch.split(x, h * d, dim=-1)]
    # the reference: causal softmax attention in float64 on the CPU, so it
    # sits far below the bar and does not move between runs
    qkv64 = qkv.detach().cpu().double().requires_grad_()
    q64, k64, v64 = heads(qkv64)
    s64 = torch.matmul(q64, k64.transpose(-1, -2)) / math.sqrt(d)
    s64 = s64.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          float("-inf"))
    want = torch.autograd.grad(
        (torch.matmul(torch.softmax(s64, dim=-1), v64) *
         cot.cpu().double()).sum(), qkv64)[0]

    def no_twin(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain twin")
    monkeypatch.setattr(port_fa, "flash_attention_bwd_plain", no_twin)
    before = (flash_attention.dq_launches, flash_attention.dkv_launches)
    got = torch.autograd.grad(
        (flash_attention(*heads(qkv), causal=True) * cot).sum(), qkv)[0]
    torch.cuda.synchronize()
    assert (flash_attention.dq_launches, flash_attention.dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    assert (got.cpu().double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_bit_identical_across_calls_on_card(
        cuda_device, dtype):
    """dQ (tensor cores in bf16) and dK/dV sum in a fixed order, with no
    atomics: two calls on the same inputs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n, kv_n, t, d = 16, 8, 300, 64
    q, do = ((0.5 * torch.randn((n, t, d), generator=g, device=cuda_device))
             .to(dtype) for _ in range(2))
    k, v = ((0.5 * torch.randn((kv_n, t, d), generator=g,
                               device=cuda_device)).to(dtype)
            for _ in range(2))
    kw = dict(causal=True, window=None, kv_group=n // kv_n)
    o, lse = _flash_forward(q, k, v, **kw)
    first = _kernel_backward(q, k, v, o, lse, do, **kw)
    second = _kernel_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# (B, H, peepholes, dtype): the char-RNN's cell step and edge cases
LSTM_CASES = [
    (32, 200, True, torch.float32),
    (32, 200, False, torch.float32),
    (32, 200, True, torch.bfloat16),
    (1, 200, True, torch.float32),
    (7, 37, True, torch.float32),
    (64, 1024, True, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,peep,dtype", LSTM_CASES)
def test_lstm_kernels_match_twins_on_card(cuda_device, monkeypatch, b, h,
                                          peep, dtype):
    """``lstm_cell`` on CUDA tensors under autograd: one forward (the
    sequence kernel over one step) and one backward kernel call, never a
    twin, the twins' values."""
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=cuda_device)) \
            .to(dtype)
    args = [rnd(b, 4 * h), rnd(b, h, std=0.5), rnd(b, h),
            rnd(h, 4 * h, std=h ** -0.5), rnd(3, h, std=0.1) if peep
            else None]
    dh, dc = rnd(b, h), rnd(b, h)
    want_f = port_lc.lstm_cell_plain(*args)
    want_b = port_lc.lstm_cell_bwd_plain(*args, dh, dc)

    def no_twin(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain twin")
    monkeypatch.setattr(port_lc, "lstm_cell_plain", no_twin)
    monkeypatch.setattr(port_lc, "lstm_cell_bwd_plain", no_twin)
    monkeypatch.setattr(port_lc, "lstm_sequence_plain", no_twin)
    leaves = [None if a is None else a.clone().requires_grad_()
              for a in args]
    before = (port_lc.lstm_sequence.launches, port_lc.lstm_cell.bwd_launches)
    hn, cn = port_lc.lstm_cell(*leaves)
    grads = torch.autograd.grad((hn, cn), [a for a in leaves
                                           if a is not None], (dh, dc))
    torch.cuda.synchronize()
    assert (port_lc.lstm_sequence.launches,
            port_lc.lstm_cell.bwd_launches) == (before[0] + 1, before[1] + 1)
    fwd_tol = 1e-6 * max(1.0, np.sqrt(h / 200))
    for name, got, want in (("h", hn, want_f[0]), ("c", cn, want_f[1])):
        err = (got.float() - want.float()).abs()
        limit = fwd_tol if dtype == torch.float32 else \
            1e-5 + 2.0 ** -7 * want.float().abs()
        assert got.dtype == dtype and bool((err <= limit).all()), \
            (name, err.max().item())
    # dP's gradient is the Function's fifth output; it is absent without
    # peepholes
    for name, got, want in zip(("dzx", "dh_prev", "dc_prev", "dRW", "dP"),
                               grads, [w for w in want_b if w is not None]):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs()
        limit = 1e-5 * scale + (0 if dtype == torch.float32 else
                                2.0 ** -7 * want.float().abs())
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert bool((err <= limit).all()), (name, err.max().item(), scale)


@pytest.mark.cuda
def test_charrnn_window_on_card_matches_cpu(cuda_device):
    """One tBPTT ``fit_batch`` of a small char-RNN on the card (the
    kernels) and on the CPU (the twins) from the same weights: the loss
    1e-5 relative, every updated leaf 1e-4 of its max abs."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    conf = zoo.char_rnn(vocab_size=20, hidden=32, tbptt_length=10,
                        learning_rate=0.01)
    card = MultiLayerNetwork(conf, device=cuda_device).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.set_params(card.params())
    r = np.random.RandomState(0)
    x = np.eye(20, dtype=np.float32)[r.randint(0, 20, (4, 20))]
    before = (port_lc.lstm_sequence.launches, port_lc.lstm_cell.bwd_launches)
    got, want = float(card.fit_batch(x, x)), float(cpu.fit_batch(x, x))
    # 2 layers x 2 windows of 10 steps: a forward launch a window, a
    # backward launch a step
    assert (port_lc.lstm_sequence.launches - before[0],
            port_lc.lstm_cell.bwd_launches - before[1]) == (2 * 2, 2 * 20)
    assert abs(got - want) <= 1e-5 * abs(want)
    for pg, pc in zip(card.params_list, cpu.params_list):
        for k in pg:
            w = pc[k].detach()
            assert (pg[k].detach().cpu() - w).abs().max() <= \
                1e-4 * w.abs().max()


def _lstm_inputs(device, b, h, peep, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)) \
            .to(dtype)
    args = (rnd(b, 4 * h), rnd(b, h, std=0.5), rnd(b, h),
            rnd(h, 4 * h, std=h ** -0.5), rnd(3, h, std=0.1) if peep
            else None)
    return args, rnd(b, h), rnd(b, h)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,peep,dtype", LSTM_CASES)
def test_lstm_backward_is_one_launch_and_bit_identical_on_card(
        cuda_device, b, h, peep, dtype):
    """The LSTM backward kernel sums in a fixed order, with no atomics:
    two calls on the same inputs give the same bits; each call is one
    kernel launch (``torch.profiler``; a profile that recorded no device
    event at all saw nothing and is taken again, up to five times)."""
    from torch.profiler import ProfilerActivity, profile
    args, dh, dc = _lstm_inputs(cuda_device, b, h, peep, dtype, seed=7)
    first = port_lc._kernel_backward(*args, dh, dc)
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            second = port_lc._kernel_backward(*args, dh, dc)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        if kernels:
            break
    assert len(kernels) == 1, kernels
    for name, a, c in zip(("dzx", "dh_prev", "dc_prev", "dRW", "dP"),
                          first, second):
        assert (a is None) == (c is None) == (name == "dP" and not peep)
        assert a is None or torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_backward_graph_replay_equals_eager_on_card(cuda_device, dtype):
    """An LSTM backward call captured in a CUDA graph and replayed twice
    gives the eager call's bits: the single launch is capturable, and
    replays leave nothing behind that changes the next one."""
    args, dh, dc = _lstm_inputs(cuda_device, 32, 200, True, dtype, seed=8)
    eager = port_lc._kernel_backward(*args, dh, dc)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        port_lc._kernel_backward(*args, dh, dc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = port_lc._kernel_backward(*args, dh, dc)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for name, a, c in zip(("dzx", "dh_prev", "dc_prev", "dRW", "dP"),
                              eager, captured):
            assert torch.equal(a, c), name


# the sequence kernel: (name, T, B, H, peepholes, dtype, mask, reverse);
# "main" is the char-RNN's layer window
SEQ_CASES = [
    ("main", 50, 32, 200, True, torch.float32, None, False),
    ("no_peephole", 50, 32, 200, False, torch.float32, None, False),
    ("bf16", 50, 32, 200, True, torch.bfloat16, None, False),
    ("bf16_t1", 1, 32, 200, True, torch.bfloat16, None, False),
    ("b1", 50, 1, 200, True, torch.float32, None, False),
    ("ragged", 7, 7, 37, True, torch.float32, None, False),
    ("wide", 8, 64, 1024, True, torch.float32, None, False),
    ("masked", 50, 32, 200, True, torch.float32, "mask", False),
    ("reverse", 50, 32, 200, True, torch.float32, None, True),
    ("masked_reverse", 50, 32, 200, True, torch.float32, "mask", True),
    ("t1", 1, 32, 200, True, torch.float32, None, False),
]
SEQ_IDS = [c[0] for c in SEQ_CASES]


def _seq_inputs(device, t, b, h, peep, dtype, mask, seed):
    """(zx_t, h0, c0, RW, P, keep), and the cotangents of (out, h_T, c_T).
    The mask drops the first 10 steps of two rows (pre-padding) and a
    sixth of the rest at random."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)) \
            .to(dtype)
    args = (rnd(t, b, 4 * h), rnd(b, h, std=0.5), rnd(b, h),
            rnd(h, 4 * h, std=h ** -0.5), rnd(3, h, std=0.1) if peep
            else None)
    keep = None
    if mask:
        keep = torch.rand((t, b), generator=g, device=device) > 1 / 6
        keep[:min(t, 10), :2] = False
    return args + (keep,), (rnd(t, b, h), rnd(b, h), rnd(b, h))


def _seq_bar(t, h, dtype, want):
    """The largest error a window output may show against the twin's."""
    if dtype == torch.float32:
        tol = 1e-6 if t == 1 else port_lc.F32_WINDOW_TOL
        return tol * max(1.0, math.sqrt(h / 200))
    if t == 1:   # one bf16 step, element by element
        return 1e-5 + 2.0 ** -7 * want.float().abs()
    return port_lc.BF16_WINDOW_BAR * want.float().abs().max().item()


def _no_twin(monkeypatch):
    def no_twin(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain twin")
    for name in ("lstm_sequence_plain", "lstm_cell_plain",
                 "lstm_cell_bwd_plain"):
        monkeypatch.setattr(port_lc, name, no_twin)


@pytest.mark.cuda
@pytest.mark.parametrize("name,t,b,h,peep,dtype,mask,reverse", SEQ_CASES,
                         ids=SEQ_IDS)
def test_sequence_kernel_matches_twin_on_card(cuda_device, monkeypatch, name,
                                              t, b, h, peep, dtype, mask,
                                              reverse):
    """``lstm_sequence`` on CUDA tensors: one launch for the window, never
    a twin; its outputs and every step's (h, c) against the twin's."""
    args, _ = _seq_inputs(cuda_device, t, b, h, peep, dtype, mask, seed=9)
    want = port_lc.lstm_sequence_plain(*args, reverse, with_states=True)
    _no_twin(monkeypatch)
    before = port_lc.lstm_sequence.launches
    out, (h_t, c_t) = port_lc.lstm_sequence(*args, reverse=reverse)
    states = port_lc._kernel_sequence(*args, reverse)
    torch.cuda.synchronize()
    assert port_lc.lstm_sequence.launches == before + 2
    got = (out, states[1], states[2])
    assert torch.equal(h_t, states[1][-1]) and torch.equal(c_t, states[2][-1])
    assert torch.equal(out, states[0])
    for what, a, w in zip(("out", "h_all", "c_all"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, what
        err = (a.float() - w.float()).abs()
        assert bool(torch.isfinite(a).all()), what
        assert bool((err <= _seq_bar(t, h, dtype, w)).all()), \
            (what, err.max().item())
    if mask:   # dropped steps emit exactly 0
        assert bool((out[~args[5]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,t,b,h,peep,dtype,mask,reverse",
                         [c for c in SEQ_CASES if c[5] == torch.float32],
                         ids=[c[0] for c in SEQ_CASES
                              if c[5] == torch.float32])
def test_sequence_gradients_match_twin_on_card(cuda_device, monkeypatch,
                                               name, t, b, h, peep, dtype,
                                               mask, reverse):
    """The sequence Function's backward on the card (the cell backward
    kernel once a step, dRW and dP summed in place) against the same
    Function on CPU copies (the twins): every input's gradient, with
    cotangents on out, h_T and c_T, within 1e-5 of its max abs."""
    args, cots = _seq_inputs(cuda_device, t, b, h, peep, dtype, mask,
                             seed=10)

    def grads(device):
        leaves = [None if a is None else a.to(device).requires_grad_()
                  for a in args[:5]]
        keep = None if args[5] is None else args[5].to(device)
        out, (h_t, c_t) = port_lc.lstm_sequence(*leaves, keep, reverse)
        return torch.autograd.grad(
            (out, h_t, c_t), [a for a in leaves if a is not None],
            [c.to(device) for c in cots])
    want = grads("cpu")
    _no_twin(monkeypatch)
    before = (port_lc.lstm_sequence.launches, port_lc.lstm_cell.bwd_launches)
    got = grads(cuda_device)
    torch.cuda.synchronize()
    assert (port_lc.lstm_sequence.launches - before[0],
            port_lc.lstm_cell.bwd_launches - before[1]) == (1, t)
    for what, a, w in zip(("dzx", "dh0", "dc0", "dRW", "dP"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, what
        scale = w.abs().max().item()
        err = (a.cpu() - w).abs().max().item()
        assert bool(torch.isfinite(a).all()) and err <= 1e-5 * scale, \
            (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main", "bf16", "wide", "masked_reverse",
                                  "t1"])
def test_sequence_kernel_is_one_launch_and_bit_identical_on_card(
        cuda_device, name):
    """The sequence kernel sums in a fixed order, with no atomics: a second
    call and a CUDA graph's replays give the first call's bits; a call is
    one CUDA kernel (``torch.profiler``; a profile that recorded no device
    event at all saw nothing and is taken again, up to five times)."""
    from torch.profiler import ProfilerActivity, profile
    _, t, b, h, peep, dtype, mask, reverse = SEQ_CASES[SEQ_IDS.index(name)]
    args, _ = _seq_inputs(cuda_device, t, b, h, peep, dtype, mask, seed=11)

    def call():
        return port_lc._kernel_sequence(*args, reverse)
    first = call()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            second = call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        if kernels:
            break
    assert len(kernels) == 1, kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for what, a, c, r in zip(("out", "h_all", "c_all"), first, second,
                                 captured):
            assert torch.equal(a, c) and torch.equal(a, r), what


# ---------------------------------------------------------------------------
# the fused loop on the card: a window's train step as one CUDA graph
# ---------------------------------------------------------------------------
def _card_charrnn(device, seg):
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    conf = zoo.char_rnn(vocab_size=20, hidden=32, tbptt_length=seg,
                        learning_rate=0.01)
    return MultiLayerNetwork(conf, device=device).init()


def _card_batches(n, t, seed, rows=4):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    r = np.random.RandomState(seed)
    eye = np.eye(20, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = r.randint(0, 20, (rows, t + 1))
        out.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _card_fit(net, batches, monkeypatch, k, epochs=1):
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
    net.fit(ListDataSetIterator(batches), epochs=epochs)
    torch.cuda.synchronize()
    return net


@pytest.mark.cuda
def test_fused_fit_on_card_equals_per_batch_on_card(cuda_device,
                                                    monkeypatch):
    """Six batches and a ragged 3-row trailer, T 30 in windows of 10,
    through the captured window graphs (K 4) and through the per-batch
    loop (K 1) from the same parameters: parameters and rmsprop state
    agree bitwise, the device iteration and the last score too."""
    batches = _card_batches(6, 30, seed=1) + _card_batches(1, 30, 2, rows=3)
    fused = _card_charrnn(cuda_device, 10)
    plain = _card_charrnn(cuda_device, 10)
    plain.set_params(fused.params())
    _card_fit(fused, batches, monkeypatch, 4)
    _card_fit(plain, batches, monkeypatch, 1)
    assert fused._last_fuse_stats["fused_groups"] == 2
    assert fused._fused.captures == 1 and plain._fused is None
    assert fused.iteration == plain.iteration == 7 * 3
    np.testing.assert_array_equal(fused.params(), plain.params())
    for a, b in zip(fused.updater_states, plain.updater_states):
        for key in a:
            for k in a[key]:
                assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert int(fused._iter_dev) == int(plain._iter_dev)
    assert fused.score_ == plain.score_


@pytest.mark.cuda
def test_one_capture_per_window_signature_across_epochs(cuda_device,
                                                        monkeypatch):
    """T 12 in windows of 5, 5 and 2: two window signatures, so two
    captures over two epochs, and none in a later fit after
    ``set_params`` and ``reset_updater_state``, which the graphs see
    (the next fit equals a fresh net's from the same parameters)."""
    batches = _card_batches(6, 12, seed=3)
    net = _card_charrnn(cuda_device, 5)
    p0 = net.params()
    _card_fit(net, batches, monkeypatch, 4, epochs=2)
    assert net._fused.captures == len(net._fused.graphs) == 2
    net.set_params(p0)
    net.reset_updater_state()
    net.iteration = 0
    _card_fit(net, batches, monkeypatch, 4)
    assert net._fused.captures == 2
    fresh = _card_charrnn(cuda_device, 5)
    fresh.set_params(p0)
    _card_fit(fresh, batches, monkeypatch, 4)
    np.testing.assert_array_equal(net.params(), fresh.params())


@pytest.mark.cuda
def test_replayed_window_runs_two_sequence_and_100_backward_kernels(
        cuda_device, monkeypatch):
    """A captured 50-step window of the two-layer char-RNN, replayed:
    ``torch.profiler`` counts 2 sequence kernels and 100 backward kernels
    (a profile that recorded no device event at all saw nothing and is
    taken again, up to five times), while the wrappers' launch counters
    stand still: a replay calls no wrapper."""
    from torch.profiler import ProfilerActivity, profile
    net = _card_charrnn(cuda_device, 50)
    batch = _card_batches(1, 50, seed=4)
    _card_fit(net, batch, monkeypatch, 8)            # captures
    before = (port_lc.lstm_sequence.launches, port_lc.lstm_cell.bwd_launches)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _card_fit(net, batch, monkeypatch, 8)
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            break
    after = (port_lc.lstm_sequence.launches, port_lc.lstm_cell.bwd_launches)
    assert net._fused.captures == 1
    assert sum("lstm_seq_kernel" in n for n in names) == 2, names
    assert sum("lstm_bwd_kernel" in n for n in names) == 100
    assert after == before


@pytest.mark.cuda
def test_poisoned_step_on_card_equals_the_stream_without_it(cuda_device,
                                                            monkeypatch):
    """``nan-step@0:1`` under the guard on the card: the replayed windows
    of the poisoned batch are reverted, so the run equals the stream
    without that batch, bitwise, and counts its windows."""
    import warnings
    from deeplearning4j_tpu_torch.testing import faults
    batches = _card_batches(4, 30, seed=5)
    poisoned = _card_charrnn(cuda_device, 10)
    control = _card_charrnn(cuda_device, 10)
    control.set_params(poisoned.params())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject("nan-step@0:1"):
            _card_fit(poisoned, batches, monkeypatch, 4)
    assert any("non-finite" in str(w.message) for w in caught)
    _card_fit(control, [batches[0]] + batches[2:], monkeypatch, 4)
    np.testing.assert_array_equal(poisoned.params(), control.params())
    assert poisoned.nan_skipped_steps == 3
    assert int(poisoned._iter_dev) == int(control._iter_dev)


@pytest.mark.cuda
def test_fused_mlp_with_a_decaying_lr_on_card_equals_per_batch(cuda_device,
                                                              monkeypatch):
    """Standard backprop through the fused loop on the card (a batch is
    one window graph), adam with an exponentially decaying learning rate
    and gradient clipping, whose lr is computed on the card inside the
    graph: the same bits as the per-batch loop."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    def net():
        conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.05)
                .updater("adam").learning_rate_policy("exponential")
                .lr_policy_decay_rate(0.9)
                .gradient_normalization("ClipL2PerLayer")
                .gradient_normalization_threshold(1.0).list()
                .layer(DenseLayer(n_in=12, n_out=32, activation="relu"))
                .layer(OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf, device=cuda_device).init()
    r = np.random.RandomState(7)
    batches = [DataSet(r.rand(16, 12).astype(np.float32),
                       np.eye(5, dtype=np.float32)[r.randint(0, 5, 16)])
               for _ in range(5)]
    fused, plain = net(), net()
    plain.set_params(fused.params())
    _card_fit(fused, batches, monkeypatch, 4, epochs=2)
    _card_fit(plain, batches, monkeypatch, 1, epochs=2)
    assert fused._fused.captures == 1
    np.testing.assert_array_equal(fused.params(), plain.params())


@pytest.mark.cuda
def test_a_failed_capture_raises_and_nothing_runs_eagerly(cuda_device,
                                                          monkeypatch):
    """A window step that fails while it is being captured raises out of
    ``fit``: no eager fallback updates the parameters (the warm-up runs
    with zero weights, an identity update)."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    real = MultiLayerNetwork._fused_window_step

    def failing(self, win, carries, guard):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture refused")
        return real(self, win, carries, guard)
    monkeypatch.setattr(MultiLayerNetwork, "_fused_window_step", failing)
    net = _card_charrnn(cuda_device, 10)
    p0 = net.params()
    with pytest.raises(RuntimeError, match="capture refused"):
        _card_fit(net, _card_batches(2, 30, seed=6), monkeypatch, 4)
    assert net._fused.captures == 0
    np.testing.assert_array_equal(net.params(), p0)


# ---------------------------------------------------------------------------
# the LeNet path on the card: conv, pooling and normalization through
# PyTorch (cuDNN) in the reference's NHWC/HWIO layouts
# ---------------------------------------------------------------------------
def _layer_case(name):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, LocalResponseNormalization,
        SubsamplingLayer)
    cases = {
        "conv_5x5": (ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                      activation="identity"),
                     (16, 28, 28, 1)),
        "conv_same_stride2": (ConvolutionLayer(
            n_out=12, kernel_size=(4, 4), stride=(2, 2),
            convolution_mode="same", activation="relu"), (8, 15, 14, 6)),
        "conv_no_bias_padded": (ConvolutionLayer(
            n_out=50, kernel_size=(5, 5), padding=(2, 2), has_bias=False,
            activation="identity"), (8, 12, 12, 20)),
        "max_pool": (SubsamplingLayer(pooling_type="max"), (16, 24, 24, 20)),
        "avg_pool_same": (SubsamplingLayer(pooling_type="avg",
                                           kernel_size=(3, 3),
                                           convolution_mode="same"),
                          (8, 9, 9, 4)),
        "pnorm_pool_pad": (SubsamplingLayer(pooling_type="pnorm",
                                            kernel_size=(3, 3),
                                            stride=(1, 1), padding=(2, 2)),
                           (8, 7, 7, 4)),
        "batch_norm_train": (BatchNormalization(), (16, 8, 8, 20)),
        "lrn": (LocalResponseNormalization(), (8, 6, 6, 16)),
    }
    layer, shape = cases[name]
    layer.set_input_type(InputType.convolutional(*shape[1:]))
    return layer, shape


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv_5x5", "conv_same_stride2",
                                  "conv_no_bias_padded", "max_pool",
                                  "avg_pool_same", "pnorm_pool_pad",
                                  "batch_norm_train", "lrn"])
def test_cnn_layer_on_card_matches_the_cpu(cuda_device, name):
    """Forward, input and parameter gradients (and BN's new running
    moments) of each layer on the card against the same layer on the
    CPU, f32 within 1e-5 of each result's max abs."""
    layer, shape = _layer_case(name)
    r = np.random.RandomState(5)
    x = (r.randn(*shape) + (0.1 if "pnorm" in name else 0.0)).astype(
        np.float32)
    params = {k: (0.5 * r.randn(*s)).astype(np.float32)
              for k, s in layer.param_shapes().items()}
    state = {k: v.numpy() for k, v in layer.init_state().items()}
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        p = {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in params.items()}
        xt = torch.tensor(x, device=dev, requires_grad=True)
        st = {k: torch.tensor(v, device=dev) for k, v in state.items()}
        out, new_state = layer.forward(p, xt, st, train=True)
        g = torch.tensor(np.random.RandomState(6).randn(*out.shape).astype(
            np.float32), device=dev)
        grads = torch.autograd.grad((out * g).sum(), [xt] + list(p.values()))
        results.append([out] + list(grads)
                       + [new_state[k] for k in sorted(new_state)])
    for got, want in zip(*results):
        got, want = got.detach().cpu(), want.detach()
        scale = want.abs().max().clamp(min=1e-30)
        assert (got - want).abs().max() <= 1e-5 * scale, name


@pytest.mark.cuda
def test_channels_last_max_pool_ties_route_like_the_cpu(cuda_device):
    """A blank image ties in every pooling window; the card's
    channels_last max-pool must route each window's gradient to the same
    (first) element as the CPU's, which is the JAX package's choice."""
    from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer
    layer = SubsamplingLayer(pooling_type="max")
    x = np.zeros((4, 24, 24, 20), np.float32)
    x[:, 5, 7, :] = 0.25
    g = np.random.RandomState(0).rand(4, 12, 12, 20).astype(np.float32) + 1
    dx = []
    for dev in (cuda_device, torch.device("cpu")):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        assert xt.permute(0, 3, 1, 2).is_contiguous(
            memory_format=torch.channels_last)
        out, _ = layer.forward({}, xt, {})
        (d,) = torch.autograd.grad((out * torch.tensor(g, device=dev)).sum(),
                                   xt)
        dx.append(d.cpu())
    assert torch.equal(dx[0], dx[1])
    assert (dx[1][:, 0::2, 0::2][:, :2, :3] != 0).all()


def _card_lenet(device, seed=12345):
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    return MultiLayerNetwork(zoo.lenet_mnist(seed=seed), device=device).init()


def _lenet_batches(n, rows=32, seed=0):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    r = np.random.RandomState(seed)
    return [DataSet(r.rand(rows, 28, 28, 1).astype(np.float32),
                    np.eye(10, dtype=np.float32)[r.randint(0, 10, rows)])
            for _ in range(n)]


@pytest.mark.cuda
def test_lenet_window_graph_replays_bit_identically(cuda_device,
                                                    monkeypatch):
    """LeNet's whole batch step is one captured graph: two nets from the
    same parameters through the fused loop capture once each and end
    bit-identical, and a replay with zero example weight changes
    nothing."""
    torch.backends.cudnn.deterministic = True
    try:
        batches = _lenet_batches(6)
        a, b = _card_lenet(cuda_device), _card_lenet(cuda_device)
        b.set_params(a.params())
        _card_fit(a, batches, monkeypatch, 4)
        _card_fit(b, batches, monkeypatch, 4)
        assert a._fused.captures == b._fused.captures == 1
        np.testing.assert_array_equal(a.params(), b.params())
        (win,) = a._fused.graphs.values()
        before = a.params()
        win.ew.zero_()
        win.graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(a.params(), before)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_lenet_archive_restores_on_the_card(cuda_device, tmp_path,
                                            monkeypatch):
    """A LeNet trained on the card, written and restored on the card,
    gives the same outputs to the bit; the committed reference archives
    reproduce their recorded outputs on the card within 1e-5."""
    import os
    from deeplearning4j_tpu_torch.utils import model_serializer
    net = _card_fit(_card_lenet(cuda_device), _lenet_batches(4),
                    monkeypatch, 4)
    path = str(tmp_path / "lenet.zip")
    model_serializer.write_model(net, path)
    again = model_serializer.restore_multi_layer_network(path)
    assert again.device.type == "cuda"
    x = _lenet_batches(1, rows=16, seed=9)[0].features
    np.testing.assert_array_equal(again.output(x), net.output(x))
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "checkpoints")
    for name in ("convbn_r3", "lstm_r3"):
        card = model_serializer.restore_model(
            os.path.join(fixtures, f"{name}.zip"))
        with np.load(os.path.join(fixtures, f"{name}_expected.npz")) as z:
            np.testing.assert_allclose(card.output(z["probe"]), z["out"],
                                       atol=1e-5)


# card against CPU for a ResNet: cuDNN and the CPU sum each conv's
# products in another order (TF32 off), and every BatchNormalization
# divides by its batch's spread, which carries a difference on to the
# layers above; the same 1e-4 of each leaf's max abs as the train phase's
# gradient bar (BN's running mean: of the larger of its max abs and the
# data's spread, the square root of the running variance)
CNN_CARD_CPU_RTOL = 1e-4


@pytest.mark.cuda
def test_narrow_resnet_on_card_matches_cpu(cuda_device):
    """The narrow ResNet (two stages of one block, 32x32, 5 classes)
    takes 3 f32 ``fit`` steps on the card and on the CPU from the same
    parameters: outputs, parameters and BatchNormalization's running
    moments agree within ``CNN_CARD_CPU_RTOL``."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    conf = zoo.resnet50(n_classes=5, height=32, width=32, stages=(1, 1))
    card = ComputationGraph(conf, device=cuda_device).init()
    cpu = ComputationGraph(conf, device="cpu").init(params=card.params())
    r = np.random.RandomState(0)
    batches = [DataSet(r.randn(8, 32, 32, 3).astype(np.float32),
                       np.eye(5, dtype=np.float32)[r.randint(0, 5, 8)])
               for _ in range(3)]
    for net in (card, cpu):
        net.fit(ListDataSetIterator(batches))
    x = batches[0].features

    def rel(got, want):
        return float(np.abs(got - want).max() /
                     max(np.abs(want).max(), 1e-30))
    assert rel(card.output(x), cpu.output(x)) <= CNN_CARD_CPU_RTOL
    for g, w in zip(card.params_list, cpu.params_list):
        for k in w:
            assert rel(g[k].detach().cpu().numpy(),
                       w[k].detach().numpy()) <= CNN_CARD_CPU_RTOL, k
    for name, g, w in zip(card.layer_names, card.states_list,
                          cpu.states_list):
        if not w:
            continue
        gv, wv = g["var"].cpu().numpy(), w["var"].numpy()
        assert rel(gv, wv) <= CNN_CARD_CPU_RTOL, name
        spread = max(float(np.sqrt(wv.max())), float(np.abs(w["mean"]).max()))
        err = float(np.abs(g["mean"].cpu().numpy() - w["mean"].numpy()).max())
        assert err <= CNN_CARD_CPU_RTOL * spread, name


# ---------------------------------------------------------------------------
# generation serving on the card: decode, admit and prefill programs
# captured as CUDA graphs over a slot pool
# ---------------------------------------------------------------------------
def _card_lm(cuda_device, compute_dtype=None, **kw):
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    conf = dict(vocab_size=96, max_len=64, d_model=32, n_heads=4,
                n_layers=2, d_ff=64, seed=1, compute_dtype=compute_dtype)
    conf.update(kw)
    lm = TransformerLM(TransformerConfig(**conf), device=cuda_device).init()
    with torch.no_grad():
        for p in lm.parameters():
            if p.ndim > 1:
                p.mul_(10.0)
    return lm


def _admitted_state(lm, S, rows):
    """A decode state with ``rows`` (slot, prompt, n_new, temperature,
    top_k, top_p, seed) admitted through the admit program, eagerly."""
    from deeplearning4j_tpu_torch.models.transformer import admit_record
    state = lm._init_decode_state(S, seed=3)
    admit = lm._admit_fn(S)
    for slot, prompt, n_new, temp, k, p, seed in rows:
        rec = admit_record(lm.conf, slot, prompt, len(prompt), n_new, temp,
                           k, p, True, seed)
        with torch.no_grad():
            admit(state, torch.tensor(rec, device=lm.device))
    return state


def _clone_state(state):
    return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
            for k, v in state.items()}


def _load_state(dst, src):
    for k, v in src.items():
        for a, b in zip(dst[k] if isinstance(v, list) else [dst[k]],
                        v if isinstance(v, list) else [v]):
            a.copy_(b)


def _states_equal(a, b):
    for k, v in a.items():
        for x, y in zip(v if isinstance(v, list) else [v],
                        b[k] if isinstance(v, list) else [b[k]]):
            assert torch.equal(x, y), k


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("mode", ["greedy", "sample", "filter"])
@pytest.mark.parametrize("window", [32, 64])
def test_decode_graph_replay_equals_the_eager_step(cuda_device, window,
                                                   mode, compute_dtype):
    """Each decode rung and sampler variant, replayed from its captured
    graph over a slot pool, leaves the pool bit-equal to the eager chunk
    on a copy of the same state."""
    from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph
    lm = _card_lm(cuda_device, compute_dtype)
    S = 4
    base = _admitted_state(lm, S, [
        (0, [5, 9, 2], 20, 0.0, 96, 1.0, 0),
        (1, [7, 1, 4, 4, 8, 3], 20, 0.9, 96 if mode != "filter" else 7,
         0.8 if mode == "filter" else 1.0, 11),
        (3, [3], 20, 1.2, 96, 1.0, 12)])
    step = lm._build_decode_step(S, 4, window, mode)
    pool = _clone_state(base)
    graph = StaticGraph(lambda: step(lm.params, pool), cuda_device,
                        torch.cuda.graph_pool_handle())
    assert graph() is True            # the first call runs and captures
    eager = _clone_state(base)
    _load_state(pool, base)
    for _ in range(3):
        graph()
        with torch.no_grad():
            step(lm.params, eager)
    torch.cuda.synchronize()
    _states_equal(pool, eager)
    assert int(pool["pos"][1]) == 12


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("window", [16, 64])
def test_prefill_graph_replay_equals_the_eager_program(cuda_device, window,
                                                       inject):
    from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph
    from deeplearning4j_tpu_torch.models.transformer import prefill_record
    lm = _card_lm(cuda_device, "bfloat16", pos_embed="rope")
    c, S = lm.conf, 2
    prompt = np.arange(1, 41) % 95
    base = _admitted_state(lm, S, [(1, prompt, 4, 0.0, 96, 1.0, 0)])
    shape = (c.n_layers, c.kv_heads, window, c.d_model // c.n_heads)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    pages = [torch.randn(shape, generator=g, device=cuda_device).to(
        torch.bfloat16) for _ in range(2)] + [
        torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
        for _ in range(2)]
    eager_pages = [p.clone() for p in pages]
    n = min(window, 39)
    stage = torch.tensor(prefill_record(1, prompt[:n], 0, n, n == 39,
                                        window), device=cuda_device)
    fn = lm._build_prefill(S, window, inject)
    pool = _clone_state(base)
    graph = StaticGraph(lambda: fn(lm.params, pool, stage, *pages),
                        cuda_device)
    graph()
    _load_state(pool, base)
    for p in pages[2:]:
        p.zero_()
    graph()
    eager = _clone_state(base)
    with torch.no_grad():
        fn(lm.params, eager, stage, *eager_pages)
    torch.cuda.synchronize()
    _states_equal(pool, eager)
    for a, b in zip(pages, eager_pages):
        assert torch.equal(a, b)
    assert int(pool["pos"][1]) == n


@pytest.mark.cuda
def test_generate_and_beam_replays_equal_their_first_call(cuda_device):
    lm = _card_lm(cuda_device, "bfloat16")
    prompt = np.random.RandomState(0).randint(0, 96, (2, 9))
    first = lm.generate(prompt, 12, temperature=0.0)
    again = lm.generate(prompt, 12, temperature=0.0)
    np.testing.assert_array_equal(first, again)
    sampled = [lm.generate(prompt, 12, temperature=1.0, top_k=20, seed=s)
               for s in (4, 4, 5)]
    np.testing.assert_array_equal(sampled[0], sampled[1])
    assert not np.array_equal(sampled[0], sampled[2])
    beams = [lm.beam_search(prompt, 8, beams=3) for _ in range(2)]
    np.testing.assert_array_equal(beams[0], beams[1])
    assert len(lm._jit_gen) == 3
    assert all(p.graph.graph is not None for p in lm._jit_gen.values())


@pytest.mark.cuda
def test_restarted_server_replays_graphs_bound_to_its_new_pool(cuda_device):
    """stop() drops the pool and its graphs; after start() the server
    captures new graphs over a new pool, and serves the same tokens as
    before (a graph left bound to the dropped pool would write into
    storage no one reads)."""
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import ContinuousLM
    lm = _card_lm(cuda_device)
    srv = ContinuousLM(lm, slots=4, chunk=4, device=cuda_device,
                       kv_ladder=(32, 64), prefill_ladder=(16,))
    ps = [np.arange(1, 1 + n) % 95 for n in (5, 30, 3, 17, 9)]
    try:
        srv.warm_start()
        old_pool = srv._pool
        old_ptr = old_pool.state["out"].data_ptr()
        first = [f.result(120) for f in [srv.submit(p, 10) for p in ps]]
        srv.stop()
        assert srv._pool is None
        del old_pool
        # reuse the dropped pool's memory for something else
        filler = [torch.full((1 << 20,), 7, device=cuda_device)
                  for _ in range(8)]
        srv.start()
        before = capture_count()
        again = [f.result(120) for f in [srv.submit(p, 10) for p in ps]]
        assert capture_count() > before
        assert filler[0].data_ptr() != old_ptr
    finally:
        srv.stop()
    for a, b, p in zip(first, again, ps):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, lm.generate(p[None, :], 10, temperature=0.0)[0])


# ---------------------------------------------------------------------------
# head dims above the kernels' limit, the router's replicas on one card,
# Word2Vec's device route, and the narrow ResNet after serving
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_head_dim_above_256_is_refused_on_card(cuda_device):
    """d 257 raises at the kernels' boundary, naming the limit, for the
    forward and the backward; nothing falls back to a twin."""
    q = torch.zeros((4, 16, 257), device=cuda_device)
    k = torch.zeros((2, 16, 257), device=cuda_device)
    before = (flash_attention.launches, flash_attention.dq_launches,
              flash_attention.dkv_launches)
    with pytest.raises(ValueError, match="MAX_HEAD_DIM = 256"):
        _flash_forward(q, k, k, causal=True, window=None, kv_group=2)
    lse = torch.zeros((4, 16), device=cuda_device)
    with pytest.raises(ValueError, match="MAX_HEAD_DIM = 256"):
        _kernel_backward(q, k, k, q, lse, q, causal=True, window=None,
                         kv_group=2)
    assert (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches) == before


def _serve_replicas(cuda_device, n=2, **kw):
    from deeplearning4j_tpu_torch.serving import ContinuousLM
    lm = _card_lm(cuda_device)
    return lm, [ContinuousLM(lm, slots=4, chunk=4, device=cuda_device,
                             kv_ladder=(32, 64), prefill_ladder=(16,), **kw)
                for _ in range(n)]


@pytest.mark.cuda
def test_a_capture_on_one_replica_while_the_other_replays(cuda_device):
    """Replica A replays its graphs on its own stream while replica B,
    never warm-started, captures its whole inventory on its first
    requests (thread-local capture mode): both give generate()'s rows."""
    import threading
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    lm, (a, b) = _serve_replicas(cuda_device)
    ps = [np.arange(1, 1 + n) % 95 for n in (5, 30, 3, 17, 9, 12, 2, 21)]
    stop, rows_a, errors = threading.Event(), [], []
    try:
        a.warm_start()
        a.submit(ps[0], 10).result(120)

        def replay():
            try:
                while not stop.is_set():
                    rows_a.extend((p, f.result(120)) for p, f in
                                  [(p, a.submit(p, 10)) for p in ps[:4]])
            except Exception as e:      # surfaced by the assert below
                errors.append(e)
        t = threading.Thread(target=replay, daemon=True)
        t.start()
        before = capture_count()
        rows_b = [(p, f.result(120)) for p, f in
                  [(p, b.submit(p, 10)) for p in ps]]
        assert capture_count() > before      # B captured while A served
        stop.set()
        t.join(120)
        assert not errors, errors
    finally:
        stop.set()
        a.stop()
        b.stop()
    assert rows_a
    for p, row in rows_a + rows_b:
        np.testing.assert_array_equal(
            row, lm.generate(p[None, :], 10, temperature=0.0)[0])


@pytest.mark.cuda
def test_two_replicas_with_one_killed_lose_nothing(cuda_device):
    """Two warm replicas behind the router, replica 0 killed at its first
    dispatch of a burst: the admitted ones fail typed, the rest complete
    on the survivor with generate()'s rows, and nothing is captured."""
    from deeplearning4j_tpu_torch.errors import ServeReplicaDeadError
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.serving import ReplicaRouter
    from deeplearning4j_tpu_torch.testing import faults
    lm, reps = _serve_replicas(cuda_device)
    router = ReplicaRouter(reps, heartbeat_s=0.05, slo_ms=0.0)
    ps = [np.arange(1, 1 + n) % 95 for n in (5, 30, 3, 17, 9, 12, 2, 21) * 2]
    try:
        router.warm_start()
        router.submit(ps[0], 10).result(120)
        before = capture_count()
        with faults.inject("kill-replica[0]@0"):
            futs = [(p, router.submit(p, 10)) for p in ps]
            done, dead = [], 0
            for p, f in futs:
                try:
                    done.append((p, f.result(120)))
                except ServeReplicaDeadError:
                    dead += 1
        assert dead >= 1 and len(done) + dead == len(ps)
        assert capture_count() == before
        assert router.healthy_count() == 1
    finally:
        router.stop()
    for p, row in done:
        np.testing.assert_array_equal(
            row, lm.generate(p[None, :], 10, temperature=0.0)[0])


@pytest.mark.cuda
def test_word2vec_sorted_route_repeats_bitwise_on_card(cuda_device):
    """Two negative-sampling fits from one seed on the card, sorted
    scatter: the same table bits; the second fit replays every graph."""
    from deeplearning4j_tpu_torch.models._cuda_graph import capture_count
    from deeplearning4j_tpu_torch.nlp import lookup
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    rng = np.random.RandomState(0)
    p = 1.0 / np.arange(1, 201)
    ids = rng.choice(200, 30_000, p=p / p.sum())
    sents = [" ".join(f"w{i}" for i in ids[j:j + 100])
             for j in range(0, len(ids), 100)]
    lookup.set_scatter_impl("sorted")
    try:
        w = Word2Vec(layer_size=32, window=5, negative=5,
                     use_hierarchic_softmax=False, min_word_frequency=1,
                     sampling=1e-3, batch_size=2048, seed=42,
                     device=cuda_device)
        w.fit_corpus(sents)
        first = w.lookup_table.syn0.clone()
        w.build_vocab(s.split() for s in sents)
        before = capture_count()
        w.fit_corpus(sents)
        assert capture_count() == before
        assert torch.equal(w.lookup_table.syn0, first)
        assert bool(torch.isfinite(first).all()) and float(first.std()) > 1e-3
        draws = [w._draw_negatives(0, 0, 1, 64) for _ in range(2)]
        assert not torch.equal(draws[0], draws[1])
    finally:
        lookup.set_scatter_impl(None)


@pytest.mark.cuda
def test_a_registered_generator_draws_anew_on_every_replay(cuda_device):
    """A graph that draws from a generator of its own (registered with
    the capture, as Word2Vec's negatives): each replay draws anew, and a
    reseed makes the replays repeat."""
    from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph
    gen = torch.Generator(device=cuda_device)
    out = torch.zeros(4096, dtype=torch.int64, device=cuda_device)

    def draw():
        out.copy_(torch.randint(0, 1 << 30, (4096,), generator=gen,
                                device=cuda_device))
    graph = StaticGraph(draw, cuda_device, generators=(gen,))
    assert graph()                    # the first call captures
    runs = []
    for seed in (5, 5):
        gen.manual_seed(seed)
        for _ in range(3):
            assert not graph()        # a replay
            runs.append(out.clone())
    assert not torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[1], runs[2])
    for a, b in zip(runs[:3], runs[3:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_narrow_resnet_after_a_decode_burst_matches_cpu(cuda_device):
    """A decode burst through ContinuousLM (captured graphs, their memory
    pool, a stream of its own) and then the narrow ResNet's 3 f32 steps,
    in one process: within CNN_CARD_CPU_RTOL of the CPU, as alone."""
    lm, (srv,) = _serve_replicas(cuda_device, n=1)
    try:
        srv.warm_start()
        for f in [srv.submit(np.arange(1, 1 + n) % 95, 10)
                  for n in (5, 30, 3, 17)]:
            f.result(120)
    finally:
        srv.stop()
    test_narrow_resnet_on_card_matches_cpu(cuda_device)


def _attention_net(compute, device, t=64):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (RnnOutputLayer,
                                                    SelfAttentionLayer)
    conf = (NeuralNetConfiguration.Builder().seed(5).compute_dtype(compute)
            .list()
            .layer(SelfAttentionLayer(n_in=64, n_out=64, n_heads=2,
                                      causal=True))
            .layer(SelfAttentionLayer(n_in=64, n_out=64, n_heads=4,
                                      residual=True))
            .layer(RnnOutputLayer(n_in=64, n_out=6, activation="softmax",
                                  loss="mcxent"))
            .build())
    r = np.random.RandomState(1)
    x = r.randn(4, t, 64).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[r.randint(0, 6, (4, t))]
    return MultiLayerNetwork(conf, device=device).init(), x, y


def _rel(got, want):
    got, want = (torch.as_tensor(a).float().cpu() for a in (got, want))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_attention_layer_kernels_match_builtin_path(cuda_device,
                                                    monkeypatch):
    from deeplearning4j_tpu_torch.nn import helpers
    net, x, y = _attention_net("float32", cuda_device)
    launches = (flash_attention.launches, flash_attention.dq_launches,
                flash_attention.dkv_launches)
    declined = helpers.declines("SelfAttentionLayer")
    out = net.output(x)
    grads, score = net.compute_gradient_and_score(x, y)
    assert (flash_attention.launches - launches[0],
            flash_attention.dq_launches - launches[1],
            flash_attention.dkv_launches - launches[2]) == (4, 2, 2)
    assert helpers.declines("SelfAttentionLayer") == declined
    monkeypatch.setenv("DL4J_TPU_DISABLE_HELPERS", "1")
    want = net.output(x)
    want_g, want_s = net.compute_gradient_and_score(x, y)
    assert _rel(out, want) <= 1e-5
    assert abs(score - want_s) <= 1e-5 * abs(want_s)
    for g, w in zip(grads, want_g):
        for k in w:
            assert _rel(g[k], w[k]) <= 1e-5, k


@pytest.mark.cuda
def test_attention_helper_declines_a_mask_on_card(cuda_device, monkeypatch):
    from deeplearning4j_tpu_torch.nn import helpers
    net, x, _ = _attention_net("bfloat16", cuda_device)
    mask = np.ones(x.shape[:2], np.float32)
    mask[1, 40:] = 0.0
    launches = flash_attention.launches
    declined = helpers.declines("SelfAttentionLayer")
    got = net.output(x, fmask=mask)
    assert flash_attention.launches == launches
    assert helpers.declines("SelfAttentionLayer") == declined + 2
    monkeypatch.setenv("DL4J_TPU_DISABLE_HELPERS", "1")
    assert np.array_equal(got, net.output(x, fmask=mask))


KERAS_DIR = __import__("pathlib").Path(__file__).resolve().parent / \
    "fixtures" / "keras"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lenet_k1_tf.h5", "residual_k1_th.h5",
                                  "lstm_k2_charrnn.h5",
                                  "resnet50_narrow_k1_tf.h5"])
def test_keras_fixture_on_card_matches_cpu(cuda_device, name):
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_model_and_weights
    r = np.random.RandomState(2)
    x = {"lenet_k1_tf.h5": lambda: r.rand(16, 28, 28, 1),
         "resnet50_narrow_k1_tf.h5": lambda: r.rand(2, 224, 224, 3),
         "residual_k1_th.h5": lambda: r.randn(8, 8, 8, 4),
         "lstm_k2_charrnn.h5": lambda: np.eye(65)[r.randint(0, 65,
                                                            (8, 50))]}[
        name]().astype(np.float32)
    path = str(KERAS_DIR / name)
    card = import_keras_model_and_weights(path, device=cuda_device)
    cpu = import_keras_model_and_weights(path, device="cpu")
    np.testing.assert_array_equal(card.params(), cpu.params())
    seq = port_lc.lstm_sequence.launches
    got = card.output(x)
    if name.startswith("lstm"):
        assert port_lc.lstm_sequence.launches == seq + 1
    assert _rel(got, cpu.output(x)) <= 1e-5


def _card_rnn_graph(device, dropout=0.0):
    """A DAG char-RNN on the card: two GravesLSTM vertices, a skip merge,
    tBPTT windows of 10."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import layers as L
    conf = (NeuralNetConfiguration.Builder().seed(0).learning_rate(0.01)
            .updater("rmsprop").graph_builder().add_inputs("in")
            .add_layer("l1", L.GravesLSTM(n_in=20, n_out=32,
                                          activation="tanh"), "in")
            .add_layer("l2", L.GravesLSTM(n_in=32, n_out=32,
                                          activation="tanh",
                                          dropout=dropout), "l1")
            .add_vertex("skip", pgraph.MergeVertex(), "l1", "l2")
            .add_layer("out", L.RnnOutputLayer(n_in=64, n_out=20,
                                               activation="softmax",
                                               loss="mcxent"), "skip")
            .set_outputs("out").backprop_type("tbptt").tbptt_fwd_length(10)
            .tbptt_back_length(10).build())
    return ComputationGraph(conf, device=device).init()


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.8])
def test_graph_window_replay_equals_its_eager_step_on_card(cuda_device,
                                                           monkeypatch,
                                                           dropout):
    """A graph's tBPTT window captured once and replayed (the fused loop
    at K 4) against the same windows run eagerly on the card (the
    per-batch loop at K 1) from the same parameters: the same bits, the
    same draw counter; one window signature, captured once."""
    batches = _card_batches(6, 30, seed=7)
    fused = _card_rnn_graph(cuda_device, dropout)
    plain = _card_rnn_graph(cuda_device, dropout)
    plain.set_params(fused.params())
    _card_fit(fused, batches, monkeypatch, 4)
    _card_fit(plain, batches, monkeypatch, 1)
    assert fused._fused.captures == len(fused._fused.graphs) == 1
    assert plain._fused is None
    np.testing.assert_array_equal(fused.params(), plain.params())
    assert fused.dropout_draws == plain.dropout_draws == 6 * 3


@pytest.mark.cuda
def test_dropout_counter_in_a_captured_graph_advances_and_reverts(
        cuda_device, monkeypatch):
    """The draw counter inside a captured window graph: a replay with real
    example weights advances it by one, as an eager step does, and draws
    the eager step's masks (the same parameters after); a replay with
    zero weights (a padding or probe step) leaves it, and every other
    state, where it was."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    conf = zoo.char_rnn(vocab_size=20, hidden=32, tbptt_length=30,
                        learning_rate=0.01)
    conf.layers[1].dropout = 0.5
    a = MultiLayerNetwork(conf, device=cuda_device).init()
    b = MultiLayerNetwork(conf, device=cuda_device).init()
    b.set_params(a.params())
    batches = _card_batches(2, 30, seed=8)
    _card_fit(a, batches[:1], monkeypatch, 4)    # captures, one update
    _card_fit(b, batches[:1], monkeypatch, 1)    # eagerly
    assert a.dropout_draws == b.dropout_draws == 1
    np.testing.assert_array_equal(a.params(), b.params())
    (win,) = a._fused.graphs.values()
    before, draws = a.params(), a.dropout_draws
    win.ew.zero_()
    win.graph.replay()
    torch.cuda.synchronize()
    assert a.dropout_draws == draws
    np.testing.assert_array_equal(a.params(), before)
    _card_fit(a, batches[1:], monkeypatch, 4)    # a replay, real weights
    _card_fit(b, batches[1:], monkeypatch, 1)
    assert a._fused.captures == 1
    assert a.dropout_draws == b.dropout_draws == 2
    np.testing.assert_array_equal(a.params(), b.params())


# ---------------------------------------------------------------------------
# layer-wise pretraining, the gradient checker, k-means and t-SNE on the
# card
# ---------------------------------------------------------------------------
def _pretrain_net(device, layer):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    conf = (NeuralNetConfiguration.Builder().seed(3).updater("rmsprop")
            .learning_rate(1e-2).list().layer(layer).pretrain(True).build())
    return MultiLayerNetwork(conf, device=device).init()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["autoencoder", "rbm", "vae"])
def test_pretrain_step_on_card_matches_cpu(cuda_device, monkeypatch, kind):
    """Two pretrain steps of each pretrain layer on the card and on the
    CPU from the same parameters and the same draws (injected through the
    ``_uniform``/``_normal`` seam): f32 parameters within 1e-5 of their
    max abs (a binary unit sampled with u far from p: the draws are 0 or
    1, so no decision can round the other way)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.layers import pretrain as ppre
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM, AutoEncoder, VariationalAutoencoder)
    make = {"autoencoder": lambda: AutoEncoder(n_in=40, n_out=24,
                                               activation="sigmoid"),
            "rbm": lambda: RBM(n_in=40, n_out=24, k=2),
            "vae": lambda: VariationalAutoencoder(
                n_in=40, n_out=3, encoder_layer_sizes=(32, 16),
                decoder_layer_sizes=(16,), activation="leakyrelu")}[kind]
    r = np.random.RandomState(5)
    x = (r.rand(16, 40) > 0.5).astype(np.float32)
    draws = {"u": [r.rand(16, 40) < 0.5 for _ in range(12)],
             "n": [r.randn(16, 3).astype(np.float32) for _ in range(4)]}

    def seam(kind_, shape, like):
        arr = draws[kind_].pop(0)
        if kind_ == "u":
            arr = np.where(arr[:, :shape[1]], 0.0, 1.0)
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    out = {}
    for device in (cuda_device, "cpu"):
        saved = {k: list(v) for k, v in draws.items()}
        monkeypatch.setattr(ppre, "_uniform",
                            lambda g, shape, like: seam("u", shape, like))
        monkeypatch.setattr(ppre, "_normal",
                            lambda g, shape, like: seam("n", shape, like))
        net = _pretrain_net(device, make())
        if device == "cpu":
            net.set_params(out[cuda_device][1])
        start = net.params()
        net.pretrain_layer(0, [DataSet(x, None), DataSet(x[::-1].copy(),
                                                         None)])
        out[device] = (net.params(), start)
        draws = saved
    card, cpu = out[cuda_device][0], out["cpu"][0]
    assert np.abs(card - cpu).max() <= 1e-5 * np.abs(cpu).max()
    assert not np.array_equal(card, out[cuda_device][1])


@pytest.mark.cuda
def test_gradient_check_on_card_in_float64(cuda_device):
    """The checker's float64 copies live on the card: an MLP passes and
    its analytic gradient is the CPU's within 1e-12; a GravesLSTM net's
    check raises the kernels' TypeError rather than reach a twin."""
    from deeplearning4j_tpu_torch.gradientcheck import (
        gradient_check_util as gc)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration as B)
    from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, GravesLSTM,
                                                    OutputLayer,
                                                    RnnOutputLayer)
    r = np.random.RandomState(0)
    conf = (B.Builder().seed(1).list()
            .layer(DenseLayer(n_in=4, n_out=6, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax")).build())
    x, y = r.randn(5, 4), np.eye(3)[r.randint(0, 3, 5)]
    card = MultiLayerNetwork(conf, device=cuda_device).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.set_params(card.params())
    assert gc.check_gradients(card, x, y)[0]
    fn, vec = gc._mln_loss(card, x, y)
    assert vec.is_cuda and vec.dtype == torch.float64
    g_card = gc.analytic_gradient(fn, vec)
    g_cpu = gc.analytic_gradient(*gc._mln_loss(cpu, x, y))
    assert np.abs(g_card - g_cpu).max() <= 1e-12 * np.abs(g_cpu).max()
    lstm = (B.Builder().seed(1).list()
            .layer(GravesLSTM(n_in=3, n_out=4, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, activation="softmax")).build())
    net = MultiLayerNetwork(lstm, device=cuda_device).init()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gc.check_gradients(net, r.randn(2, 3, 3),
                           np.eye(2)[r.randint(0, 2, (2, 3))])


@pytest.mark.cuda
def test_kmeans_and_tsne_on_card_match_cpu(cuda_device):
    """k-means on the card gives the CPU's assignments and centres (1e-5
    of their scale); 30 exact t-SNE iterations on the card stay within
    1e-3 of the CPU's embedding scale (f32, early exaggeration's
    expansion)."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.plot import Tsne
    r = np.random.RandomState(2)
    x = np.concatenate([r.randn(60, 8) + 4 * c for c in range(3)]) \
        .astype(np.float32)
    sets = [KMeansClustering(3, seed=1, device=d).apply_to(x)
            for d in (cuda_device, "cpu")]
    a, b = (s.get_centers() for s in sets)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for ca, cb in zip(sets[0].clusters, sets[1].clusters):
        assert [p.id for p in ca.points] == [p.id for p in cb.points]
    ys = [Tsne(max_iter=30, perplexity=10.0, learning_rate=20.0, seed=3,
               device=d).fit(x) for d in (cuda_device, "cpu")]
    assert np.abs(ys[0] - ys[1]).max() <= 1e-3 * np.abs(ys[1]).max()


def _tree_rel(got, want):
    from deeplearning4j_tpu_torch.models.transformer import _flatten
    got, want = _flatten(got), _flatten(want)
    return max(((got[k].cpu() - w).abs().max()
                / w.abs().max().clamp(min=1e-30)).item()
               for k, w in want.items())


def _launch_counts():
    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches)


@pytest.mark.cuda
def test_vit_on_card_matches_cpu(cuda_device):
    from deeplearning4j_tpu_torch.models.transformer import params_from_numpy
    from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
    conf = ViTConfig(image_size=28, n_channels=3, patch_size=4, n_classes=7,
                     d_model=64, n_heads=4, n_layers=2, d_ff=128)
    cpu = ViT(conf, device="cpu").init()
    card = ViT(conf, device=cuda_device)
    card.params = params_from_numpy(
        {k: {kk: vv.detach().numpy() for kk, vv in v.items()}
         if hasattr(v, "items") else v.detach().numpy()
         for k, v in cpu.params.items()}, cuda_device)
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.rand(3, 28, 28, 3).astype(np.float32))
    y = cpu._device_labels(r.randint(0, 7, 3))
    assert _rel(card.output(x), cpu.output(x)) <= 1e-5
    before = _launch_counts()
    loss, grads = card._value_and_grad(x.to(cuda_device), y.to(cuda_device))
    assert [a - b for a, b in zip(_launch_counts(), before)] == [2, 2, 2]
    want_loss, want = cpu._value_and_grad(x, y)
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    assert _tree_rel(grads, want) <= 1e-5


@pytest.mark.cuda
def test_moe_on_card_matches_cpu(cuda_device, monkeypatch):
    from deeplearning4j_tpu_torch.models import moe_transformer as mt
    from deeplearning4j_tpu_torch.models.transformer import params_from_numpy
    conf = mt.MoETransformerConfig(vocab_size=64, max_len=40, d_model=32,
                                   n_heads=4, n_layers=2, d_ff=64,
                                   block_size=16, n_experts=4, moe_every=1,
                                   router_top_k=2, seed=1)
    cpu = mt.MoETransformerLM(conf, device="cpu").init()
    card = mt.MoETransformerLM(conf, device=cuda_device)
    card.params = params_from_numpy(
        {k: {kk: vv.detach().numpy() for kk, vv in v.items()}
         if hasattr(v, "items") else v.detach().numpy()
         for k, v in cpu.params.items()}, cuda_device)
    routes = []
    real = mt.moe_ffn_dense

    def spy(bp, h, n_experts, top_k=1):
        routes.append((h @ bp["gate"]).float().argmax(-1).cpu())
        return real(bp, h, n_experts, top_k)
    monkeypatch.setattr(mt, "moe_ffn_dense", spy)
    toks = np.random.RandomState(4).randint(0, 64, (2, 33))
    got, want = card.output(toks), cpu.output(toks)
    assert all(torch.equal(a, b) for a, b in zip(routes[:2], routes[2:]))
    assert _rel(got, want) <= 1e-5
    t = torch.from_numpy(toks.astype(np.int64))
    before = _launch_counts()
    loss, grads = card._value_and_grad(t[:, :-1].to(cuda_device),
                                       t[:, 1:].to(cuda_device), None)
    assert [a - b for a, b in zip(_launch_counts(), before)] == [2, 2, 2]
    want_loss, want_g = cpu._value_and_grad(t[:, :-1], t[:, 1:], None)
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    assert _tree_rel(grads, want_g) <= 1e-4


# ---- data parallelism on the card ---------------------------------------
def _dp_mlp(device):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    conf = (NeuralNetConfiguration.Builder().seed(12).learning_rate(0.05)
            .updater("adam").list()
            .layer(DenseLayer(n_in=16, n_out=32, activation="tanh"))
            .layer(OutputLayer(n_out=8, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _dp_stream():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    return X, np.eye(8, dtype=np.float32)[rng.integers(0, 8, 64)]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_rank(rank, port, out):
    """One of two gloo ranks on cuda:0: the MLP through ParallelWrapper at
    each level; rank 0 writes the parameters."""
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    X, Y = _dp_stream()
    got = {}
    for lv in (0, 1, 2, 3):
        net = _dp_mlp(dev)
        ParallelWrapper(net, dp_shard=lv, device=dev).fit(
            ArrayDataSetIterator(X, Y, batch_size=16), epochs=2)
        got[f"level{lv}"] = net.params()
    if rank == 0:
        np.savez(out, **got)
    multihost.shutdown()


@pytest.mark.cuda
def test_world1_nccl_levels_equal_unsharded_on_card(cuda_device):
    """A world of one rank over NCCL on the card: every level's steps are
    the unsharded steps (a width-1 plan skips every collective and
    slice), losses and parameters bit for bit, for a narrow LM."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, _flatten)
    from deeplearning4j_tpu_torch.parallel import multihost
    conf = TransformerConfig(vocab_size=64, d_model=32, n_heads=2, d_ff=64,
                             n_layers=2, max_len=32, block_size=16, seed=3)
    toks = np.random.RandomState(5).randint(0, 64, (8, 33))
    ref = TransformerLM(conf, device=cuda_device).init()
    want = [float(ref.fit_batch(toks)) for _ in range(2)]
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                         device=cuda_device)
    try:
        import torch.distributed as dist
        assert dist.get_backend() == "nccl"
        for lv in (0, 1, 2, 3):
            lm = TransformerLM(conf, device=cuda_device).init().shard(
                level=lv, device=cuda_device)
            assert [float(lm.fit_batch(toks)) for _ in range(2)] == want
            for k, v in _flatten(ref.params).items():
                assert torch.equal(_flatten(lm.params)[k], v), (lv, k)
    finally:
        multihost.shutdown()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_world1(cuda_device, tmp_path):
    """Two processes over gloo, both on cuda:0, train the MLP through
    ParallelWrapper at each level; rank 0's parameters equal one process's
    unsharded run within 1e-5 of the parameters' max abs (the reduction
    tree differs), and levels 1 and 2 agree bit for bit."""
    import os
    import subprocess
    import sys
    from deeplearning4j_tpu_torch.datasets.dataset import ArrayDataSetIterator
    X, Y = _dp_stream()
    ref = _dp_mlp(cuda_device)
    ref.fit(ArrayDataSetIterator(X, Y, batch_size=16), epochs=2)
    want = ref.params()
    port, out = _free_port(), str(tmp_path / "dp.npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), str(port), out], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = np.load(out)
    np.testing.assert_array_equal(got["level1"], got["level2"])
    tol = 1e-5 * float(np.abs(want).max())
    for lv in (0, 1, 2, 3):
        np.testing.assert_allclose(got[f"level{lv}"], want, rtol=0, atol=tol)



@pytest.mark.cuda
def test_two_thread_workers_on_card_match_cpu(cuda_device):
    """ParameterAveragingTrainingMaster with two thread workers sharing
    the card (torch's default stream), averaging every 2 batches: the
    master's parameters equal the same run on the CPU from the same
    parameters within 1e-5 of their max abs, and the run repeats bit for
    bit on the card."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.training_master import (
        DistributedMultiLayerNetwork, ParameterAveragingTrainingMaster)
    X, Y = _dp_stream()
    batches = [DataSet(X[i:i + 8], Y[i:i + 8]) for i in range(0, 64, 8)]
    start = _dp_mlp("cpu").params()
    got = []
    for dev in (cuda_device, cuda_device, "cpu"):
        net = _dp_mlp(dev)
        net.set_params(start)
        master = ParameterAveragingTrainingMaster(
            n_workers=2, batch_size_per_worker=8, averaging_frequency=2)
        DistributedMultiLayerNetwork(net, master).fit(batches)
        assert net.iteration == 4
        got.append(net.params())
    np.testing.assert_array_equal(got[0], got[1])
    tol = 1e-5 * float(np.abs(got[2]).max())
    np.testing.assert_allclose(got[0], got[2], rtol=0, atol=tol)


if __name__ == "__main__":
    import sys
    _dp_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
