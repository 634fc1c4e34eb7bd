"""Embedding lookup table and its batched update steps, in PyTorch.

The reference's ``nlp/lookup.py`` keeps syn0 (input vectors), syn1
(hierarchical softmax's inner nodes) and syn1neg (negative sampling's
output vectors), and updates them one minibatch at a time: the host packs
a minibatch of (center, context, Huffman path or negatives) index tuples
into dense arrays, and one program gathers the rows, takes the dots and
sigmoids, and scatter-adds the updates. It runs in XLA, outside Pallas:
there is no hand-written kernel on this path, so the port is plain
PyTorch ops on the same arrays.

The tables are tensors on the device, updated in place, so that a
captured CUDA graph over them stays bound to live storage
(``sequence_vectors.py`` captures one graph a chunk shape). Colliding
rows within a batch add up, damped beyond ``COLLISION_CAP`` colliders,
by one of three scatter strategies (``DL4J_TORCH_W2V_SCATTER``):

- ``sorted`` (the default): a stable sort of the row indices, each run
  of equal rows summed as the difference of two f64 prefix sums, and
  each row written once with its total. On the card the result is the
  same bits on every run;
- ``fused``: one ``index_add_`` of rows and counts into a (V, D + 1)
  accumulator, then one dense damped add;
- ``two``: a count pass, then the damped rows added by ``index_add_``.

``index_add_`` on the card adds with atomics, so ``fused`` and ``two``
sum colliding f32 rows in an order that varies from run to run: their
bits are not reproducible. On the CPU all three are.

Negative sampling draws its negatives on the device
(:func:`ns_scan_devneg`): the caller hands over a draw function that
gives a step's [B, K] indices into the unigram table. The reference
draws them with ``jax.random`` inside its scan; the port draws them from
a ``torch.Generator`` (``sequence_vectors.py``), so the draws agree in
distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["COLLISION_CAP", "InMemoryLookupTable", "cbow_hs_scan",
           "cbow_hs_step", "cbow_ns_scan", "cbow_ns_scan_devneg",
           "cbow_ns_step", "hs_scan", "hs_step", "ns_scan",
           "ns_scan_devneg", "ns_step", "scatter_add_sorted",
           "scatter_impl", "set_scatter_impl", "sorted_runs"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class InMemoryLookupTable:
    """syn0, syn1, syn1neg and the unigram^0.75 negative-sampling table
    (the reference's ``InMemoryLookupTable``), on ``device`` (None means
    the card). syn0 starts from the reference's
    ``np.random.RandomState(seed)`` draw, so both packages start from the
    same values; ``dtype`` (or ``DL4J_TORCH_W2V_DTYPE``) is the tables'
    storage type, float32 or bfloat16, while the update's arithmetic
    stays f32."""

    def __init__(self, vocab_size: int, vector_length: int, seed: int = 123,
                 use_hs: bool = True, negative: int = 0,
                 table_size: int = 100_000, dtype: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.vector_length = vector_length
        self.negative = negative
        self.use_hs = use_hs
        name = str(dtype or env_str("DL4J_TORCH_W2V_DTYPE"))
        dt = _DTYPES.get(name.replace("torch.", ""))
        if dt is None:
            raise ValueError(
                f"unsupported table dtype {name!r}: the update steps' "
                f"rounding design supports float32 and bfloat16 only")
        rng = np.random.RandomState(seed)
        # the reference's init: (rand - 0.5) / vectorLength
        init = (rng.rand(vocab_size, vector_length) - 0.5) / vector_length
        self.syn0 = torch.from_numpy(init).to(dt).to(self.device)
        self.syn1 = (torch.zeros((max(vocab_size - 1, 1), vector_length),
                                 dtype=dt, device=self.device)
                     if use_hs else None)
        self.syn1neg = (torch.zeros((vocab_size, vector_length), dtype=dt,
                                    device=self.device)
                        if negative > 0 else None)
        self._table_size = table_size
        self._ns_table: Optional[np.ndarray] = None
        self._ns_table_dev = None

    def build_ns_table(self, frequencies: np.ndarray,
                       power: float = 0.75) -> None:
        """Unigram^power sampling table (the reference's ``makeTable``)."""
        pow_f = np.asarray(frequencies, np.float64) ** power
        cum = np.cumsum(pow_f / pow_f.sum())
        self._ns_table = np.searchsorted(
            cum, (np.arange(self._table_size) + 0.5) / self._table_size
        ).astype(np.int32)
        if self._ns_table_dev is not None:   # in place: graphs read it
            self._ns_table_dev.copy_(torch.from_numpy(
                self._ns_table.astype(np.int64)))

    def sample_negatives(self, rng, shape) -> np.ndarray:
        """Negative rows drawn on the host, from a legacy RandomState or an
        ``np.random.Generator``."""
        assert self._ns_table is not None, "call build_ns_table first"
        if isinstance(rng, np.random.Generator):
            draws = rng.integers(0, self._table_size, size=shape,
                                 dtype=np.int32)
        else:
            draws = rng.randint(0, self._table_size, size=shape)
        return self._ns_table[draws]

    def ns_table_device(self):
        """The sampling table on the device (int64), for draws made
        there."""
        assert self._ns_table is not None, "call build_ns_table first"
        if self._ns_table_dev is None:
            self._ns_table_dev = torch.from_numpy(
                self._ns_table.astype(np.int64)).to(self.device)
        return self._ns_table_dev

    def same_layout(self, other: "InMemoryLookupTable") -> bool:
        """Whether ``other``'s tables have these tables' shapes, dtype and
        device (so :meth:`load_` can take them)."""
        for name in ("syn0", "syn1", "syn1neg"):
            mine, theirs = getattr(self, name), getattr(other, name)
            if (mine is None) != (theirs is None) or (
                    mine is not None and (mine.shape != theirs.shape
                                          or mine.dtype != theirs.dtype
                                          or mine.device != theirs.device)):
                return False
        return True

    def load_(self, other: "InMemoryLookupTable") -> None:
        """Take ``other``'s values (of the same layout) into this table's
        tensors, in place, so that programs captured over these tensors
        stay bound to them."""
        for name in ("syn0", "syn1", "syn1neg"):
            mine = getattr(self, name)
            if mine is not None:
                mine.copy_(getattr(other, name))
        self._table_size = other._table_size
        self._ns_table = other._ns_table
        if self._ns_table is not None and self._ns_table_dev is not None:
            self._ns_table_dev.copy_(torch.from_numpy(
                self._ns_table.astype(np.int64)))

    @property
    def dtype(self):
        """Storage dtype of the live tables."""
        return self.syn0.dtype

    # host copies for serializers and queries: always f32 numpy
    def vector(self, index: int) -> np.ndarray:
        return self.syn0[index].float().cpu().numpy()

    def all_vectors(self) -> np.ndarray:
        return self.syn0.float().cpu().numpy()


# ---------------------------------------------------------------------------
# Batched updates. Index tensors are int64 and padded; pad entries are
# masked by ``mask`` (HS: position < code length; NS: sample valid). Each
# update works in place on its tables and returns them. Each exists as a
# single step and as a scan over the leading S axis of its stacked inputs,
# the reference's ``lax.scan`` form, which the trainer captures as one CUDA
# graph a chunk shape.
# ---------------------------------------------------------------------------

# Colliding row updates within a batch add up to this many colliders;
# beyond, the summed update is scaled by cap/cnt, so a frequent word hit
# 500 times in one batch cannot take a 500-fold step.
COLLISION_CAP = 32.0

# Above this many table elements the fused update's table-sized
# accumulator would double the table's memory; two scatters are used.
_DENSE_SCATTER_LIMIT = 256 * 1024 * 1024 // 4   # 64M f32 elements

SCATTER_IMPL = None   # explicit override; None reads the knob


def scatter_impl():
    """The strategy in force: the :func:`set_scatter_impl` override, else
    ``DL4J_TORCH_W2V_SCATTER``. A captured program keeps the strategy it
    was captured with: switch before the first step, or use
    :func:`set_scatter_impl`, whose change a trainer notices."""
    return SCATTER_IMPL or env_str("DL4J_TORCH_W2V_SCATTER")


def set_scatter_impl(name):
    """Switch the scatter strategy (``None`` goes back to the knob)."""
    global SCATTER_IMPL
    if name is not None and name not in ("fused", "sorted", "two"):
        raise ValueError(f"unknown scatter impl {name!r}")
    SCATTER_IMPL = name


def _collision_scale(cnt):
    return torch.clamp(COLLISION_CAP / torch.clamp(cnt, min=1.0), max=1.0)


def sorted_runs(idx):
    """``idx`` sorted (stable), the sorting permutation, and each sorted
    position's run of equal indices (its first and last positions): what
    the sorted scatters need, shared by the adds that use one index."""
    si, order = torch.sort(idx, stable=True)
    start = torch.searchsorted(si, si)
    end = torch.searchsorted(si, si, right=True) - 1
    return si, order, start, end


def _run_totals(vals, runs):
    """Each sorted position's run total of ``vals`` (N, C), as f32 (N, C):
    the difference of f64 prefix sums (a scan, the same on every call) at
    the run's two ends, with no atomic add and no loop over a run's
    length."""
    _, order, start, end = runs
    cs = torch.cumsum(vals[order].double().t().contiguous(), dim=1)
    before = torch.where(start > 0, cs[:, (start - 1).clamp(min=0)],
                         torch.zeros((), dtype=cs.dtype, device=cs.device))
    return (cs[:, end] - before).t().float()


def scatter_add_sorted(table, idx, vals, runs=None):
    """``table[idx] += vals`` in place, colliding indices summed, by the
    sorted route of :func:`_scatter_damped_sorted` without its damping.
    On the card the result is the same bits on every run (``index_add_``
    adds with atomics, in an order that varies). ``table``: (V,) or
    (V, D); ``idx``: (N,) int64; ``vals``: (N,) or (N, D) f32; ``runs``:
    ``sorted_runs(idx)``, if already made."""
    runs = runs if runs is not None else sorted_runs(idx)
    si = runs[0]
    run = _run_totals(vals.reshape(vals.shape[0], -1), runs)
    table.index_put_((si,), table[si] + run.reshape(
        (-1,) + table.shape[1:]).to(table.dtype))


def _scatter_damped_sorted(table, idx, rows, w):
    """``table[idx] += rows w``, damped by the collision cap, by sort and
    segment sum: contributions sorted by row (stable), each run of equal
    rows summed (:func:`_run_totals`), and each row written once with its
    total. A run's sum reaches thousands of rows for the most frequent
    words of a Zipf corpus. Every position of a run computes the run's
    new row, and the write (no accumulation) puts those equal values into
    the row, so the result does not depend on which write lands last."""
    runs = sorted_runs(idx)
    si = runs[0]
    # the rows and the count last: (N, D + 1)
    run = _run_totals(torch.cat([rows * w[:, None], w[:, None]], dim=1),
                      runs)
    upd = run[:, :-1] * _collision_scale(run[:, -1])[:, None]
    table.index_put_((si,), table[si] + upd.to(table.dtype))


def _scatter_damped(table, idx, rows, w):
    """``table[idx] += rows w``, damped by the collision cap, in place.

    idx: (N,) int64 rows; rows: (N, D) f32; w: (N,) f32 weight (0 for a
    padded entry). Every contribution to row r shares the damping
    ``scale(cnt_r)``, which depends only on r's collider count, so the
    three strategies compute one function. The arithmetic is f32; the
    table's own dtype takes the rounded update."""
    big = table.numel() > _DENSE_SCATTER_LIMIT
    impl = scatter_impl()
    if impl == "sorted" or (big and table.dtype != torch.float32):
        # a low-precision table past the limit goes here too: only this
        # form keeps its transients the size of the batch, and it rounds
        # colliding adds once a row
        _scatter_damped_sorted(table, idx, rows, w)
        return
    if impl == "two" or big:
        cnt = torch.zeros(table.shape[0], dtype=torch.float32,
                          device=table.device).index_add_(0, idx, w)
        upd = rows * w[:, None] * _collision_scale(cnt[idx])[:, None]
        if table.dtype == torch.float32:
            table.index_add_(0, idx, upd)
            return
        # a low-precision table rounds once a row, not once a collider
        grad = torch.zeros(table.shape, dtype=torch.float32,
                           device=table.device).index_add_(0, idx, upd)
        table.copy_((table.float() + grad).to(table.dtype))
        return
    # the accumulator stays f32 whatever the table's dtype: bf16 counts
    # stop at 256 (256 + 1 rounds back), which would floor the damping
    acc = torch.zeros((table.shape[0], table.shape[1] + 1),
                      dtype=torch.float32, device=table.device)
    acc.index_add_(0, idx, torch.cat([rows * w[:, None], w[:, None]], dim=1))
    damp = _collision_scale(acc[:, -1])[:, None]
    table.add_((acc[:, :-1] * damp).to(table.dtype))


def _hs_update(syn0, syn1, centers, points, codes, mask, lr):
    """Hierarchical-softmax SGD update (the reference's SkipGram).

    centers: (B,) rows of syn0; points/codes/mask: (B, L) Huffman paths.
    f = sigmoid(h·v'); g = (1 - code - f) lr; h += Σ g v'; v' += g h."""
    h = syn0[centers].float()                              # (B, D)
    v = syn1[points].float()                               # (B, L, D)
    maskf = mask.float()
    f = torch.sigmoid(torch.einsum("bd,bld->bl", h, v))    # (B, L)
    g = (1.0 - codes.float() - f) * lr * maskf
    dh = torch.einsum("bl,bld->bd", g, v)                  # (B, D)
    dv = g[..., None] * h[:, None, :]                      # (B, L, D)
    rowv = maskf[:, 0]                    # row validity (length >= 1)
    _scatter_damped(syn0, centers, dh, rowv)
    _scatter_damped(syn1, points.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                    maskf.reshape(-1))
    return syn0, syn1


def _ns_update(syn0, syn1neg, centers, targets, labels, mask, lr):
    """Negative-sampling SGD update. targets: (B, K+1) = [positive,
    negatives...]; labels 1/0; mask marks valid entries. Colliding rows
    add up to ``COLLISION_CAP`` colliders, then are damped by cap/cnt."""
    h = syn0[centers].float()
    v = syn1neg[targets].float()
    f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, v))
    maskf = mask.float()
    g = (labels.float() - f) * lr * maskf
    dh = torch.einsum("bk,bkd->bd", g, v)
    dv = g[..., None] * h[:, None, :]
    rowv = maskf[:, 0]                    # row validity (padding mask)
    _scatter_damped(syn0, centers, dh, rowv)
    _scatter_damped(syn1neg, targets.reshape(-1),
                    dv.reshape(-1, dv.shape[-1]), maskf.reshape(-1))
    return syn0, syn1neg


def _context_mean(syn0, context, context_mask):
    cnt = torch.clamp(context_mask.sum(-1, keepdim=True), min=1.0)  # (B, 1)
    h = torch.einsum("bcd,bc->bd", syn0[context].float(),
                     context_mask) / cnt
    return h, cnt


def _cbow_hs_update(syn0, syn1, context, context_mask, points, codes, mask,
                    lr):
    """CBOW with hierarchical softmax: h is the mean of the context
    vectors, and the input gradient goes back to every context word."""
    h, cnt = _context_mean(syn0, context, context_mask)
    v = syn1[points].float()
    maskf = mask.float()
    f = torch.sigmoid(torch.einsum("bd,bld->bl", h, v))
    g = (1.0 - codes.float() - f) * lr * maskf
    dh = torch.einsum("bl,bld->bd", g, v) / cnt                   # (B, D)
    dv = g[..., None] * h[:, None, :]
    _scatter_damped(syn1, points.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                    maskf.reshape(-1))
    dctx = dh[:, None, :] * context_mask[..., None]               # (B, C, D)
    _scatter_damped(syn0, context.reshape(-1),
                    dctx.reshape(-1, dctx.shape[-1]),
                    context_mask.reshape(-1))
    return syn0, syn1


def _cbow_ns_update(syn0, syn1neg, context, context_mask, targets, labels,
                    mask, lr):
    """CBOW with negative sampling, colliding rows damped as in
    :func:`_ns_update`."""
    h, cnt = _context_mean(syn0, context, context_mask)
    v = syn1neg[targets].float()
    f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, v))
    maskf = mask.float()
    g = (labels.float() - f) * lr * maskf
    dh = torch.einsum("bk,bkd->bd", g, v) / cnt
    dv = g[..., None] * h[:, None, :]
    _scatter_damped(syn1neg, targets.reshape(-1),
                    dv.reshape(-1, dv.shape[-1]), maskf.reshape(-1))
    dctx = dh[:, None, :] * context_mask[..., None]
    _scatter_damped(syn0, context.reshape(-1),
                    dctx.reshape(-1, dctx.shape[-1]),
                    context_mask.reshape(-1))
    return syn0, syn1neg


@torch.no_grad()
def hs_step(syn0, syn1, centers, points, codes, mask, lr):
    return _hs_update(syn0, syn1, centers, points, codes, mask, lr)


@torch.no_grad()
def ns_step(syn0, syn1neg, centers, targets, labels, mask, lr):
    return _ns_update(syn0, syn1neg, centers, targets, labels, mask, lr)


@torch.no_grad()
def cbow_hs_step(syn0, syn1, context, context_mask, points, codes, mask, lr):
    return _cbow_hs_update(syn0, syn1, context, context_mask, points, codes,
                           mask, lr)


@torch.no_grad()
def cbow_ns_step(syn0, syn1neg, context, context_mask, targets, labels, mask,
                 lr):
    return _cbow_ns_update(syn0, syn1neg, context, context_mask, targets,
                           labels, mask, lr)


def _scan(update):
    """``update`` over the leading S axis of every stacked input (``lrs``:
    (S,) learning rates, one a step), tables carried in place."""
    @torch.no_grad()
    def run(syn0, syn1, *stacked):
        for s in range(stacked[0].shape[0]):
            update(syn0, syn1, *(x[s] for x in stacked))
        return syn0, syn1
    return run


hs_scan = _scan(_hs_update)
ns_scan = _scan(_ns_update)
cbow_hs_scan = _scan(_cbow_hs_update)
cbow_ns_scan = _scan(_cbow_ns_update)


# --- negative sampling with draws on the device -----------------------------
# The unigram^0.75 table lives on the device and negatives are drawn there
# inside the scan, so the host sends only (centers, positives, valid) a
# chunk instead of (K+1)-wide target, label and mask arrays.

def _ns_targets(table, positive, valid, draws):
    """[positive, negatives], their labels and mask: a negative equal to
    the positive is masked, and so is every entry of a padded row."""
    negs = table[draws]                                    # (B, K)
    targets = torch.cat([positive[:, None], negs], dim=1)  # (B, K+1)
    labels = torch.zeros_like(targets)
    labels[:, 0] = 1
    keep = torch.cat([torch.ones_like(positive[:, None], dtype=torch.bool),
                      negs != positive[:, None]], dim=1)
    return targets, labels, (keep & valid[:, None]).float()


@torch.no_grad()
def ns_scan_devneg(syn0, syn1neg, table, centers, positives, valid, lrs,
                   negative, draw):
    """Negative-sampling scan with draws on the device.

    centers/positives: (S, B) int64; valid: (S, B) bool (padding mask);
    lrs: (S,); negative: K; ``draw(s)`` gives step s's (B, K) int64
    indices into ``table``."""
    for s in range(centers.shape[0]):
        d = draw(s)
        if d.shape != (centers.shape[1], negative):
            raise ValueError(f"draw gave {tuple(d.shape)}, not "
                             f"({centers.shape[1]}, {negative})")
        targets, labels, mask = _ns_targets(table, positives[s], valid[s], d)
        _ns_update(syn0, syn1neg, centers[s], targets, labels, mask, lrs[s])
    return syn0, syn1neg


@torch.no_grad()
def cbow_ns_scan_devneg(syn0, syn1neg, table, context, context_mask,
                        centers, valid, lrs, negative, draw):
    """CBOW's negative-sampling scan with draws on the device; the center
    word is the positive."""
    for s in range(centers.shape[0]):
        d = draw(s)
        if d.shape != (centers.shape[1], negative):
            raise ValueError(f"draw gave {tuple(d.shape)}, not "
                             f"({centers.shape[1]}, {negative})")
        targets, labels, mask = _ns_targets(table, centers[s], valid[s], d)
        _cbow_ns_update(syn0, syn1neg, context[s], context_mask[s], targets,
                        labels, mask, lrs[s])
    return syn0, syn1neg
