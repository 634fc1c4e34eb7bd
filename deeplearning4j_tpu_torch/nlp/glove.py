"""GloVe: global vectors by weighted least squares on co-occurrences, the
port of ``deeplearning4j_tpu/nlp/glove.py`` (``models/glove/Glove.java``,
``AbstractCoOccurrences.java`` and the AdaGrad update of
``learning/impl/elements/GloVe.java``; xMax 100, alpha 0.75).

All host randomness is the reference's numpy, drawn in its order from
``np.random.RandomState(seed)``: ``W``, then ``Wc``, then one permutation
of the pairs an epoch. So the initial tables and every batch are the
reference's bit for bit, and only f32 rounding separates the two
packages' tables.

- :class:`AbstractCoOccurrences` counts symmetric windowed
  co-occurrences with 1/distance weights. Where the reference adds each
  event into a Python dict, the port builds the same table with numpy:
  the events in the reference's order (sentence, position, the earlier
  word from the farthest to the nearest, the pair then its mirror), each
  key's weights summed in that order in float64 (``np.bincount``), and
  the keys in first-seen order, which is the dict's insertion order.
- :class:`Glove` trains all pairs in shuffled padded batches of
  ``batch_size`` on the device (None means the card). A step gathers the
  rows, takes the weighted squared error, adds the squared gradients into
  the AdaGrad accumulators and then the scaled gradients into the tables,
  in the reference's order (the update reads each accumulator after its
  batch's adds, duplicates included). Every add goes through
  ``lookup.scatter_add_sorted``: colliding rows summed by sort and f64
  prefix sums, no atomics, so two fits from one seed give the same bits
  on the card. On the card ``_GLOVE_S`` steps run as one captured CUDA
  graph (``models/_cuda_graph.StaticGraph``) over the tables, which it
  updates in place, and over static buffers that take each chunk's
  batch indices and masks; a short last chunk is padded with steps whose
  mask is 0, which change nothing (every add is of zeros). On the CPU a
  chunk is one step, run directly. The per-step losses stay on the
  device and are read once an epoch, summed on the host in the
  reference's order.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models._cuda_graph import (StaticGraph,
                                                         captures_graphs)
from deeplearning4j_tpu_torch.nlp.lookup import (scatter_add_sorted,
                                                 sorted_runs)
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabWord

__all__ = ["AbstractCoOccurrences", "Glove", "glove_step"]

# steps a captured graph runs on the card (one a call on the CPU)
_GLOVE_S = 64


class AbstractCoOccurrences:
    """Symmetric windowed co-occurrence counts with 1/d weighting
    (``AbstractCoOccurrences.java``). ``accumulate`` takes a sentence's
    vocabulary indices; ``pairs`` gives ``(rows, cols, counts)`` in the
    reference's first-seen order; ``counts`` the same as a dict."""

    def __init__(self, window: int = 15, symmetric: bool = True):
        self.window = window
        self.symmetric = symmetric
        self._seqs: List[np.ndarray] = []
        self._table = None

    def accumulate(self, idxs) -> None:
        self._seqs.append(np.asarray(list(idxs), np.int64))
        self._table = None

    def _build(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, float64 sums) of the distinct pairs in first-seen
        order."""
        if self._table is not None:
            return self._table
        seqs = [s for s in self._seqs if s.size]
        empty = np.zeros(0, np.int64)
        if not seqs:
            self._table = (empty, empty, np.zeros(0, np.float64))
            return self._table
        tok = np.concatenate(seqs)
        lens = np.array([s.size for s in seqs], np.int64)
        local = np.arange(tok.size) - np.repeat(np.cumsum(lens) - lens, lens)
        w = self.window
        sides = 2 if self.symmetric else 1
        centers, others, weights, order = [], [], [], []
        for d in range(1, w + 1):
            p = np.nonzero(local >= d)[0]
            if not p.size:
                continue
            c, o = tok[p], tok[p - d]
            # the reference's loop: positions ascending, the earlier word
            # from the farthest (d = w) to the nearest, pair then mirror
            rank = p * (w * sides) + (w - d) * sides
            centers.append(c)
            others.append(o)
            order.append(rank)
            if self.symmetric:
                centers.append(o)
                others.append(c)
                order.append(rank + 1)
            weights += [np.full(p.size, 1.0 / d)] * sides
        seq = np.argsort(np.concatenate(order), kind="stable")
        c = np.concatenate(centers)[seq]
        o = np.concatenate(others)[seq]
        wt = np.concatenate(weights)[seq]
        n_ids = int(tok.max()) + 1
        keys, first, inverse = np.unique(c * n_ids + o, return_index=True,
                                         return_inverse=True)
        # bincount adds each key's weights one by one in event order: the
        # dict's own float64 sums
        sums = np.bincount(inverse.reshape(-1), weights=wt,
                           minlength=keys.size)
        seen = np.argsort(first, kind="stable")
        keys = keys[seen]
        self._table = (keys // n_ids, keys % n_ids, sums[seen])
        return self._table

    @property
    def counts(self):
        rows, cols, sums = self._build()
        return dict(zip(zip(rows.tolist(), cols.tolist()), sums.tolist()))

    def pairs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows, cols, sums = self._build()
        return (rows.astype(np.int32), cols.astype(np.int32),
                sums.astype(np.float32))


def glove_step(W, Wc, b, bc, hW, hWc, hb, hbc, rows, cols, logx, fx, mask,
               lr):
    """One batched AdaGrad step on J = f(x) (w·w̃ + b + b̃ - log x)²
    (``GloVe.java``), in place on the eight tables; returns the batch's
    loss as a device scalar. Padded entries carry ``mask`` 0."""
    wi, wj = W[rows], Wc[cols]                                  # (B, D)
    diff = (wi * wj).sum(-1) + b[rows] + bc[cols] - logx
    fdiff = fx * diff * mask
    gW = fdiff[:, None] * wj
    gWc = fdiff[:, None] * wi
    gb = fdiff
    r, c = sorted_runs(rows), sorted_runs(cols)
    # the accumulators first (squared gradients), then the updates scaled
    # by the accumulators as they stand after this batch's adds
    scatter_add_sorted(hW, rows, (gW * gW).sum(-1), r)
    scatter_add_sorted(hWc, cols, (gWc * gWc).sum(-1), c)
    scatter_add_sorted(hb, rows, gb * gb, r)
    scatter_add_sorted(hbc, cols, gb * gb, c)
    scatter_add_sorted(W, rows,
                       -lr * gW / torch.sqrt(hW[rows] + 1e-8)[:, None], r)
    scatter_add_sorted(Wc, cols,
                       -lr * gWc / torch.sqrt(hWc[cols] + 1e-8)[:, None], c)
    scatter_add_sorted(b, rows, -lr * gb / torch.sqrt(hb[rows] + 1e-8), r)
    scatter_add_sorted(bc, cols, -lr * gb / torch.sqrt(hbc[cols] + 1e-8), c)
    return (0.5 * fx * diff * diff * mask).sum()


class Glove(SequenceVectors):
    """``Glove.java``'s builder surface: xMax, alpha, learningRate,
    epochs, symmetric. ``loss_`` is the last epoch's mean loss a pair,
    ``epoch_losses_`` every epoch's."""

    def __init__(self, tokenizer_factory=None, x_max: float = 100.0,
                 alpha: float = 0.75, symmetric: bool = True, **kwargs):
        kwargs.setdefault("learning_rate", 0.05)
        kwargs.setdefault("use_hierarchic_softmax", False)
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.loss_ = None
        self.epoch_losses_: List[float] = []

    def co_occurrences(self, token_lists) -> AbstractCoOccurrences:
        """The co-occurrence table of tokenized sentences over the built
        vocabulary (out-of-vocabulary tokens dropped)."""
        co = AbstractCoOccurrences(self.window, self.symmetric)
        index = {el.label: el.index for el in self.vocab.vocab_words()}
        for toks in token_lists:
            co.accumulate([i for i in (index.get(t, -1) for t in toks)
                           if i >= 0])
        return co

    def fit_corpus(self, sentences: Iterable[str]) -> None:
        token_lists = [self.tokenizer_factory.create(s).get_tokens()
                       for s in sentences]
        self.build_vocab(Sequence([VocabWord(t) for t in toks])
                         for toks in token_lists if toks)
        rows, cols, vals = self.co_occurrences(token_lists).pairs()
        self._fit_pairs(rows, cols, vals)

    def _fit_pairs(self, rows, cols, vals) -> None:
        n_vocab, D, B = self.vocab.num_words(), self.layer_size, self.batch_size
        dev = self.device
        rng = np.random.RandomState(self.seed)

        def table(init):
            return torch.from_numpy(init.astype(np.float32)).to(dev)
        W = table((rng.rand(n_vocab, D) - 0.5) / D)
        Wc = table((rng.rand(n_vocab, D) - 0.5) / D)
        b, bc = (torch.zeros(n_vocab, device=dev) for _ in range(2))
        hW, hWc, hb, hbc = (torch.ones(n_vocab, device=dev)
                            for _ in range(4))

        logx = np.log(np.maximum(vals, 1e-12)).astype(np.float32)
        fx = np.minimum((vals / self.x_max) ** self.alpha,
                        1.0).astype(np.float32)
        n = len(vals)
        n_pad = ((n + B - 1) // B) * B if n else 0
        rows_d, cols_d = (torch.from_numpy(a.astype(np.int64)).to(dev)
                          for a in (rows, cols))
        logx_d, fx_d = table(logx), table(fx)
        lr = float(np.float32(self.learning_rate))
        n_steps = n_pad // B
        S = _GLOVE_S if captures_graphs(dev) else 1
        n_chunks = -(-n_steps // S)
        # a chunk's batch indices and masks, and its steps' losses
        sel_s = torch.zeros((S, B), dtype=torch.int64, device=dev)
        mask_s = torch.zeros((S, B), device=dev)
        loss_s = torch.zeros(S, device=dev)

        def chunk():
            for j in range(S):
                sel = sel_s[j]
                loss_s[j] = glove_step(
                    W, Wc, b, bc, hW, hWc, hb, hbc, rows_d[sel],
                    cols_d[sel], logx_d[sel], fx_d[sel], mask_s[j], lr)
        program = StaticGraph(chunk, dev)
        mask = np.zeros(n_chunks * S * B, np.float32)
        mask[:n] = 1.0
        mask_d = table(mask).view(n_chunks, S, B)
        self.epoch_losses_ = []
        for _ in range(self.epochs):
            # padded entries point at pair 0 with mask 0, as the
            # reference's zero padding does
            idx = np.zeros(n_chunks * S * B, np.int64)
            idx[:n] = rng.permutation(n)
            idx_d = torch.from_numpy(idx).to(dev).view(n_chunks, S, B)
            losses = torch.empty((n_chunks, S), device=dev)
            for k in range(n_chunks):
                sel_s.copy_(idx_d[k])
                mask_s.copy_(mask_d[k])
                program()
                losses[k].copy_(loss_s)
            epoch_loss = 0.0
            for x in losses.view(-1)[:n_steps].cpu().numpy().tolist():
                epoch_loss += x
            self.loss_ = epoch_loss / max(n, 1)
            self.epoch_losses_.append(self.loss_)
        # the embedding is W + Wc (GloVe practice; the reference keeps it
        # as syn0)
        self.lookup_table.syn0 = W + Wc
