"""SequenceVectors: the generic embedding trainer, in PyTorch.

The reference's ``nlp/sequence_vectors.py`` (DL4J's ``SequenceVectors``
with the SkipGram and CBOW element algorithms, DBOW and DM for sequences,
linear learning-rate decay and frequency subsampling) is carried over: the
host part is the same numpy code, and the device part runs the updates of
``lookup.py`` on tensors on the card (``device``, None meaning the card).

- the corpus streams in blocks of about 64k tokens; vocab mapping and
  subsampling are numpy over each sequence;
- a block's skip-gram pairs and CBOW windows come from shifted-slice numpy
  comparisons over the concatenated token stream;
- training tuples collect in columnar buffers and drain as (S, B, ...)
  chunks, S bucketed to ``_SCAN_S``. Each chunk is one dispatch: its
  arrays are copied into static tensors on the device and one program
  runs the S batches' updates (the reference's ``lax.scan``). On the card
  that program is a CUDA graph, captured once a (kind, S, B) bucket and
  replayed (``models/_cuda_graph.StaticGraph``), with the tables updated
  in place; Huffman codes and paths are gathered on the device, and
  negative samples are drawn there from a ``torch.Generator`` registered
  with the graphs, reseeded from the host stream at each epoch, so a fit
  from one seed repeats.

Sequences may be ``Sequence`` objects or plain lists of token strings (the
fast path, with no element object a token).
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models._cuda_graph import (StaticGraph,
                                                         captures_graphs)
from deeplearning4j_tpu_torch.nlp import lookup as _kernels
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import (
    AbstractCache, Sequence, VocabConstructor)

# scan-length buckets: mid-epoch only full 64-batch chunks drain (no
# padding), and the one short chunk at the end is padded up to the nearest
# bucket. Coarse on purpose: each bucket is one captured program.
_SCAN_S = (1, 8, 64)
_BLOCK_TOKENS = 65536


# static tensor dtype of a chunk array, by numpy kind: indices int64,
# masks bool, learning rates and context masks f32
_STATIC_DTYPES = {"i": torch.int64, "b": torch.bool, "f": torch.float32}


def _bucket_s(n_batches: int) -> int:
    for s in _SCAN_S:
        if n_batches <= s:
            return s
    return _SCAN_S[-1]


class _ColumnBuffer:
    """Accumulates parallel columnar numpy arrays (one append per block, not
    per row) and drains them as zero-padded (S·B)-row chunks."""

    def __init__(self, ncols: int):
        self.cols: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        self.count = 0

    def add(self, *cols: np.ndarray) -> None:
        if len(cols[0]) == 0:
            return
        for store, c in zip(self.cols, cols):
            store.append(c)
        self.count += len(cols[0])

    def drain(self, batch: int, force: bool):
        """Yield (columns, n_valid, S) chunks. Mid-epoch only full
        S_max·batch chunks are cut; force=True flushes the padded tail."""
        out = []
        cap = _SCAN_S[-1] * batch
        while self.count >= cap:
            out.append(self._take(cap, batch))
        if force and self.count:
            out.append(self._take(self.count, batch))
        return out

    def _take(self, n: int, batch: int):
        merged = [np.concatenate(c) if len(c) > 1 else c[0]
                  for c in self.cols]
        take, rest = [m[:n] for m in merged], [m[n:] for m in merged]
        self.cols = [[r] if len(r) else [] for r in rest]
        self.count -= n
        S = _bucket_s(-(-n // batch))
        pad = S * batch - n
        if pad:
            take = [np.concatenate(
                [t, np.zeros((pad,) + t.shape[1:], t.dtype)]) for t in take]
        return take, n, S


class SkipGram:
    """SkipGram elements learning (``SkipGram.java``): each word in the window
    predicts the center via HS path and/or negative sampling."""

    name = "SkipGram"

    def make_pairs(self, seq_idx: List[int], window: int,
                   rng: np.random.RandomState, reduced_window: bool = True):
        """Reference-semantics generator — (input_row, predicted_word) pairs
        with a per-position reduced window. The trainer uses the vectorized
        block path (`SequenceVectors._block_pairs`), which produces the same
        pair set grouped by offset instead of by position."""
        n = len(seq_idx)
        for pos, center in enumerate(seq_idx):
            b = rng.randint(0, window) if reduced_window else 0
            lo, hi = max(0, pos - window + b), min(n, pos + window + 1 - b)
            for j in range(lo, hi):
                if j != pos:
                    yield seq_idx[j], center


class CBOW:
    """CBOW elements learning (``CBOW.java``): mean of window context predicts
    the center word."""

    name = "CBOW"

    def make_windows(self, seq_idx: List[int], window: int,
                     rng: np.random.RandomState):
        n = len(seq_idx)
        for pos, center in enumerate(seq_idx):
            b = rng.randint(0, window)
            ctx = [seq_idx[j] for j in
                   range(max(0, pos - window + b), min(n, pos + window + 1 - b))
                   if j != pos]
            if ctx:
                yield ctx, center


class DBOW:
    """Distributed bag of words (``impl/sequence/DBOW.java``): the sequence
    label vector predicts each word — SkipGram with the label as input row."""

    name = "DBOW"


class DM:
    """Distributed memory (``impl/sequence/DM.java``): label + context mean
    predicts the center — CBOW with the label added to the context."""

    name = "DM"


class SequenceVectors:
    """Generic trainer over ``Sequence`` streams (``SequenceVectors.java``).

    The keyword configuration follows DL4J's ``SequenceVectors`` knobs:
    layerSize, windowSize, minWordFrequency,
    learningRate/minLearningRate, negative, useHierarchicSoftmax, sampling
    (subsampling threshold), batchSize, epochs, seed. ``device`` is where
    the tables live and train (None means the card).
    """

    def __init__(self,
                 layer_size: int = 100,
                 window: int = 5,
                 min_word_frequency: int = 1,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 negative: int = 0,
                 use_hierarchic_softmax: bool = True,
                 sampling: float = 0.0,
                 batch_size: int = 512,
                 epochs: int = 1,
                 seed: int = 123,
                 elements_learning_algorithm=None,
                 sequence_learning_algorithm=None,
                 train_elements: bool = True,
                 train_sequences: bool = False,
                 device=None):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.sampling = sampling
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.elements_algo = elements_learning_algorithm or SkipGram()
        self.sequence_algo = sequence_learning_algorithm or DBOW()
        self.train_elements = train_elements
        self.train_sequences = train_sequences

        self.device = resolve_device(device)
        self.vocab: Optional[AbstractCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._codes = self._points = self._lengths = None
        self._hs_dev = None        # (codes, points, lengths) on the device
        # one program a chunk bucket, bound to the tables' storage; on the
        # card all share one graph memory pool (they replay in turn)
        self._programs = {}
        self._mempool = (torch.cuda.graph_pool_handle()
                         if captures_graphs(self.device) else None)
        # negative samples' source on the device, reseeded each epoch
        self._gen = torch.Generator(device=self.device)
        self._chunk_key = 0

    # ------------------------------------------------------------------
    # vocab + table construction
    # ------------------------------------------------------------------
    def build_vocab(self, sequences: Iterable[Sequence]) -> None:
        self.vocab = VocabConstructor(
            self.min_word_frequency).build_joint_vocabulary(
                sequences, build_huffman=self.use_hs)
        n = self.vocab.num_words()
        if n == 0:
            raise ValueError("empty vocabulary — corpus too small or "
                             "minWordFrequency too high")
        table = InMemoryLookupTable(
            n, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, device=self.device)
        if self.negative > 0:
            freqs = np.array([e.element_frequency
                              for e in self.vocab.vocab_words()])
            table.build_ns_table(freqs)
        if self.use_hs:
            self._codes, self._points, self._lengths = \
                self.vocab.huffman_arrays()
        hs = tuple(torch.from_numpy(a.astype(np.int64)).to(self.device)
                   for a in (self._codes, self._points, self._lengths)) \
            if self.use_hs else None
        # fresh tables of the same shapes go into the old tensors, so the
        # captured programs stay bound to them; other shapes drop them
        old, old_hs = self.lookup_table, self._hs_dev
        if old is not None and old.same_layout(table) \
                and (hs is None) == (old_hs is None) \
                and (hs is None or all(a.shape == b.shape
                                       for a, b in zip(hs, old_hs))):
            old.load_(table)
            for a, b in zip(old_hs or (), hs or ()):
                a.copy_(b)
        else:
            self.lookup_table = table
            self._hs_dev = hs
            self._programs.clear()

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, sequences_provider: Callable[[], Iterable[Sequence]]) -> None:
        """Train. ``sequences_provider`` is called once per epoch (the
        reference resets its sequence iterator per epoch, ``fit:181``)."""
        if self.vocab is None:
            self.build_vocab(sequences_provider())
        rng = np.random.RandomState(self.seed)
        total = max(self.vocab.total_word_count * self.epochs, 1.0)
        processed = 0.0
        for _ in range(self.epochs):
            processed = self._fit_epoch(
                sequences_provider(), rng, processed, total)

    def _lr(self, processed: float, total: float) -> float:
        return max(self.min_learning_rate,
                   self.learning_rate * (1.0 - processed / total))

    # ---- corpus → index arrays (vectorized subsampling) ----
    def _keep_probs(self) -> Optional[np.ndarray]:
        """Per-vocab-index keep probability for frequency subsampling
        (word2vec convention: sqrt(t/f); specials always kept)."""
        if self.sampling <= 0:
            return None
        els = self.vocab.vocab_words()
        freqs = np.array([e.element_frequency for e in els], np.float64)
        f = freqs / max(self.vocab.total_word_count, 1.0)
        keep = np.minimum(np.sqrt(self.sampling / np.maximum(f, 1e-300)), 1.0)
        keep[np.array([e.special for e in els], bool)] = 1.0
        return keep

    def _label_index_map(self) -> dict:
        """Flat label→index dict (avoids a method call + attribute chase per
        token at corpus scale)."""
        return {el.label: el.index for el in self.vocab.vocab_words()}

    def _seq_indices(self, seq, rng, keep_p, vmap) -> np.ndarray:
        """Vocab-map one sequence (``Sequence`` or raw token list) to an int32
        index array, applying subsampling."""
        if isinstance(seq, Sequence):
            tokens = [el.label for el in seq.elements]
        else:
            tokens = seq
        arr = np.fromiter(map(vmap.get, tokens, itertools.repeat(-1)),
                          np.int64, count=len(tokens))
        arr = arr[arr >= 0]
        if keep_p is not None and arr.size:
            arr = arr[rng.rand(arr.size) < keep_p[arr]]
        return arr.astype(np.int32)

    def _fit_epoch(self, sequences, rng, processed, total) -> float:
        bufs = {"pair": _ColumnBuffer(3),    # inp, pred, progress
                "cbow": _ColumnBuffer(4)}    # ctx, cmask, center, progress
        keep_p = self._keep_probs()
        vmap = self._label_index_map()
        # the negatives' seeds, drawn from the epoch rng as the reference
        # draws its own, so runs repeat for a seed
        neg_seed = int(rng.randint(1 << 31))
        self._neg_rng = np.random.default_rng(neg_seed)
        self._gen.manual_seed(neg_seed)
        seq_arrays: List[np.ndarray] = []
        seq_labels: List[List[int]] = []
        tok = 0
        for seq in sequences:
            arr = self._seq_indices(seq, rng, keep_p, vmap)
            if arr.size == 0:
                continue
            labs = []
            if isinstance(seq, Sequence) and seq.labels:
                labs = [i for i in (self.vocab.index_of(l.label)
                                    for l in seq.labels) if i >= 0]
            seq_arrays.append(arr)
            seq_labels.append(labs)
            tok += arr.size
            if tok >= _BLOCK_TOKENS:
                processed = self._train_block(
                    seq_arrays, seq_labels, rng, processed, bufs)
                self._drain(bufs, rng, total, force=False)
                seq_arrays, seq_labels, tok = [], [], 0
        if seq_arrays:
            processed = self._train_block(
                seq_arrays, seq_labels, rng, processed, bufs)
        self._drain(bufs, rng, total, force=True)
        return processed

    # ---- vectorized pair/window generation over a token block ----
    def _train_block(self, seq_arrays, seq_labels, rng, processed, bufs):
        idx = (np.concatenate(seq_arrays) if len(seq_arrays) > 1
               else seq_arrays[0])
        lens = np.array([a.size for a in seq_arrays])
        sent = np.repeat(np.arange(len(seq_arrays)), lens)
        N = idx.size
        w = self.window
        b = (rng.randint(0, w, N) if w > 0
             else np.zeros(N, np.int64))  # per-position reduced window
        p0 = processed

        use_cbow = isinstance(self.elements_algo, CBOW)
        windows = None   # computed once, shared by CBOW elements and DM
        if self.train_elements and w > 0:
            if use_cbow:
                windows = self._block_windows(idx, sent, b, p0)
                ctx, cm, centers, prog, _ = windows
                bufs["cbow"].add(ctx, cm, centers, prog)
            else:
                bufs["pair"].add(*self._block_pairs(idx, sent, b, p0))

        if self.train_sequences:
            if isinstance(self.sequence_algo, DM):
                if windows is None:
                    windows = self._block_windows(idx, sent, b, p0)
                ctx, cm, centers, prog, pos = windows
                lab_counts = np.array([len(l) for l in seq_labels])
                rep = lab_counts[sent[pos]]
                keep = rep > 0
                rows = np.repeat(np.flatnonzero(keep), rep[keep])
                if rows.size:
                    # label column values: rows are grouped by position in
                    # sequence order, labels cycling per position
                    lab_col = np.concatenate([
                        np.tile(np.asarray(seq_labels[s], np.int32), c)
                        for s, c in zip(
                            range(len(seq_arrays)),
                            np.bincount(sent[pos][keep],
                                        minlength=len(seq_arrays)))
                        if c and seq_labels[s]])
                    ctx_dm = ctx[rows]   # fancy indexing → fresh arrays
                    cm_dm = cm[rows]
                    ctx_dm[:, -1] = lab_col
                    cm_dm[:, -1] = 1.0
                    bufs["cbow"].add(ctx_dm, cm_dm, centers[rows], prog[rows])
            else:  # DBOW: label predicts each word
                off = 0
                for a, labs in zip(seq_arrays, seq_labels):
                    if labs:
                        li = np.asarray(labs, np.int32)
                        inp = np.repeat(li, a.size)
                        pred = np.tile(a, li.size)
                        prog = (p0 + off +
                                np.tile(np.arange(a.size), li.size)
                                ).astype(np.float32)
                        bufs["pair"].add(inp, pred, prog)
                    off += a.size
        return processed + N

    def _block_pairs(self, idx, sent, b, p0):
        """All skip-gram (context→center) pairs of a block: one shifted-slice
        comparison per offset d ∈ [1, window]."""
        w = self.window
        N = idx.size
        ins, outs, prog = [], [], []
        for d in range(1, min(w, N - 1) + 1):
            okd = (b + d) <= w
            same = sent[:-d] == sent[d:]
            c = np.flatnonzero(okd[:N - d] & same)      # center, ctx at c+d
            ins.append(idx[c + d])
            outs.append(idx[c])
            prog.append(c)
            c2 = np.flatnonzero(okd[d:] & same) + d     # center, ctx at c2-d
            ins.append(idx[c2 - d])
            outs.append(idx[c2])
            prog.append(c2)
        if not ins:
            z = np.zeros(0, np.int32)
            return z, z, np.zeros(0, np.float32)
        return (np.concatenate(ins), np.concatenate(outs),
                (p0 + np.concatenate(prog)).astype(np.float32))

    def _block_windows(self, idx, sent, b, p0):
        """CBOW context matrix (P, 2·window+1) for every position with a
        nonempty reduced window; the last column stays free for a DM label."""
        w = self.window
        N = idx.size
        C = 2 * w + 1
        ctx = np.zeros((N, C), np.int32)
        cm = np.zeros((N, C), np.float32)
        col = 0
        for d in range(1, min(w, max(N - 1, 0)) + 1):
            okd = (b + d) <= w
            left = np.zeros(N, bool)
            left[d:] = okd[d:] & (sent[d:] == sent[:-d])
            lpos = np.flatnonzero(left)
            ctx[lpos, col] = idx[lpos - d]
            cm[lpos, col] = 1.0
            col += 1
            right = np.zeros(N, bool)
            right[:N - d] = okd[:N - d] & (sent[:-d] == sent[d:])
            rpos = np.flatnonzero(right)
            ctx[rpos, col] = idx[rpos + d]
            cm[rpos, col] = 1.0
            col += 1
        pos = np.flatnonzero(cm.sum(1) > 0)
        return (ctx[pos], cm[pos], idx[pos],
                (p0 + pos).astype(np.float32), pos)

    # ---- chunk runners: columnar buffers → (S, B, ...) scan kernels ----
    def _drain(self, bufs, rng, total, force: bool):
        B = self.batch_size
        for cols, n, S in bufs["pair"].drain(B, force):
            self._run_pairs(cols, n, S, rng, total)
        for cols, n, S in bufs["cbow"].drain(B, force):
            self._run_windows(cols, n, S, rng, total)

    def _lrs(self, prog, S, B, total):
        # one lr per scan step (first row of each batch); padded tail batches
        # are fully masked so their lr is irrelevant
        return np.maximum(
            self.min_learning_rate,
            self.learning_rate * (1.0 - prog[::B] / total)).astype(np.float32)

    def _valid(self, nvalid, S, B):
        if nvalid == S * B:
            return None   # full chunk — masks need no padding correction
        return (np.arange(S * B) < nvalid).reshape(S, B)

    def _valid_full(self, valid, S, B):
        """(S, B) bool valid mask, all ones for a full chunk (cached a
        shape): the programs take it in every case."""
        if valid is not None:
            return valid
        cache = getattr(self, "_ones_cache", None)
        if cache is None:
            cache = self._ones_cache = {}
        got = cache.get((S, B))
        if got is None:
            got = cache[(S, B)] = np.ones((S, B), bool)
        return got

    def _neg_key(self):
        """A chunk's negatives seed from the host stream (the reference
        keys its draws with it; the default device draws do not use it)."""
        return int(self._neg_rng.integers(1 << 31))

    def _draw_negatives(self, key, step, S, B):
        """Step ``step`` of a chunk's (B, K) negative draws, indices into
        the unigram table, drawn on the device from this trainer's
        generator. ``key`` is the chunk's seed from the host stream."""
        return torch.randint(0, self.lookup_table._table_size,
                             (B, self.negative), generator=self._gen,
                             device=self.device)

    def _launch(self, name, arrays, body):
        """One chunk: ``arrays`` (host numpy, by name) go into the static
        tensors of the program of this bucket, and the program runs
        ``body(tensors)``; captured on its first dispatch on the card and
        replayed after."""
        key = (name, _kernels.scatter_impl(),
               *((k, a.shape) for k, a in arrays.items()))
        prog = self._programs.get(key)
        if prog is None:
            bufs = {k: torch.empty(a.shape, dtype=_STATIC_DTYPES[a.dtype.kind],
                                   device=self.device)
                    for k, a in arrays.items()}
            prog = self._programs[key] = (bufs, StaticGraph(
                lambda: body(bufs), self.device, self._mempool,
                generators=(self._gen,)))
        bufs, graph = prog
        for k, a in arrays.items():
            bufs[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        graph()

    def _hs_paths(self, pred, valid):
        """Huffman paths of a chunk's (S, B) predicted words, gathered on
        the device: (points, codes, mask), mask = position < code length
        on valid rows."""
        codes, points, lengths = self._hs_dev
        L = codes.shape[1]
        mask = (torch.arange(L, device=self.device)
                < lengths[pred][..., None]) & valid[..., None]
        return points[pred], codes[pred], mask

    def _pairs_hs(self, x):
        tbl = self.lookup_table
        _kernels.hs_scan(tbl.syn0, tbl.syn1, x["centers"],
                         *self._hs_paths(x["pred"], x["valid"]), x["lrs"])

    def _pairs_ns(self, x):
        tbl = self.lookup_table
        S, B = x["centers"].shape
        _kernels.ns_scan_devneg(
            tbl.syn0, tbl.syn1neg, tbl.ns_table_device(), x["centers"],
            x["pred"], x["valid"], x["lrs"], self.negative,
            lambda s: self._draw_negatives(self._chunk_key, s, S, B))

    def _windows_hs(self, x):
        tbl = self.lookup_table
        _kernels.cbow_hs_scan(tbl.syn0, tbl.syn1, x["context"], x["cmask"],
                              *self._hs_paths(x["centers"], x["valid"]),
                              x["lrs"])

    def _windows_ns(self, x):
        tbl = self.lookup_table
        S, B = x["centers"].shape
        _kernels.cbow_ns_scan_devneg(
            tbl.syn0, tbl.syn1neg, tbl.ns_table_device(), x["context"],
            x["cmask"], x["centers"], x["valid"], x["lrs"], self.negative,
            lambda s: self._draw_negatives(self._chunk_key, s, S, B))

    @torch.no_grad()
    def _run_pairs(self, cols, nvalid, S, rng, total):
        B = self.batch_size
        inp, pred, prog = cols
        x = {"centers": inp.reshape(S, B), "pred": pred.reshape(S, B),
             "valid": self._valid_full(self._valid(nvalid, S, B), S, B),
             "lrs": self._lrs(prog, S, B, total)}
        if self.use_hs:
            self._launch("pairs_hs", x, self._pairs_hs)
        if self.negative > 0:
            self._chunk_key = self._neg_key()
            self._launch("pairs_ns", x, self._pairs_ns)

    @torch.no_grad()
    def _run_windows(self, cols, nvalid, S, rng, total):
        B = self.batch_size
        ctx, cm, center, prog = cols
        C = ctx.shape[1]
        valid = self._valid(nvalid, S, B)
        cmask = cm.reshape(S, B, C)
        if valid is not None:
            cmask = cmask * valid[..., None]
        x = {"context": ctx.reshape(S, B, C), "cmask": cmask,
             "centers": center.reshape(S, B),
             "valid": self._valid_full(valid, S, B),
             "lrs": self._lrs(prog, S, B, total)}
        if self.use_hs:
            self._launch("windows_hs", x, self._windows_hs)
        if self.negative > 0:
            self._chunk_key = self._neg_key()
            self._launch("windows_ns", x, self._windows_ns)

    # ------------------------------------------------------------------
    # query API (BasicModelUtils — models/embeddings/reader/impl)
    # ------------------------------------------------------------------
    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.lookup_table.vector(i)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        na, nb = np.linalg.norm(va), np.linalg.norm(vb)
        if na == 0 or nb == 0:
            return 0.0
        return float(np.dot(va, vb) / (na * nb))

    def words_nearest(self, word_or_vec, negative=None,
                      top_n: int = 10) -> List[str]:
        """``BasicModelUtils.wordsNearest`` — cosine top-N.

        Accepts a word, a raw vector, or a list of positive words; with
        ``negative`` this is the analogy query
        (``wordsNearest(positive, negative, top)``:
        mean(positive) - mean(negative), queried words excluded) — e.g.
        ``words_nearest(["king", "woman"], ["man"])``."""
        if isinstance(negative, int):   # legacy words_nearest(word, top_n)
            negative, top_n = None, negative
        if isinstance(word_or_vec, str):
            v = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
            if v is None:
                return []
        elif isinstance(word_or_vec, (list, tuple)) and word_or_vec \
                and isinstance(word_or_vec[0], str):
            vs = [self.get_word_vector(w) for w in word_or_vec]
            if any(x is None for x in vs):
                return []
            v = np.mean(vs, axis=0)
            exclude = set(word_or_vec)
        else:
            v = np.asarray(word_or_vec, np.float32)
            exclude = set()
        if negative:
            nvs = [self.get_word_vector(w) for w in negative]
            if any(x is None for x in nvs):
                return []
            v = v - np.mean(nvs, axis=0)
            exclude |= set(negative)
        syn0 = self.lookup_table.all_vectors()
        norms = np.linalg.norm(syn0, axis=1) * (np.linalg.norm(v) + 1e-12)
        sims = syn0 @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out

    def accuracy(self, questions: List[str]) -> float:
        """Analogy accuracy@1 over ``"a b c d"`` lines (d expected from
        b - a + c), the ``WordVectors.accuracy(questions)`` role; lines
        with out-of-vocab words are skipped (reference behaviour)."""
        correct = total = 0
        for line in questions:
            parts = line.split()
            if len(parts) != 4 or not all(self.has_word(w) for w in parts):
                continue
            a, b, c, d = parts
            got = self.words_nearest([b, c], [a], top_n=1)
            total += 1
            correct += bool(got and got[0] == d)
        return correct / total if total else float("nan")
