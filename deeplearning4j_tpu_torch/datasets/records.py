"""Record readers and the record-to-DataSet iterators (the DataVec
seam): the port of ``deeplearning4j_tpu/datasets/records.py``.

DataVec's ``RecordReader``s (CSV, line, in-memory collection, CSV
sequence, in-memory sequence, image) and the adapters
``RecordReaderDataSetIterator.java`` (a one-hot class at ``label_index``
over ``num_possible_labels``, or regression targets
``label_index..label_index_to``), ``SequenceRecordReaderDataSetIterator.java``
(EQUAL_LENGTH, ALIGN_START or ALIGN_END, with masks, ``:49,:288-330``)
and ``RecordReaderMultiDataSetIterator.java`` (named readers with
``add_input``/``add_output`` column ranges).

Readers give plain Python records on the host and batches are numpy, as
in the reference; a staging iterator (``datasets/async_iterator.py``)
moves them to the card. As in the reference, ``CSVRecordReader`` parses
an all-numeric file on disk with the native C++ parser
(``nativelib.csv_parse``, ``native/src/csv.cpp``) and any other file, or
any file when the library is unavailable, with the ``csv`` module; both
give the same records (float64 values).
"""

from __future__ import annotations

import csv
import io
import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, DataSetIterator, MultiDataSet, MultiDataSetIterator)

__all__ = ["ALIGN_END", "ALIGN_EQUAL_LENGTH", "ALIGN_START",
           "CSVRecordReader", "CSVSequenceRecordReader",
           "CollectionRecordReader", "CollectionSequenceRecordReader",
           "ImageRecordReader", "LineRecordReader", "RecordReader",
           "RecordReaderDataSetIterator", "RecordReaderMultiDataSetIterator",
           "SequenceRecordReader", "SequenceRecordReaderDataSetIterator"]


class RecordReader:
    """Stream of records; each record is a list of values (DataVec Writables)."""

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        raise NotImplementedError

    def reset(self):
        pass

    def close(self):
        pass


class CollectionRecordReader(RecordReader):
    """Iterate an in-memory collection of records (DataVec CollectionRecordReader)."""

    def __init__(self, records):
        self.records = list(records)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self.records):
            raise StopIteration
        rec = self.records[self._pos]
        self._pos += 1
        return list(rec)


class LineRecordReader(RecordReader):
    """One record per line of text (DataVec LineRecordReader)."""

    def __init__(self, path=None, lines=None):
        if (path is None) == (lines is None):
            raise ValueError("give exactly one of path= or lines=")
        self.path = path
        self._lines = None if lines is None else [str(l) for l in lines]
        self._it = None
        self._fh = None

    def reset(self):
        self.close()
        if self._lines is not None:
            self._it = iter(self._lines)
        else:
            self._fh = open(self.path, "r")
            self._it = (l.rstrip("\n") for l in self._fh)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __next__(self):
        if self._it is None:
            self.reset()
        try:
            return [next(self._it)]
        except StopIteration:
            self.close()
            raise


class CSVRecordReader(RecordReader):
    """CSV rows as records of parsed numbers or strings (DataVec
    CSVRecordReader).

    ``skip_lines`` is DL4J's skipNumLines; a value parses to a float when
    it can, else stays a string. With ``use_native`` an all-numeric file
    on disk takes the native parser (``_native_rows`` then holds its
    matrix; False means the file was declined); mixed content falls back
    to the ``csv`` module. Each ``reset`` parses the file again, so a file
    rewritten on disk is read anew. Once exhausted, the reader stays
    exhausted until ``reset``, as the reference's native path does (its
    ``csv`` path would read the closed file and raise).
    """

    def __init__(self, path=None, text=None, skip_lines=0, delimiter=",",
                 use_native=True):
        if (path is None) == (text is None):
            raise ValueError("give exactly one of path= or text=")
        self.path = path
        self.text = text
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.use_native = use_native
        self._it = None
        self._fh = None
        self._native_rows = None

    @staticmethod
    def _parse(v):
        try:
            return float(v)
        except ValueError:
            return v

    def reset(self):
        self.close()
        if self.path is not None and self.use_native:
            from deeplearning4j_tpu_torch import nativelib
            mat = nativelib.csv_parse(self.path, self.delimiter,
                                      self.skip_lines)
            self._native_rows = False if mat is None else mat
            if mat is not None:
                self._it = iter(mat.tolist())
                return
        if self.path is not None:
            self._fh = open(self.path, "r", newline="")
            src = self._fh
        else:
            src = io.StringIO(self.text)
        reader = csv.reader(src, delimiter=self.delimiter)
        for _ in range(self.skip_lines):
            next(reader, None)
        self._it = reader

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __next__(self):
        if self._it is None:
            self.reset()
        try:
            row = next(self._it)
            while row is not None and len(row) == 0:  # skip blank lines
                row = next(self._it)
        except StopIteration:
            self.close()
            self._it = iter(())
            raise
        return [self._parse(v) for v in row]


class SequenceRecordReader(RecordReader):
    """Base: each __next__ returns a SEQUENCE = list of records (list of lists)."""


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences):
        self.sequences = list(sequences)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self.sequences):
            raise StopIteration
        seq = self.sequences[self._pos]
        self._pos += 1
        return [list(r) for r in seq]


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (DataVec CSVSequenceRecordReader)."""

    def __init__(self, paths, skip_lines=0, delimiter=","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self.paths):
            raise StopIteration
        path = self.paths[self._pos]
        self._pos += 1
        rr = CSVRecordReader(path=path, skip_lines=self.skip_lines,
                             delimiter=self.delimiter)
        return [rec for rec in rr]


class ImageRecordReader(RecordReader):
    """Image files → [flattened-or-HWC image array, label-index] records
    (DataVec ImageRecordReader: label from parent directory name).

    Decoding uses Pillow on the host, imported at the first record; it
    gives float32 HWC in [0, 255], which ``ImagePreProcessingScaler``
    (normalizers.py) scales.
    """

    def __init__(self, height, width, channels=3, paths=None, root_dir=None,
                 extensions=(".png", ".jpg", ".jpeg", ".bmp")):
        self.height, self.width, self.channels = height, width, channels
        if root_dir is not None:
            self.labels = sorted(
                d for d in os.listdir(root_dir)
                if os.path.isdir(os.path.join(root_dir, d)))
            self._entries = []
            for li, lab in enumerate(self.labels):
                sub = os.path.join(root_dir, lab)
                for f in sorted(os.listdir(sub)):
                    if f.lower().endswith(tuple(extensions)):
                        self._entries.append((os.path.join(sub, f), li))
        else:
            self.labels = []
            self._entries = [(p, -1) for p in (paths or [])]
        self._pos = 0

    def num_labels(self):
        return len(self.labels)

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self._entries):
            raise StopIteration
        path, label = self._entries[self._pos]
        self._pos += 1
        from PIL import Image
        img = Image.open(path)
        img = img.convert("RGB" if self.channels == 3 else "L")
        img = img.resize((self.width, self.height))
        arr = np.asarray(img, np.float32).reshape(self.height, self.width, self.channels)
        rec = [arr]
        if label >= 0:
            rec.append(float(label))
        return rec


def _one_hot(value, num_labels, what="label"):
    cls = int(float(value))
    if not 0 <= cls < num_labels:
        raise ValueError(
            f"{what} value {cls} outside [0, {num_labels}) — check label column "
            "and num_possible_labels")
    out = np.zeros((num_labels,), np.float32)
    out[cls] = 1.0
    return out


def _split_record(rec, label_index, label_index_to, num_labels, regression):
    """Split one record into (feature-vector, label-vector) per the reference's
    RecordReaderDataSetIterator.getDataSet semantics."""
    vals = list(rec)
    if label_index < 0:
        feats = [v for v in vals]
        return np.asarray(feats, np.float32), None
    if regression:
        lo = label_index
        hi = label_index_to if label_index_to >= 0 else label_index
        label = np.asarray([float(vals[i]) for i in range(lo, hi + 1)], np.float32)
        feats = [float(v) for i, v in enumerate(vals) if i < lo or i > hi]
    else:
        label = _one_hot(vals[label_index], num_labels)
        feats = [float(v) for i, v in enumerate(vals) if i != label_index]
    return np.asarray(feats, np.float32), label


class RecordReaderDataSetIterator(DataSetIterator):
    """records → DataSet minibatches (RecordReaderDataSetIterator.java:70-122).

    Classification: one-hot of the integer at ``label_index`` over
    ``num_possible_labels`` classes. Regression: targets are columns
    ``label_index..label_index_to`` inclusive. ``label_index=-1`` → unlabeled.
    Records whose first value is an ndarray (ImageRecordReader) use it as the
    feature tensor directly.
    """

    def __init__(self, record_reader, batch_size, label_index=-1,
                 num_possible_labels=-1, label_index_to=-1, regression=False,
                 max_num_batches=-1):
        self.reader = record_reader
        self._batch = batch_size
        self.label_index = label_index
        self.label_index_to = label_index_to
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.max_num_batches = max_num_batches
        self._batches_done = 0
        self._it = None

    def reset(self):
        self.reader.reset()
        self._it = iter(self.reader)
        self._batches_done = 0

    def batch_size(self):
        return self._batch

    def __next__(self):
        if self._it is None:
            self.reset()
        if 0 <= self.max_num_batches <= self._batches_done:
            raise StopIteration
        feats, labels = [], []
        for _ in range(self._batch):
            try:
                rec = next(self._it)
            except StopIteration:
                break
            if len(rec) and isinstance(rec[0], np.ndarray):
                feats.append(np.asarray(rec[0], np.float32))
                if len(rec) > 1:
                    if self.num_possible_labels <= 0:
                        raise ValueError(
                            "labeled image records need num_possible_labels > 0 "
                            "(use reader.num_labels())")
                    labels.append(_one_hot(rec[1], self.num_possible_labels,
                                           "image label"))
            else:
                f, l = _split_record(rec, self.label_index, self.label_index_to,
                                     self.num_possible_labels, self.regression)
                feats.append(f)
                if l is not None:
                    labels.append(l)
        if not feats:
            raise StopIteration
        self._batches_done += 1
        x = np.stack(feats)
        y = np.stack(labels) if labels else None
        return DataSet(x, y)


ALIGN_EQUAL_LENGTH = "EQUAL_LENGTH"
ALIGN_START = "ALIGN_START"
ALIGN_END = "ALIGN_END"


def _pad_batch(seqs, max_len, align):
    """Stack [T_i, k] arrays into [n, max_len, k] + [n, max_len] mask, padding at
    the end (ALIGN_START/EQUAL_LENGTH) or the start (ALIGN_END) —
    SequenceRecordReaderDataSetIterator.java:288-330."""
    n = len(seqs)
    k = seqs[0].shape[1]
    out = np.zeros((n, max_len, k), np.float32)
    mask = np.zeros((n, max_len), np.float32)
    for i, s in enumerate(seqs):
        t = s.shape[0]
        if align == ALIGN_END:
            out[i, max_len - t:] = s
            mask[i, max_len - t:] = 1.0
        else:
            out[i, :t] = s
            mask[i, :t] = 1.0
    return out, mask


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → RNN DataSets [batch, time, size] with masks.

    Single-reader mode: each timestep record holds features + label column
    (as in the reference's single-reader constructor). Two-reader mode:
    separate feature/label sequence readers with an AlignmentMode
    (SequenceRecordReaderDataSetIterator.java:49).
    """

    def __init__(self, features_reader, batch_size, num_possible_labels=-1,
                 labels_reader=None, label_index=-1, regression=False,
                 alignment=ALIGN_EQUAL_LENGTH):
        self.freader = features_reader
        self.lreader = labels_reader
        self._batch = batch_size
        self.num_possible_labels = num_possible_labels
        self.label_index = label_index
        self.regression = regression
        self.alignment = alignment
        self._fit = None
        self._lit = None

    def reset(self):
        self.freader.reset()
        self._fit = iter(self.freader)
        if self.lreader is not None:
            self.lreader.reset()
            self._lit = iter(self.lreader)

    def batch_size(self):
        return self._batch

    def _seq_to_arrays(self, seq):
        """One sequence (list of records) → ([T, nf] features, [T, nl] labels)."""
        fs, ls = [], []
        for rec in seq:
            f, l = _split_record(rec, self.label_index, -1,
                                 self.num_possible_labels, self.regression)
            fs.append(f)
            if l is not None:
                ls.append(l)
        return np.stack(fs), (np.stack(ls) if ls else None)

    def __next__(self):
        if self._fit is None:
            self.reset()
        fseqs, lseqs = [], []
        for _ in range(self._batch):
            try:
                fseq = next(self._fit)
            except StopIteration:
                break
            if self.lreader is None:
                f, l = self._seq_to_arrays(fseq)
                fseqs.append(f)
                lseqs.append(l)
            else:
                try:
                    lseq = next(self._lit)
                except StopIteration:
                    raise ValueError(
                        "labels reader exhausted before features reader — "
                        "mismatched sequence counts") from None
                fseqs.append(np.asarray([[float(v) for v in r] for r in fseq], np.float32))
                lab = []
                for r in lseq:
                    if self.regression:
                        lab.append([float(v) for v in r])
                    else:
                        lab.append(_one_hot(r[0], self.num_possible_labels,
                                            "sequence label"))
                lseqs.append(np.asarray(lab, np.float32))
        if not fseqs:
            raise StopIteration
        fmax = max(s.shape[0] for s in fseqs)
        unlabeled = any(l is None for l in lseqs)
        if unlabeled:
            x, xm = _pad_batch(fseqs, fmax, self.alignment)
            return DataSet(x, None, None if xm.all() else xm, None)
        lmax = max(s.shape[0] for s in lseqs)
        if self.alignment == ALIGN_EQUAL_LENGTH:
            if fmax != lmax or any(f.shape[0] != l.shape[0] for f, l in zip(fseqs, lseqs)):
                raise ValueError(
                    "EQUAL_LENGTH alignment but feature/label lengths differ "
                    "(use ALIGN_START or ALIGN_END)")
        m = max(fmax, lmax)
        x, xm = _pad_batch(fseqs, m, self.alignment)
        y, ym = _pad_batch(lseqs, m, self.alignment)
        # drop a mask only when it is genuinely all-ones (no padding at all)
        return DataSet(x, y,
                       None if xm.all() else xm,
                       None if ym.all() else ym)


class RecordReaderMultiDataSetIterator(MultiDataSetIterator):
    """Named-reader builder → MultiDataSet (RecordReaderMultiDataSetIterator.java).

    .add_reader(name, reader).add_input(name, lo, hi)
    .add_output(name, lo, hi) / .add_output_one_hot(name, col, n_classes)
    Column ranges are inclusive, mirroring the reference builder.
    """

    def __init__(self, batch_size):
        self._batch = batch_size
        self.readers = {}
        self.inputs = []   # (reader, lo, hi)
        self.outputs = []  # (reader, lo, hi, one_hot_classes or None)
        self._its = None

    def add_reader(self, name, reader):
        self.readers[name] = reader
        return self

    def add_input(self, name, lo=0, hi=-1):
        self.inputs.append((name, lo, hi))
        return self

    def add_output(self, name, lo=0, hi=-1):
        self.outputs.append((name, lo, hi, None))
        return self

    def add_output_one_hot(self, name, col, n_classes):
        self.outputs.append((name, col, col, n_classes))
        return self

    def reset(self):
        for r in self.readers.values():
            r.reset()
        self._its = {n: iter(r) for n, r in self.readers.items()}

    def __next__(self):
        if self._its is None:
            self.reset()
        rows = {}
        count = 0
        for _ in range(self._batch):
            recs, exhausted = {}, []
            for n, it in self._its.items():
                try:
                    recs[n] = next(it)
                except StopIteration:
                    exhausted.append(n)
            if exhausted and recs:
                raise ValueError(
                    f"readers {exhausted} exhausted before {sorted(recs)} — "
                    "mismatched record counts across named readers")
            if exhausted:
                break
            for n, rec in recs.items():
                rows.setdefault(n, []).append([float(v) for v in rec])
            count += 1
        if count == 0:
            raise StopIteration

        def subset(spec):
            name, lo, hi, *oh = spec + (None,) * (4 - len(spec))
            arr = np.asarray(rows[name], np.float32)
            hi2 = arr.shape[1] - 1 if hi < 0 else hi
            sub = arr[:, lo:hi2 + 1]
            if oh[0]:
                n_classes = oh[0]
                out = np.zeros((sub.shape[0], n_classes), np.float32)
                out[np.arange(sub.shape[0]), sub[:, 0].astype(int)] = 1.0
                return out
            return sub

        feats = [subset(s) for s in self.inputs]
        labs = [subset(s) for s in self.outputs]
        return MultiDataSet(feats, labs)
