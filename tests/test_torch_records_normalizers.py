"""DataVec records, the normalizers and MagicQueue of the port against the
JAX package's, on the CPU.

The reference's ``tests/test_records_normalizers.py`` cases that need no
JAX mesh, each run through both packages on the same inputs: readers
give the same records, iterators the same arrays and masks (bitwise),
normalizers the same statistics (bitwise on host batches: both are the
same float64 numpy) and the same normalised arrays. Then what only the
port has: a batch held as a tensor is fitted and normalised as a tensor
(float64 on its device, never through numpy; moments within 1e-12 of
the host's, normalised values bitwise), ``preprocessor.bin`` read in
both directions, the native parser and the ``csv`` path against the
reference's native parser on an all-numeric file, and MagicQueue's order
and device affinity.
"""

import threading
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.conf.multi_layer import \
    MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu_torch.datasets import dataset as pds
from deeplearning4j_tpu_torch.datasets import normalizers as pnorm
from deeplearning4j_tpu_torch.datasets import records as prec
from deeplearning4j_tpu_torch.datasets.magic_queue import MagicQueue
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils import model_serializer

PACKAGES = {"jax": (jrec, jnorm, jds), "port": (prec, pnorm, pds)}


def _arrays(ds):
    return [None if a is None else np.asarray(a)
            for a in (ds.features, ds.labels, ds.features_mask,
                      ds.labels_mask)]


def _same_batches(make):
    """``make(records module, dataset module)`` gives an iterator in each
    package; every batch's four arrays must be equal, bitwise."""
    got = {name: [_arrays(d) for d in make(rec, ds)]
           for name, (rec, _, ds) in PACKAGES.items()}
    assert len(got["port"]) == len(got["jax"]) > 0
    for p, j in zip(got["port"], got["jax"]):
        for a, b in zip(p, j):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    return got["port"]


class TestRecordReaders:
    def test_csv_classification_one_hot(self):
        text = "1.0,2.0,0\n3.0,4.0,2\n5.0,6.0,1\n"
        b = _same_batches(lambda rec, ds: rec.RecordReaderDataSetIterator(
            rec.CSVRecordReader(text=text), batch_size=2, label_index=2,
            num_possible_labels=3))
        np.testing.assert_allclose(b[0][0], [[1, 2], [3, 4]])
        np.testing.assert_allclose(b[0][1], [[1, 0, 0], [0, 0, 1]])
        assert b[1][0].shape == (1, 2) and len(b) == 2

    def test_csv_regression_range(self):
        b = _same_batches(lambda rec, ds: rec.RecordReaderDataSetIterator(
            rec.CSVRecordReader(text="1,2,10,20\n3,4,30,40\n"), batch_size=2,
            label_index=2, label_index_to=3, regression=True))
        np.testing.assert_allclose(b[0][1], [[10, 20], [30, 40]])

    def test_csv_file_and_skip_lines(self, tmp_path):
        p = tmp_path / "data.csv"
        p.write_text("header,row,x\n1,2,0\n3,4,1\n")
        want = list(jrec.CSVRecordReader(path=str(p), skip_lines=1))
        assert list(prec.CSVRecordReader(path=str(p), skip_lines=1)) \
            == want == [[1.0, 2.0, 0.0], [3.0, 4.0, 1.0]]

    def test_csv_module_path_equals_the_native_parser(self, tmp_path):
        """An all-numeric file: the port's native parser
        (``use_native=True``, the default) and its ``csv`` path
        (``use_native=False``) give the reference's natively parsed
        records, floats included."""
        from deeplearning4j_tpu import nativelib
        r = np.random.RandomState(3)
        rows = np.concatenate([r.randn(40, 5) * 1e3,
                               r.randint(0, 10, (40, 1))], axis=1)
        p = tmp_path / "num.csv"
        p.write_text("a,b,c,d,e,label\n" + "\n".join(
            ",".join(repr(float(v)) for v in row) for row in rows) + "\n")
        native_rr = prec.CSVRecordReader(path=str(p), skip_lines=1,
                                         use_native=True)
        got = list(native_rr)
        assert isinstance(native_rr._native_rows, np.ndarray)
        plain_rr = prec.CSVRecordReader(path=str(p), skip_lines=1,
                                        use_native=False)
        plain = list(plain_rr)
        assert plain_rr._native_rows is None
        want = list(jrec.CSVRecordReader(path=str(p), skip_lines=1,
                                         use_native=True))
        assert got == plain == want == rows.tolist()
        assert nativelib.csv_parse(str(p), ",", 1).tolist() == got

    def test_native_path_falls_back_and_rereads(self, tmp_path):
        """Mixed content falls back to the ``csv`` module (``_native_rows``
        False), as the reference's reader does; each reset parses the
        file again, so a rewritten file is read anew."""
        p = tmp_path / "d.csv"
        p.write_text("1,2,0\n3,4,1\n")
        rr = prec.CSVRecordReader(path=str(p))
        assert list(rr) == [[1.0, 2.0, 0.0], [3.0, 4.0, 1.0]]
        assert isinstance(rr._native_rows, np.ndarray)
        p.write_text("5,6,1\n")
        rr.reset()
        assert list(rr) == [[5.0, 6.0, 1.0]]
        m = tmp_path / "m.csv"
        m.write_text("1,hello\n")
        for rec in (prec, jrec):
            mixed = rec.CSVRecordReader(path=str(m))
            assert list(mixed) == [[1.0, "hello"]]
            assert mixed._native_rows is False

    def test_csv_file_iterator_with_a_partial_last_batch(self, tmp_path):
        """A file whose records do not fill the last batch: the port gives
        the reference's batches (read from the same text) and then stops,
        the reader exhausted until reset."""
        text = "".join(f"{i},{i * 2},{i % 3}\n" for i in range(7))
        p = tmp_path / "d.csv"
        p.write_text(text)
        b = _same_batches(lambda rec, ds: rec.RecordReaderDataSetIterator(
            rec.CSVRecordReader(**({"path": str(p)} if rec is prec
                                   else {"text": text})),
            batch_size=3, label_index=2, num_possible_labels=3))
        assert [x[0].shape[0] for x in b] == [3, 3, 1]
        it = prec.RecordReaderDataSetIterator(
            prec.CSVRecordReader(path=str(p)), batch_size=3, label_index=2,
            num_possible_labels=3)
        assert len(list(it)) == len(list(it)) == 3

    def test_line_and_collection_readers(self):
        for rec, _, _ in PACKAGES.values():
            assert list(rec.LineRecordReader(lines=["a b", "c d"])) == \
                [["a b"], ["c d"]]
            assert list(rec.CollectionRecordReader([[1, 2], [3, 4]])) == \
                [[1, 2], [3, 4]]

    @pytest.mark.parametrize("bad", [-1, 5])
    def test_out_of_range_label_raises(self, bad):
        for rec, _, _ in PACKAGES.values():
            it = rec.RecordReaderDataSetIterator(
                rec.CollectionRecordReader([[1.0, 2.0, bad]]), batch_size=1,
                label_index=2, num_possible_labels=3)
            with pytest.raises(ValueError, match="outside"):
                next(iter(it))

    def test_file_readers_close_handles(self, tmp_path):
        p = tmp_path / "d.csv"
        p.write_text("1,2\n3,4\n")
        rr = prec.CSVRecordReader(path=str(p))
        assert len(list(rr)) == 2
        assert rr._fh is None
        rr.reset()
        next(iter(rr))
        rr.close()
        assert rr._fh is None

    def test_max_num_batches(self):
        b = _same_batches(lambda rec, ds: rec.RecordReaderDataSetIterator(
            rec.CollectionRecordReader([[i, i % 2] for i in range(10)]),
            batch_size=2, label_index=1, num_possible_labels=2,
            max_num_batches=2))
        assert len(b) == 2

    def test_labeled_image_records_require_num_labels(self):
        for rec, _, _ in PACKAGES.values():
            rr = rec.CollectionRecordReader([])
            rr.records = [[np.zeros((2, 2, 1), np.float32), 1.0]]
            with pytest.raises(ValueError, match="num_possible_labels"):
                next(iter(rec.RecordReaderDataSetIterator(rr, batch_size=1)))

    def test_image_records_and_directory_labels(self, tmp_path):
        """ImageRecordReader (Pillow, imported at the first record): the
        label from the parent directory, HWC float32 pixels."""
        from PIL import Image
        r = np.random.RandomState(4)
        for lab in ("cat", "dog"):
            (tmp_path / lab).mkdir()
            for k in range(2):
                Image.fromarray(r.randint(0, 256, (5, 6, 3)).astype(
                    np.uint8)).save(tmp_path / lab / f"{k}.png")
        b = _same_batches(lambda rec, ds: rec.RecordReaderDataSetIterator(
            rec.ImageRecordReader(4, 4, 3, root_dir=str(tmp_path)),
            batch_size=3, num_possible_labels=2))
        assert b[0][0].shape == (3, 4, 4, 3)
        np.testing.assert_array_equal(b[0][1].argmax(1), [0, 0, 1])


class TestSequenceIterators:
    def test_single_reader_equal_length(self):
        seqs = [[[0.1, 0.2, 0], [0.3, 0.4, 1]], [[0.5, 0.6, 1], [0.7, 0.8, 0]]]
        b = _same_batches(
            lambda rec, ds: rec.SequenceRecordReaderDataSetIterator(
                rec.CollectionSequenceRecordReader(seqs), batch_size=2,
                num_possible_labels=2, label_index=2))
        assert b[0][0].shape == (2, 2, 2) and b[0][2] is None
        np.testing.assert_allclose(b[0][1][0], [[1, 0], [0, 1]])

    @pytest.mark.parametrize("align", ["ALIGN_END", "ALIGN_START"])
    def test_two_readers_alignment_masks(self, align):
        fseqs = [[[1.0], [2.0], [3.0]], [[4.0]]]
        lseqs = [[[0]], [[1]]]
        b = _same_batches(
            lambda rec, ds: rec.SequenceRecordReaderDataSetIterator(
                rec.CollectionSequenceRecordReader(fseqs), batch_size=2,
                num_possible_labels=2,
                labels_reader=rec.CollectionSequenceRecordReader(lseqs),
                alignment=getattr(rec, align)))
        x, _, _, lm = b[0]
        if align == "ALIGN_END":
            np.testing.assert_allclose(lm[0], [0, 0, 1])
            np.testing.assert_allclose(x[1, :, 0], [0, 0, 4.0])
        else:
            np.testing.assert_allclose(lm[0], [1, 0, 0])

    @pytest.mark.parametrize("align", ["ALIGN_END", "ALIGN_START"])
    def test_single_reader_variable_length_keeps_masks(self, align):
        seqs = [[[0.1, 0], [0.2, 1], [0.3, 0]], [[0.4, 1]]]
        b = _same_batches(
            lambda rec, ds: rec.SequenceRecordReaderDataSetIterator(
                rec.CollectionSequenceRecordReader(seqs), batch_size=2,
                num_possible_labels=2, label_index=1,
                alignment=getattr(rec, align)))
        assert b[0][2] is not None and b[0][3] is not None
        want = [0, 0, 1] if align == "ALIGN_END" else [1, 0, 0]
        np.testing.assert_allclose(b[0][2][1], want)

    def test_unlabeled_sequences(self):
        seqs = [[[0.1, 0.2], [0.3, 0.4]], [[0.5, 0.6]]]
        b = _same_batches(
            lambda rec, ds: rec.SequenceRecordReaderDataSetIterator(
                rec.CollectionSequenceRecordReader(seqs), batch_size=2))
        assert b[0][1] is None and b[0][2] is not None

    def test_mismatched_reader_lengths_raise(self):
        for rec, _, _ in PACKAGES.values():
            it = iter(rec.SequenceRecordReaderDataSetIterator(
                rec.CollectionSequenceRecordReader([[[1.0]], [[2.0]],
                                                    [[3.0]]]),
                batch_size=2, num_possible_labels=2,
                labels_reader=rec.CollectionSequenceRecordReader(
                    [[[0]], [[1]]])))
            next(it)
            with pytest.raises(ValueError, match="exhausted"):
                next(it)

    def test_csv_sequence_files(self, tmp_path):
        r = np.random.RandomState(5)
        paths = []
        for k in range(5):
            p = tmp_path / f"s{k}.csv"
            n = r.randint(2, 6)
            p.write_text("".join(f"{r.rand():.4f},{r.rand():.4f},"
                                 f"{r.randint(3)}\n" for _ in range(n)))
            paths.append(str(p))
        b = _same_batches(
            lambda rec, ds: rec.SequenceRecordReaderDataSetIterator(
                rec.CSVSequenceRecordReader(paths), batch_size=2,
                num_possible_labels=3, label_index=2,
                alignment=rec.ALIGN_END))
        assert len(b) == 3 and b[0][0].shape[2] == 2


class TestMultiDataSetIterator:
    def test_named_readers_inputs_outputs(self):
        def make(rec):
            return (rec.RecordReaderMultiDataSetIterator(batch_size=2)
                    .add_reader("r", rec.CollectionRecordReader(
                        [[1, 2, 3, 0], [4, 5, 6, 1], [7, 8, 9, 1]]))
                    .add_input("r", 0, 1).add_output("r", 2, 2)
                    .add_output_one_hot("r", 3, 2))
        got = [list(make(rec)) for rec, _, _ in PACKAGES.values()]
        for p, j in zip(*got):
            for a, b in zip(p.features + p.labels, j.features + j.labels):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[0][0].labels[1], [[1, 0], [0, 1]])

    def test_mismatched_named_readers_raise(self):
        for rec, _, _ in PACKAGES.values():
            it = (rec.RecordReaderMultiDataSetIterator(batch_size=4)
                  .add_reader("a", rec.CollectionRecordReader([[1], [2], [3]]))
                  .add_reader("b", rec.CollectionRecordReader([[1], [2]]))
                  .add_input("a").add_output("b"))
            with pytest.raises(ValueError, match="mismatched record counts"):
                next(iter(it))


def _stats(norm):
    return {k: v for k, v in vars(norm).items() if not k.startswith("_")}


def _fit_both(make_norm, make_data):
    """Fit ``make_norm(module)`` in each package on ``make_data(dataset
    module)``; the statistics must be equal, bitwise."""
    fitted = {}
    for name, (_, norm, ds) in PACKAGES.items():
        fitted[name] = make_norm(norm).fit(make_data(ds))
    p, j = _stats(fitted["port"]), _stats(fitted["jax"])
    assert sorted(p) == sorted(j)
    for k in j:
        if isinstance(j[k], np.ndarray):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        else:
            assert p[k] == j[k], k
    return fitted


def _transform_both(fitted, make_ds, revert=False):
    out = {}
    for name, (_, _, ds) in PACKAGES.items():
        d = make_ds(ds)
        fitted[name].pre_process(d)
        if revert:
            fitted[name].revert(d)
        out[name] = _arrays(d)
    for a, b in zip(out["port"], out["jax"]):
        if b is not None:
            np.testing.assert_array_equal(a, b)
    return out["port"]


class TestNormalizers:
    def test_standardize_fit_transform_revert(self, rng):
        X = rng.randn(200, 5) * 3.0 + 7.0
        fitted = _fit_both(lambda n: n.NormalizerStandardize(),
                           lambda ds: ds.ArrayDataSetIterator(
                               X, np.zeros((200, 1)), batch_size=32))
        got = _transform_both(fitted, lambda ds: ds.DataSet(X.copy(), None))
        np.testing.assert_allclose(got[0].mean(axis=0), 0, atol=1e-5)
        np.testing.assert_allclose(got[0].std(axis=0), 1, atol=1e-4)
        back = _transform_both(fitted, lambda ds: ds.DataSet(X.copy(), None),
                               revert=True)
        np.testing.assert_allclose(back[0], X, atol=1e-4)

    def test_standardize_streaming_matches_full(self, rng):
        X = rng.randn(100, 3)
        fitted = _fit_both(lambda n: n.NormalizerStandardize(),
                           lambda ds: ds.ArrayDataSetIterator(
                               X, np.zeros((100, 1)), batch_size=7))
        np.testing.assert_allclose(fitted["port"].mean, X.mean(axis=0),
                                   atol=1e-10)
        np.testing.assert_allclose(fitted["port"].std, X.std(axis=0),
                                   atol=1e-10)

    def test_standardize_labels_and_masked_rnn(self, rng):
        X, Y = rng.randn(4, 6, 2), rng.randn(4, 6, 3) * 2 + 1
        mask = np.zeros((4, 6), np.float32)
        mask[:, :3] = 1.0
        fitted = _fit_both(
            lambda n: n.NormalizerStandardize().fit_label(True),
            lambda ds: ds.DataSet(X.copy(), Y.copy(), features_mask=mask,
                                  labels_mask=mask))
        np.testing.assert_allclose(fitted["port"].mean,
                                   X[:, :3].reshape(-1, 2).mean(axis=0),
                                   atol=1e-10)
        got = _transform_both(fitted, lambda ds: ds.DataSet(X.copy(),
                                                            Y.copy()))
        np.testing.assert_array_equal(fitted["port"].revert_labels(got[1]),
                                      fitted["jax"].revert_labels(got[1]))

    def test_minmax(self, rng):
        X = rng.rand(50, 4) * 10 - 5
        fitted = _fit_both(lambda n: n.NormalizerMinMaxScaler(),
                           lambda ds: ds.DataSet(X.copy(), None))
        got = _transform_both(fitted, lambda ds: ds.DataSet(X.copy(), None))
        assert got[0].min() >= -1e-6 and got[0].max() <= 1 + 1e-6
        back = _transform_both(fitted, lambda ds: ds.DataSet(X.copy(), None),
                               revert=True)
        np.testing.assert_allclose(back[0], X, atol=1e-4)

    def test_minmax_labels(self, rng):
        X, Y = rng.rand(20, 3), rng.rand(20, 2) * 10
        fitted = _fit_both(lambda n: n.NormalizerMinMaxScaler(-1, 2)
                           .fit_label(True),
                           lambda ds: ds.DataSet(X.copy(), Y.copy()))
        got = _transform_both(fitted, lambda ds: ds.DataSet(X.copy(),
                                                            Y.copy()))
        assert got[1].max() <= 2 + 1e-6 and got[1].min() >= -1 - 1e-6

    def test_image_scaler(self):
        fitted = {n: norm.ImagePreProcessingScaler(a=-1, b=1)
                  for n, (_, norm, _) in PACKAGES.items()}
        got = _transform_both(fitted, lambda ds: ds.DataSet(
            np.asarray([[0.0, 127.5, 255.0]]), None))
        np.testing.assert_allclose(got[0], [[-1, 0, 1.0]])

    def test_list_iterator_no_double_normalize(self, rng):
        X = rng.rand(6, 3) * 255
        ds_list = [pds.DataSet(X[:3].copy(), None),
                   pds.DataSet(X[3:].copy(), None)]
        it = pds.ListDataSetIterator(ds_list)
        it.set_pre_processor(pnorm.ImagePreProcessingScaler())
        first = [np.array(d.features) for d in it]
        second = [np.array(d.features) for d in it]
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        assert ds_list[0].features.max() > 1.0

    def test_iterator_pre_processor_hook(self, rng):
        X = rng.rand(10, 3) * 255
        it = pds.ArrayDataSetIterator(X, np.zeros((10, 1)), batch_size=5)
        it.set_pre_processor(pnorm.ImagePreProcessingScaler())
        assert next(iter(it)).features.max() <= 1.0

    @pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
    def test_preprocessor_bin_reads_in_both_packages(self, rng, kind):
        """The same statistics give the same bytes, and each package reads
        the other's into an equal normalizer."""
        X = rng.randn(30, 4)

        def make(n):
            return {"standardize": lambda: n.NormalizerStandardize()
                    .fit_label(True),
                    "minmax": lambda: n.NormalizerMinMaxScaler(-2, 3),
                    "image": lambda: n.ImagePreProcessingScaler(0, 2, 10)}[
                        kind]()
        fitted = _fit_both(make, lambda ds: ds.DataSet(X.copy(), X[:, :2]))
        blobs = {n: f.to_bytes() for n, f in fitted.items()}
        assert blobs["port"] == blobs["jax"]
        back_port = pnorm.DataNormalization.from_bytes(blobs["jax"])
        back_jax = jnorm.DataNormalization.from_bytes(blobs["port"])
        assert type(back_port).__name__ == type(back_jax).__name__
        a = pds.DataSet(X.copy(), X[:, :2].copy())
        b = jds.DataSet(X.copy(), X[:, :2].copy())
        back_port.pre_process(a)
        back_jax.pre_process(b)
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)

    def test_device_batches_stay_tensors(self, rng):
        """A tensor batch is fitted and normalised as a tensor, in float64
        on its device; the statistics agree with the host fit within
        1e-12 and the normalised values equal the host path's bit for
        bit (the same float64 operations)."""
        X = rng.randn(64, 6, 3) * 4 + 2
        mask = (rng.rand(64, 6) < 0.7).astype(np.float32)
        host = pnorm.NormalizerStandardize().fit(
            pds.DataSet(X.copy(), None, features_mask=mask))
        dev = pnorm.NormalizerStandardize().fit(pds.DataSet(
            torch.from_numpy(X), None, features_mask=torch.from_numpy(mask)))
        np.testing.assert_allclose(dev.mean, host.mean, rtol=1e-12)
        np.testing.assert_allclose(dev.std, host.std, rtol=1e-12)
        d = pds.DataSet(torch.from_numpy(X.astype(np.float32)), None)
        h = pds.DataSet(X.astype(np.float32), None)
        for norm in (host, pnorm.NormalizerMinMaxScaler().fit(h),
                     pnorm.ImagePreProcessingScaler()):
            d2 = pds.DataSet(d.features.clone(), None)
            h2 = pds.DataSet(h.features.copy(), None)
            norm.pre_process(d2)
            norm.pre_process(h2)
            assert isinstance(d2.features, torch.Tensor)
            assert d2.features.dtype == torch.float32
            np.testing.assert_array_equal(d2.features.numpy(), h2.features)
            norm.revert(d2)
            norm.revert(h2)
            np.testing.assert_array_equal(d2.features.numpy(), h2.features)


def _dense_conf(n_in, n_out):
    """A dense net's JSON, built by the reference's builder."""
    return (JBuilder.Builder().seed(1).list()
            .layer(DenseLayer(n_in=n_in, n_out=5))
            .layer(OutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .build().to_json())


class TestArchiveNormalizer:
    def test_checkpoint_preprocessor_bin_both_ways(self, tmp_path, rng):
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_dense_conf(4, 3)),
                                device="cpu").init()
        norm = pnorm.NormalizerStandardize().fit(
            pds.DataSet(rng.randn(20, 4), None))
        path = str(tmp_path / "model.zip")
        model_serializer.write_model(net, path, normalizer=norm)
        back = model_serializer.restore_normalizer_from_file(path)
        np.testing.assert_array_equal(back.mean, norm.mean)
        jback = jser.restore_normalizer_from_file(path)
        assert isinstance(jback, jnorm.NormalizerStandardize)
        np.testing.assert_array_equal(jback.std, norm.std)
        # and a reference archive's normalizer reads in the port
        jser.add_normalizer_to_model(path, jnorm.NormalizerMinMaxScaler()
                                     .fit(jds.DataSet(rng.rand(10, 4), None)))
        assert isinstance(model_serializer.restore_normalizer_from_file(path),
                          pnorm.NormalizerMinMaxScaler)

    def test_add_normalizer_replaces_existing(self, tmp_path, rng):
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_dense_conf(2, 2)),
                                device="cpu").init()
        path = str(tmp_path / "model.zip")
        model_serializer.write_model(net, path)
        assert model_serializer.restore_normalizer_from_file(path) is None
        model_serializer.add_normalizer_to_model(
            path, pnorm.NormalizerMinMaxScaler().fit(
                pds.DataSet(rng.rand(10, 2), None)))
        model_serializer.add_normalizer_to_model(
            path, pnorm.ImagePreProcessingScaler())
        with zipfile.ZipFile(path) as z:
            assert z.namelist().count(model_serializer.NORMALIZER_NAME) == 1
        assert isinstance(model_serializer.restore_normalizer_from_file(path),
                          pnorm.ImagePreProcessingScaler)
        assert model_serializer.restore_model(path, device="cpu") is not None


class TestCsvIntoFit:
    def test_csv_standardized_fit_matches_the_reference(self, tmp_path, rng):
        """CSVRecordReader → RecordReaderDataSetIterator → a fitted
        NormalizerStandardize as its pre-processor → fit(iterator): the
        same batches in both packages and the port's net within 1e-5 of
        the reference's after two epochs from the same parameters."""
        X = rng.randn(40, 4) * 3 + 1
        y = (X[:, 0] > 1).astype(int) + (X[:, 1] > 1)
        p = tmp_path / "d.csv"
        p.write_text("".join(",".join(f"{v:.6f}" for v in row) + f",{c}\n"
                             for row, c in zip(X, y)))
        its = {}
        for name, (rec, norm, ds) in PACKAGES.items():
            it = rec.RecordReaderDataSetIterator(
                rec.CSVRecordReader(path=str(p)), batch_size=8,
                label_index=4, num_possible_labels=3)
            it.set_pre_processor(norm.NormalizerStandardize().fit(it))
            its[name] = it
        conf = _dense_conf(4, 3)
        jnet = JNet(JConf.from_json(conf)).init()
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf),
                                device="cpu").init()
        net.set_params(np.asarray(jnet.params()))
        jnet.fit(its["jax"], epochs=2)
        net.fit(its["port"], epochs=2)
        want = np.asarray(jnet.params())
        got = np.asarray(net.params())
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


class TestMagicQueue:
    def test_round_robin_and_affinity(self):
        q = MagicQueue(3)
        for i in range(9):
            q.add(i)
        assert q.size() == 9
        assert [q.take(0) for _ in range(3)] == [0, 3, 6]
        assert [q.take(1) for _ in range(3)] == [1, 4, 7]
        assert q.size(2) == 3 and q.size() == 3
        assert q.poll(0) is None
        q.add_for(0, "direct")
        assert q.take(0) == "direct"

    def test_concurrent_producers_consumers(self):
        q = MagicQueue(2, capacity_per_device=4)
        got = {0: [], 1: []}

        def consume(dev):
            for _ in range(20):
                got[dev].append(q.take(dev))

        threads = [threading.Thread(target=consume, args=(d,), daemon=True)
                   for d in (0, 1)]
        for t in threads:
            t.start()
        for i in range(40):
            q.add(i)
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads), "consumer hung"
        assert sorted(got[0] + got[1]) == list(range(40))
        assert len(got[0]) == len(got[1]) == 20
