"""The port's pretrained-model helper against the JAX package's, on the
CPU: the reference's ``tests/test_trained_models.py`` cases on the port
(the ImageNet label table, top-k decoding, the VGG16 pre-processor and
its ``preprocessor.bin`` form, the helper's local resolution and its
error), with a tiny VGG-shaped Keras file (the committed
``tests/fixtures/keras/vgg16_tiny_k1_tf.h5``, and the reference test's
own writer) loaded by the port's Keras import and held against the JAX
import's output within 1e-5 of its max abs (f32; the convolution sums in
another order, and the raw-pixel logits, tens in size, carry that
rounding into the softmax), with the same top-5 labels.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.normalizers import \
    DataNormalization as JNorm
from deeplearning4j_tpu.modelimport import imagenet_labels as jlabels
from deeplearning4j_tpu.modelimport import trained_models as jtm
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.normalizers import DataNormalization
from deeplearning4j_tpu_torch.modelimport import imagenet_labels as plabels
from deeplearning4j_tpu_torch.modelimport.imagenet_labels import (
    IMAGENET_CLASS_INDEX, ImageNetLabels, decode_predictions,
    format_predictions)
from deeplearning4j_tpu_torch.modelimport.trained_models import (
    VGG_MEAN_RGB, TrainedModelHelper, TrainedModels, VGG16ImagePreProcessor)
from tests.test_trained_models import _write_tiny_vgg

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "keras", "vgg16_tiny_k1_tf.h5")
OUT_REL = 1e-5


class TestImageNetLabels:
    def test_table_equals_the_reference_s(self):
        assert IMAGENET_CLASS_INDEX == jlabels.IMAGENET_CLASS_INDEX
        assert len(IMAGENET_CLASS_INDEX) == 1000
        assert ImageNetLabels.get_label(281) == "tabby"
        assert ImageNetLabels.get_wnid(0) == "n01440764"
        assert ImageNetLabels.get_label(999) == "toilet_tissue"

    def test_decode_and_format_equal_the_reference_s(self):
        p = np.random.RandomState(0).rand(3, 1000).astype(np.float32)
        for top in (1, 5):
            assert decode_predictions(p, top) == \
                jlabels.decode_predictions(p, top)
        assert format_predictions(p[0], 2) == \
            jlabels.format_predictions(p[0], 2)
        with pytest.raises(ValueError, match="needs 1000"):
            decode_predictions(np.zeros((2, 10)))


class TestVGG16ImagePreProcessor:
    def test_nhwc_and_nchw_equal_the_reference(self):
        x = np.random.RandomState(0).randint(0, 256, (2, 4, 4, 3)).astype(
            np.float32)
        for arr in (x, np.moveaxis(x, -1, 1).copy()):
            got = DataSet(arr.copy(), np.zeros((2, 1), np.float32))
            want = JDataSet(arr.copy(), np.zeros((2, 1), np.float32))
            VGG16ImagePreProcessor().pre_process(got)
            jtm.VGG16ImagePreProcessor().pre_process(want)
            np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(VGG_MEAN_RGB, jtm.VGG_MEAN_RGB)

    def test_device_batch_is_shifted_there(self):
        x = np.random.RandomState(2).rand(2, 4, 4, 3).astype(np.float32) * 255
        d = DataSet(torch.from_numpy(x.copy()), None)
        h = DataSet(x.copy(), None)
        for pp in (VGG16ImagePreProcessor(),):
            pp.pre_process(d)
            pp.pre_process(h)
            assert isinstance(d.features, torch.Tensor)
            np.testing.assert_array_equal(d.features.numpy(), h.features)
            pp.revert(d)
            np.testing.assert_allclose(d.features.numpy(), x, rtol=1e-5,
                                       atol=1e-3)

    def test_persistence_reads_in_both_packages(self):
        pp = VGG16ImagePreProcessor()
        assert pp.to_bytes() == jtm.VGG16ImagePreProcessor().to_bytes()
        assert isinstance(DataNormalization.from_bytes(
            jtm.VGG16ImagePreProcessor().to_bytes()), VGG16ImagePreProcessor)
        assert isinstance(JNorm.from_bytes(pp.to_bytes()),
                          jtm.VGG16ImagePreProcessor)

    def test_rejects_non_image_batches(self):
        pp = VGG16ImagePreProcessor()
        with pytest.raises(ValueError, match="4-D"):
            pp.pre_process(DataSet(np.zeros((2, 10), np.float32), None))
        with pytest.raises(ValueError, match="3-channel"):
            pp.pre_process(DataSet(np.zeros((2, 4, 4, 5), np.float32), None))


def _images(seed=3, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, 8, 8, 3)).astype(
        np.float32)


class TestTrainedModelHelper:
    def test_specs_and_unknown_model(self):
        for m in ("vgg16", "vgg16notop"):
            assert TrainedModels.get_input_shape(m) == \
                jtm.TrainedModels.get_input_shape(m)
            assert TrainedModels.get_output_shape(m) == \
                jtm.TrainedModels.get_output_shape(m)
            assert TrainedModels.spec(m)["h5_file"] == \
                jtm.TrainedModels.spec(m)["h5_file"]
        assert isinstance(TrainedModels.get_pre_processor("vgg16"),
                          VGG16ImagePreProcessor)
        with pytest.raises(ValueError, match="unknown trained model"):
            TrainedModels.spec("resnet999")

    @pytest.mark.parametrize("source", ["committed", "reference_writer"])
    def test_explicit_path_to_prediction(self, tmp_path, source):
        """Weights → pre-process → predict → decode: the port's net against
        the JAX import of the same file."""
        h5 = FIXTURE if source == "committed" else str(
            _write_tiny_vgg(tmp_path / "tiny_vgg.h5"))
        net = TrainedModelHelper(TrainedModels.VGG16) \
            .set_path_to_h5(h5).load_model(device="cpu")
        jnet = jtm.TrainedModelHelper(jtm.TrainedModels.VGG16) \
            .set_path_to_h5(h5).load_model()
        img = _images()
        ds, jds = DataSet(img.copy(), None), JDataSet(img.copy(), None)
        TrainedModels.get_pre_processor("vgg16").pre_process(ds)
        jtm.TrainedModels.get_pre_processor("vgg16").pre_process(jds)
        got = np.asarray(net.output(ds.features))
        want = np.asarray(jnet.output(np.asarray(jds.features)))
        assert got.shape == (2, 1000)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-4)
        assert np.abs(got - want).max() <= OUT_REL * np.abs(want).max()
        top = TrainedModels.decode_predictions(got)
        assert [[lbl for _, lbl, _ in r] for r in top] == \
            [[lbl for _, lbl, _ in r]
             for r in jtm.TrainedModels.decode_predictions(want)]
        assert top[0][0][2] >= top[0][-1][2]

    def test_cache_dir_resolution(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_MODEL_CACHE", str(tmp_path))
        target = tmp_path / "vgg16" / TrainedModels.spec("vgg16")["h5_file"]
        target.parent.mkdir(parents=True)
        target.write_bytes(open(FIXTURE, "rb").read())
        net = TrainedModelHelper("vgg16").load_model(device="cpu")
        assert net.output(np.zeros((1, 8, 8, 3), np.float32)).shape == \
            (1, 1000)

    def test_missing_weights_error_names_the_fix(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_MODEL_CACHE", str(tmp_path / "empty"))
        with pytest.raises(FileNotFoundError) as e:
            TrainedModelHelper("vgg16")._resolve_h5()
        msg = str(e.value)
        assert "set_path_to_h5" in msg and "DL4J_TORCH_MODEL_CACHE" in msg
        assert str(tmp_path / "empty") in msg

    def test_bad_explicit_path_rejected(self):
        with pytest.raises(FileNotFoundError):
            TrainedModelHelper("vgg16").set_path_to_h5("/no/such/file.h5")

    def test_label_table_module_is_the_port_s_own(self):
        assert plabels.__name__.startswith("deeplearning4j_tpu_torch.")
