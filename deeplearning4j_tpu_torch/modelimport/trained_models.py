"""Pretrained image classifiers: the port of
``deeplearning4j_tpu/modelimport/trained_models.py``
(``trainedmodels/TrainedModels.java``: VGG16 and VGG16NOTOP with their
pre-processor, input and output shapes and ``decodePredictions``; and
``trainedmodels/TrainedModelHelper.java``: the local weights file and
``loadModel``).

The weights file is found locally only, in this order: an explicit
``set_path_to_h5(path)``, then the cache
``<DL4J_TORCH_MODEL_CACHE>/<model>/<file>`` (the counterpart of
``DL4J_TPU_MODEL_CACHE``). The reference's download branch is not
ported: a missing file raises an error that names both places. The
model is loaded through the port's Keras import (``modelimport/keras.py``)
on ``device`` (None means the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.datasets.normalizers import (
    DataNormalization, register_normalizer)
from deeplearning4j_tpu_torch.modelimport.imagenet_labels import (
    ImageNetLabels, decode_predictions, format_predictions)

__all__ = ["ImageNetLabels", "TrainedModelHelper", "TrainedModels",
           "VGG16ImagePreProcessor", "decode_predictions",
           "format_predictions"]

# ImageNet channel means, RGB order (nd4j VGG16ImagePreProcessor)
VGG_MEAN_RGB = np.array([123.68, 116.779, 103.939], np.float32)


@register_normalizer
class VGG16ImagePreProcessor(DataNormalization):
    """Subtract the ImageNet per-channel mean from raw-pixel images
    (nd4j ``VGG16ImagePreProcessor``). The channels may sit last (NHWC,
    the nets' layout) or first (NCHW). A batch on the card is shifted
    there, in f32, as the reference shifts a host batch."""

    def __init__(self):
        pass

    def fit(self, data):
        return self   # the statistics are fixed constants

    @staticmethod
    def _mean(x, channels_last):
        m = VGG_MEAN_RGB if channels_last else VGG_MEAN_RGB[None, :, None,
                                                            None]
        if isinstance(x, torch.Tensor):
            return torch.from_numpy(m).to(x.device)
        return m

    @staticmethod
    def _f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float32)
        return np.asarray(x, np.float32)

    def pre_process(self, ds):
        x = self._f32(ds.features)
        if x.ndim != 4:
            raise ValueError(
                f"VGG16ImagePreProcessor expects 4-D image batches, got "
                f"shape {tuple(x.shape)}")
        if x.shape[-1] == 3:                      # NHWC
            ds.features = x - self._mean(x, True)
        elif x.shape[1] == 3:                     # NCHW
            ds.features = x - self._mean(x, False)
        else:
            raise ValueError(
                f"no 3-channel axis in image batch of shape {tuple(x.shape)}")
        return ds

    def revert(self, ds):
        x = self._f32(ds.features)
        ds.features = x + self._mean(x, x.shape[-1] == 3)
        return ds

    def _state(self):
        return {}


class TrainedModels:
    """The pretrained models the helper knows (TrainedModels.java's
    enum)."""

    VGG16 = "vgg16"
    VGG16_NOTOP = "vgg16notop"

    _SPECS = {
        "vgg16": {
            "h5_file": "vgg16_weights_th_dim_ordering_th_kernels.h5",
            "input_shape": (1, 224, 224, 3),
            "output_shape": (1, 1000),
        },
        "vgg16notop": {
            "h5_file": "vgg16_weights_th_dim_ordering_th_kernels_notop.h5",
            "input_shape": (1, 224, 224, 3),
            "output_shape": (1, 7, 7, 512),
        },
    }

    @classmethod
    def spec(cls, model):
        key = str(model).lower()
        if key not in cls._SPECS:
            raise ValueError(
                f"unknown trained model {model!r}; supported: "
                f"{sorted(cls._SPECS)}")
        return cls._SPECS[key]

    @classmethod
    def get_pre_processor(cls, model):
        cls.spec(model)
        return VGG16ImagePreProcessor()

    @classmethod
    def get_input_shape(cls, model):
        return cls.spec(model)["input_shape"]

    @classmethod
    def get_output_shape(cls, model):
        return cls.spec(model)["output_shape"]

    @staticmethod
    def decode_predictions(predictions, top=5):
        return decode_predictions(predictions, top=top)

    @staticmethod
    def format_predictions(predictions, top=5):
        return format_predictions(predictions, top=top)


class TrainedModelHelper:
    """Find and load a pretrained model's local weights
    (TrainedModelHelper.java): an explicit ``set_path_to_h5()`` path, else
    ``<DL4J_TORCH_MODEL_CACHE>/<model>/<file>``."""

    def __init__(self, model=TrainedModels.VGG16):
        self.model = str(model).lower()
        self.spec = TrainedModels.spec(self.model)
        cache_root = os.path.expanduser(env_str("DL4J_TORCH_MODEL_CACHE"))
        self.model_dir = os.path.join(cache_root, self.model)
        self._h5_path = None

    def set_path_to_h5(self, path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no weights file at {path}")
        self._h5_path = str(path)
        return self

    def _resolve_h5(self):
        if self._h5_path:
            return self._h5_path
        cached = os.path.join(self.model_dir, self.spec["h5_file"])
        if os.path.isfile(cached):
            return cached
        raise FileNotFoundError(
            f"weights for {self.model!r} not found. Either call "
            f"set_path_to_h5(<path>) or place {self.spec['h5_file']} at "
            f"{cached} (the cache root is DL4J_TORCH_MODEL_CACHE); this "
            f"package does not download")

    def load_model(self, device=None):
        """Import the weights file into a network on ``device`` (the card
        unless the caller asks for the CPU): a ComputationGraph for a
        functional file, a MultiLayerNetwork for a Sequential one."""
        from deeplearning4j_tpu_torch.modelimport.keras import (
            import_keras_model_and_weights)
        return import_keras_model_and_weights(self._resolve_h5(),
                                              device=device)
