"""Model import of the port: Keras HDF5 files into MultiLayerNetwork and
ComputationGraph, the Keras-frontend RPC server, and the pretrained-model
helper (local weights files only)."""

from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError, KerasModelImport, import_keras_model_and_weights,
    import_keras_sequential_model_and_weights)
from deeplearning4j_tpu_torch.modelimport.trained_models import (
    ImageNetLabels, TrainedModelHelper, TrainedModels, VGG16ImagePreProcessor,
    decode_predictions, format_predictions)

__all__ = ["ImageNetLabels", "KerasImportError", "KerasModelImport",
           "TrainedModelHelper", "TrainedModels", "VGG16ImagePreProcessor",
           "decode_predictions", "format_predictions",
           "import_keras_model_and_weights",
           "import_keras_sequential_model_and_weights"]
