"""Model import of the port: Keras HDF5 files into MultiLayerNetwork and
ComputationGraph, and the Keras-frontend RPC server."""

from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError, KerasModelImport, import_keras_model_and_weights,
    import_keras_sequential_model_and_weights)

__all__ = ["KerasImportError", "KerasModelImport",
           "import_keras_model_and_weights",
           "import_keras_sequential_model_and_weights"]
