"""Data contracts of the port: DataSet and its iterators."""

from deeplearning4j_tpu_torch.datasets.dataset import (
    ArrayDataSetIterator, DataSet, DataSetIterator, ListDataSetIterator,
    StackedDataSet)

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ListDataSetIterator", "StackedDataSet"]
