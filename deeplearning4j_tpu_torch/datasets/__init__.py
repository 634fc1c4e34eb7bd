"""Data contracts of the port: DataSet, MultiDataSet and their
iterators."""

from deeplearning4j_tpu_torch.datasets.dataset import (
    ArrayDataSetIterator, ArrayMultiDataSetIterator, DataSet,
    DataSetIterator, ListDataSetIterator, MultiDataSet, MultiDataSetIterator,
    StackedDataSet, StackedMultiDataSet)

__all__ = ["ArrayDataSetIterator", "ArrayMultiDataSetIterator", "DataSet",
           "DataSetIterator", "ListDataSetIterator", "MultiDataSet",
           "MultiDataSetIterator", "StackedDataSet",
           "StackedMultiDataSet"]
