"""Embedding visualisation: exact and Barnes-Hut t-SNE (the port of
``deeplearning4j_tpu/plot/``)."""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne

__all__ = ["BarnesHutTsne", "Tsne"]
