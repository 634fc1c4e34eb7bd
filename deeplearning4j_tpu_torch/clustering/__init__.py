"""Clustering: the port of ``deeplearning4j_tpu/clustering/`` (k-means and
the cluster framework; the KD, VP, quad and sp trees)."""

from deeplearning4j_tpu_torch.clustering.kmeans import (Cluster, ClusterSet,
                                                        KMeansClustering,
                                                        Point)
from deeplearning4j_tpu_torch.clustering.trees import (KDTree, QuadTree,
                                                       SpTree, VPTree)

__all__ = ["Cluster", "ClusterSet", "KDTree", "KMeansClustering", "Point",
           "QuadTree", "SpTree", "VPTree"]
