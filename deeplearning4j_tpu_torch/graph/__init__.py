"""Graph embeddings: an in-memory graph, random-walk iterators and
DeepWalk, the port of ``deeplearning4j_tpu/graph/`` (the capability
surface of ``deeplearning4j-graph``)."""

from deeplearning4j_tpu_torch.graph.graph import (  # noqa: F401
    Edge, Graph, GraphLoader, Vertex)
from deeplearning4j_tpu_torch.graph.walkers import (  # noqa: F401
    EXCEPTION_ON_DISCONNECTED, RandomWalkIterator, SELF_LOOP_ON_DISCONNECTED,
    WeightedRandomWalkIterator)
from deeplearning4j_tpu_torch.graph.deepwalk import (  # noqa: F401
    DeepWalk, GraphVectorSerializer)
