"""Streaming inference and training plumbing: the port of
``deeplearning4j_tpu/streaming`` (the ``dl4j-streaming`` role:
``NDArray{Publisher,Consumer}.java``, ``DL4jServeRouteBuilder.java`` and
``streaming/serde/*``).

The reference rides Kafka and Camel; here, as in the JAX package, a
self-contained TCP topic broker (``broker.MessageBroker``) carries the
same payloads.
"""

from deeplearning4j_tpu_torch.streaming.broker import (MessageBroker,
                                                       TopicConsumer,
                                                       TopicPublisher)
from deeplearning4j_tpu_torch.streaming.routes import (DL4JServeRoute,
                                                       InferenceHTTPServer)
from deeplearning4j_tpu_torch.streaming.serde import (deserialize_array,
                                                      deserialize_dataset,
                                                      serialize_array,
                                                      serialize_dataset)

__all__ = [
    "MessageBroker", "TopicPublisher", "TopicConsumer", "DL4JServeRoute",
    "InferenceHTTPServer", "serialize_array", "deserialize_array",
    "serialize_dataset", "deserialize_dataset",
]
