"""Observability: training-stats collection, storage and the web UI: the
port of ``deeplearning4j_tpu/ui`` (``deeplearning4j-ui-parent``).

StatsListener → binary-encoded reports → StatsStorage (in memory, a file
or SQLite) → the HTTP UI server, with a remote router for workers on
other hosts; the report components (``ui/components.py``); the
convolutional activation listener (``ui/conv_listener.py``).
"""

from deeplearning4j_tpu_torch.ui.stats import (  # noqa: F401
    StatsListener, StatsUpdateConfiguration)
from deeplearning4j_tpu_torch.ui.storage import (  # noqa: F401
    FileStatsStorage, InMemoryStatsStorage, StatsStorage, StatsStorageRouter)
from deeplearning4j_tpu_torch.ui.server import (  # noqa: F401
    RemoteUIStatsStorageRouter, UIServer)
