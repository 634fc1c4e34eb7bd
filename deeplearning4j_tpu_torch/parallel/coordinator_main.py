"""Standalone coordinator process: the port of
``deeplearning4j_tpu/parallel/coordinator_main.py``.

The multi-host shape (the Spark driver's and Aeron media driver's part):
one host runs this, and every worker host runs
``deeplearning4j_tpu_torch.parallel.worker`` pointed at it. It serves
until interrupted (Ctrl-C)::

    python -m deeplearning4j_tpu_torch.parallel.coordinator_main \\
        --port 7077 --n-workers 4

``--no-native`` forces the pure-Python coordinator; otherwise the native
one serves when its library builds and loads. The first line printed
names the port and which implementation serves.
"""

from __future__ import annotations

import argparse
import threading

from deeplearning4j_tpu_torch.parallel.coordinator import start_coordinator


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=7077)
    parser.add_argument("--n-workers", type=int, required=True)
    parser.add_argument("--no-native", action="store_true",
                        help="force the pure-Python coordinator")
    args = parser.parse_args(argv)
    coord = start_coordinator(args.n_workers, args.port,
                              prefer_native=not args.no_native)
    print(f"coordinator listening on port {coord.port} "
          f"({args.n_workers} workers, {coord.kind})", flush=True)
    try:
        # serving until Ctrl-C is this command's contract
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        coord.stop()


if __name__ == "__main__":
    main()
