"""Worker process of distributed training: the port of
``deeplearning4j_tpu/parallel/worker.py``.

The process shape of the reference's Spark executor running
``ExecuteWorkerFlatMap``: one OS process a worker (on a cluster, one a
host) that connects to the coordinator, receives the broadcast
configuration, parameters and updater state, streams its Export-mode
data shard from disk, fits, and allreduces the results back.

Its replica runs on ``--device``, the card unless the caller names
another (``--device cpu``); a worker that cannot reach its device raises
and exits non-zero, and the training master raises that failure. When
the loop ends, the worker leaves its kernel launch counts (the
wrappers' counters of this process) in ``<data dir>/kernel_launches.json``.

Usage (started by ParameterAveragingTrainingMaster in mode='process',
or by hand on each host)::

    python -m deeplearning4j_tpu_torch.parallel.worker \\
        --host <coordinator host> --port <port> --worker-id <i> \\
        --data-dir <export dir>/worker_<i> [--device cuda:0]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--worker-id", type=int, required=True)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--device", default=None,
                        help="torch device of the replica (default: the "
                             "card, cuda)")
    parser.add_argument("--no-native", action="store_true",
                        help="force the pure-Python collective client")
    args = parser.parse_args(argv)

    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.parallel.coordinator import connect
    from deeplearning4j_tpu_torch.parallel.training_master import (
        load_dataset, run_worker_loop)

    # refuse an unreachable device before joining: the master's
    # watchdog then sees this process exit instead of a silent peer
    device = resolve_device(args.device)

    def data_source(split_idx, meta):
        d = os.path.join(args.data_dir, f"split_{split_idx}")
        return [load_dataset(p)
                for p in sorted(glob.glob(os.path.join(d, "batch_*.npz")))]

    client = connect(args.host, args.port, args.worker_id,
                     prefer_native=not args.no_native)
    try:
        run_worker_loop(client, data_source, device=device)
    finally:
        client.close()
    with open(os.path.join(args.data_dir, "kernel_launches.json"), "w") as f:
        json.dump(kernel_launches(), f)


def kernel_launches():
    """This process's launches of each CUDA kernel, by the wrappers."""
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
    from deeplearning4j_tpu_torch.ops.lstm_cell import (lstm_cell,
                                                        lstm_sequence)
    return {"flash_attn_fwd": flash_attention.launches,
            "flash_attn_dq": flash_attention.dq_launches,
            "flash_attn_dkv": flash_attention.dkv_launches,
            "lstm_cell_fwd": lstm_sequence.launches,
            "lstm_cell_bwd": lstm_cell.bwd_launches}


if __name__ == "__main__":
    main()
