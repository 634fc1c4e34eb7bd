"""CLI for data-parallel training of a saved model: the port of
``deeplearning4j_tpu/parallel/parallel_wrapper_main.py``
(``parallelism/main/ParallelWrapperMain.java``): restore a model
archive, fit it with ParallelWrapper, write it back.

One process a rank: run it once for each rank, with ``--world``,
``--rank`` and ``--coordinator host:port`` (rank 0's address), or under
``torchrun``, whose ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` it reads. Each rank trains on its rows of every batch of
the same stream; rank 0 prints and writes the result.

Data sources:
- ``--dataset mnist|iris``: the fetchers;
- ``--dataset <dir>``: a directory of ``batch_*.npz`` files in the
  TrainingMaster export format (``features``, ``labels`` and the masks).

Example (two ranks on one host, the CPU over gloo):
    python -m deeplearning4j_tpu_torch.parallel.parallel_wrapper_main \\
        --model model.zip --output trained.zip --dataset iris \\
        --world 2 --rank 0 --coordinator 127.0.0.1:29500 --device cpu &
    python -m deeplearning4j_tpu_torch.parallel.parallel_wrapper_main \\
        --model model.zip --output trained.zip --dataset iris \\
        --world 2 --rank 1 --coordinator 127.0.0.1:29500 --device cpu
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _data_iterator(spec, batch_size, num_examples):
    if spec == "mnist":
        from deeplearning4j_tpu_torch.datasets.fetchers import \
            MnistDataSetIterator
        return MnistDataSetIterator(batch_size, train=True,
                                    num_examples=num_examples)
    if spec == "iris":
        from deeplearning4j_tpu_torch.datasets.fetchers import \
            IrisDataSetIterator
        return IrisDataSetIterator(batch_size)
    if os.path.isdir(spec):
        from deeplearning4j_tpu_torch.datasets.dataset import (
            ListDataSetIterator, MultiDataSet)
        from deeplearning4j_tpu_torch.parallel.training_master import \
            load_dataset
        paths = sorted(glob.glob(os.path.join(spec, "batch_*.npz")))
        if not paths:
            raise SystemExit(f"no batch_*.npz files under {spec}")
        batches = [load_dataset(p) for p in paths]
        if any(isinstance(b, MultiDataSet) for b in batches):
            raise SystemExit(
                f"--dataset {spec!r} contains MultiDataSet batches "
                "(multi-input graphs); this CLI trains MultiLayerNetwork on "
                "single-input DataSets")
        return ListDataSetIterator(batches)
    raise SystemExit(f"unknown --dataset {spec!r} (mnist|iris|<export dir>)")


def _world(args):
    """(world, rank, coordinator) from the flags, else torchrun's env."""
    env = os.environ
    world = args.world or int(env.get("WORLD_SIZE", 0) or 0) \
        or args.workers or 1
    if args.workers and args.workers != world:
        raise SystemExit(f"--workers {args.workers} but the job has {world} "
                         "ranks (one process a rank)")
    rank = args.rank if args.rank is not None \
        else int(env.get("RANK", 0) or 0)
    coord = args.coordinator
    if coord is None and env.get("MASTER_ADDR"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if world > 1 and coord is None:
        raise SystemExit("a job of more than one rank needs --coordinator "
                         "host:port (or torchrun's MASTER_ADDR/MASTER_PORT)")
    return world, rank, coord


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Data-parallel training of a saved model "
                    "(ParallelWrapperMain role), one process a rank")
    ap.add_argument("--model", required=True, help="input model archive")
    ap.add_argument("--output", required=True, help="where to save the result")
    ap.add_argument("--dataset", required=True,
                    help="mnist | iris | directory of batch_*.npz exports")
    ap.add_argument("--workers", type=int, default=0,
                    help="data-parallel width; must equal the job's ranks "
                         "(0 = all of them)")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks in the job (default: WORLD_SIZE, else 1)")
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (default: RANK, else 0)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (default: MASTER_ADDR:"
                         "MASTER_PORT)")
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the CPU over gloo; default the "
                         "card (cuda:local_rank, NCCL)")
    ap.add_argument("--dp-shard", type=int, default=None,
                    help="ZeRO level 0-3 (default DL4J_TORCH_DP_SHARD)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-examples", type=int, default=60_000)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--averaging-frequency", type=int, default=1)
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_model, write_model)

    world, rank, coord = _world(args)
    if world > 1:
        dev = multihost.initialize(coord, world, rank, device=args.device)
    else:
        dev = multihost.rank_device(args.device, rank)
    try:
        net = restore_model(args.model, device=dev)
        if hasattr(net, "params_map"):   # a ComputationGraph archive
            raise SystemExit(
                "this CLI drives ParallelWrapper, which trains "
                "MultiLayerNetwork archives")
        wrapper = ParallelWrapper(
            net, averaging_frequency=args.averaging_frequency,
            dp_shard=args.dp_shard, device=dev)
        data = _data_iterator(args.dataset, args.batch_size,
                              args.num_examples)
        # pre-flight: a model whose input shape does not match the data
        # must fail with a message, not deep inside a step; the probe
        # consumes batch 1 and replays it through reset()
        if not callable(getattr(data, "reset", None)):
            raise SystemExit(
                "dataset iterator has no reset(); the pre-flight probe "
                "needs a resettable iterator")
        first = next(iter(data))
        if isinstance(first, MultiDataSet):
            raise SystemExit(
                f"--dataset {args.dataset!r} contains MultiDataSet batches "
                "(multi-input graphs); this CLI trains MultiLayerNetwork on "
                "single-input DataSets")
        probe = np.zeros_like(np.asarray(first.features)[:1])
        try:
            net.output(probe)
        except Exception as e:
            raise SystemExit(
                f"model/input mismatch: --dataset {args.dataset!r} yields "
                f"features of shape {probe.shape[1:]}, which the model "
                f"rejects: {e}") from e
        data.reset()
        for epoch in range(args.epochs):
            wrapper.fit(data)
            score = float(net.score_)
            if rank == 0:
                print(f"epoch {epoch}: score={score:.4f}")
        write_model(net, args.output)   # every rank gathers, rank 0 writes
        if rank == 0:
            print(f"saved -> {args.output}")
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
