"""Parallelism and distribution: the port of
``deeplearning4j_tpu/parallel/``.

- ``ParallelWrapper`` (``data_parallel_mesh``): synchronous data
  parallelism over a ``torch.distributed`` group, with the ZeRO 0-3
  sharding core (``sharding_core.py``) and ``fsdp.py``;
- ``ParameterServerParallelWrapper``: asynchronous data parallelism
  through the embedded parameter server (the Aeron wrapper's part);
- ``ParameterAveragingTrainingMaster`` (``TrainingMaster``) with
  ``DistributedMultiLayerNetwork`` / ``DistributedComputationGraph``:
  cluster-style synchronous parameter averaging with thread or OS-process
  workers (the Spark TrainingMaster's part);
- ``start_coordinator`` / ``connect``: the host-side collective and
  parameter-server transport (the native C++ TCP server or its Python
  twin; the Aeron media driver's and Spark driver's part).
- ``ElasticTrainer`` / ``ElasticMember``: elastic data parallelism, a
  world that loses or gains trainer processes re-forming its process
  group and continuing from the last committed checkpoint;
- ``TensorParallelMLP`` / ``TPTransformerLM`` over ``tp_mesh``: Megatron
  tensor parallelism on a (data, model) grid of ranks;
- ``PipelineParallelNet`` / ``PPTransformerLM`` over ``pp_mesh``: GPipe
  pipelines, stages on a (data, pipe) grid; ``SPTransformerLM``: ring
  sequence parallelism (``sequence_parallel.ring_attention``,
  ``ulysses_attention``); ``ExpertParallelMoE`` / ``EPTransformerLM``
  over ``ep_mesh``: all-to-all expert parallelism.

Names resolve on first use: the modules that the models import from
here (``sharding_core``, ``sequence_parallel``, ``multihost``) must not
pull the trainers in with them.
"""

_EXPORTS = {
    "ParallelWrapper": "parallel_wrapper",
    "data_parallel_mesh": "parallel_wrapper",
    "ParameterServerParallelWrapper": "param_server_wrapper",
    "TrainingMaster": "training_master",
    "ParameterAveragingTrainingMaster": "training_master",
    "DistributedMultiLayerNetwork": "training_master",
    "DistributedComputationGraph": "training_master",
    "TrainingHook": "training_master",
    "connect": "coordinator",
    "start_coordinator": "coordinator",
    "ElasticTrainer": "elastic",
    "ElasticMember": "elastic",
    "TensorParallelMLP": "tensor_parallel",
    "tp_mesh": "tensor_parallel",
    "TPTransformerLM": "tp_transformer",
    "pp_mesh": "pipeline_parallel",
    "PipelineParallelNet": "pipeline_parallel",
    "PPTransformerLM": "pp_transformer",
    "SPTransformerLM": "sp_transformer",
    "ep_mesh": "expert_parallel",
    "ExpertParallelMoE": "expert_parallel",
    "EPTransformerLM": "ep_transformer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
