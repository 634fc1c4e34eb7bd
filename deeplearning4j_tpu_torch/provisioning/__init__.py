"""Cluster provisioning (``deeplearning4j-aws`` role) for GPU hosts: the
port of ``deeplearning4j_tpu/provisioning``.

The reference targets TPU VMs; the port creates GCE VMs with NVIDIA GPUs
through the ``gcloud`` CLI, moves datasets with ``gsutil``, provisions
each host over ``gcloud compute ssh/scp`` and launches the port's
coordinator and workers. Command construction (the plan) is pure and
unit-tested in-process; execution shells out to the installed Google
Cloud SDK.
"""

from deeplearning4j_tpu_torch.provisioning.cluster import (ClusterSetup,
                                                           DatasetTransfer,
                                                           GpuVmCreator,
                                                           HostProvisioner)

__all__ = ["GpuVmCreator", "HostProvisioner", "ClusterSetup",
           "DatasetTransfer"]
