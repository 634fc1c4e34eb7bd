"""GCE GPU-VM cluster provisioning (``deeplearning4j-aws`` role): the
port of ``deeplearning4j_tpu/provisioning/cluster.py``.

Each class mirrors one reference component and separates PLAN (pure
command construction: unit-testable, no cloud access) from EXECUTION
(subprocess into ``gcloud``/``gsutil``):

- :class:`GpuVmCreator`      <-> ``aws/ec2/Ec2BoxCreator.java``; the
  counterpart of the reference's ``TpuVmCreator``: GCE VMs with NVIDIA
  GPUs (``gcloud compute instances create/delete``) in place of TPU VMs
- :class:`HostProvisioner`   <-> ``ec2/provision/HostProvisioner.java``
  (``gcloud compute scp/ssh`` in place of ``tpus tpu-vm scp/ssh``)
- :class:`ClusterSetup`      <-> ``ec2/provision/ClusterSetup.java`` +
  ``DistributedDeepLearningTrainer.java`` (create, provision, then launch
  the coordinator on host 0 and one worker process a host, wired to
  ``deeplearning4j_tpu_torch.parallel.worker``)
- :class:`DatasetTransfer`   <-> ``s3/{reader,uploader}``

As in the reference, a host runs one worker process; that process uses
the host's first card (the worker's default device).
"""

from __future__ import annotations

import shlex
import subprocess
from typing import List, Optional, Sequence

__all__ = ["GpuVmCreator", "HostProvisioner", "ClusterSetup",
           "DatasetTransfer"]


def _run(cmd: Sequence[str], dry_run: bool, runner=None):
    if dry_run:
        return " ".join(shlex.quote(c) for c in cmd)
    runner = runner or (lambda c: subprocess.run(
        c, check=True, capture_output=True, text=True))
    return runner(list(cmd))


class GpuVmCreator:
    """Create/delete GCE VMs with NVIDIA GPUs (Ec2BoxCreator role:
    region/AMI/size -> zone/machine type/image). The default machine type
    ``a3-highgpu-1g`` carries one H100; ``image_family`` and
    ``image_project`` name a boot image with the CUDA driver (the
    counterpart of the reference's ``runtime_version``)."""

    def __init__(self, project: str, zone: str = "us-central1-a",
                 machine_type: str = "a3-highgpu-1g",
                 image_family: str = "common-cu124-debian-11",
                 image_project: str = "deeplearning-platform-release",
                 dry_run: bool = False, runner=None):
        self.project = project
        self.zone = zone
        self.machine_type = machine_type
        self.image_family = image_family
        self.image_project = image_project
        self.dry_run = dry_run
        self._runner = runner

    def create_command(self, name: str) -> List[str]:
        # GPU VMs cannot live-migrate: maintenance must terminate them;
        # the CUDA image does not fit the default 10 GB boot disk
        return ["gcloud", "compute", "instances", "create", name,
                f"--project={self.project}", f"--zone={self.zone}",
                f"--machine-type={self.machine_type}",
                f"--image-family={self.image_family}",
                f"--image-project={self.image_project}",
                "--boot-disk-size=200GB", "--maintenance-policy=TERMINATE"]

    def delete_command(self, name: str) -> List[str]:
        return ["gcloud", "compute", "instances", "delete", name,
                f"--project={self.project}", f"--zone={self.zone}",
                "--quiet"]

    def create(self, name: str):
        return _run(self.create_command(name), self.dry_run, self._runner)

    def delete(self, name: str):
        return _run(self.delete_command(name), self.dry_run, self._runner)


class HostProvisioner:
    """Push files to and run commands on one VM over ``gcloud compute
    scp/ssh`` (HostProvisioner.java: uploadAndRun/runRemoteCommand
    roles). A GCE VM is one host, so there is no ``--worker`` to pick."""

    def __init__(self, creator: GpuVmCreator, host: str):
        self.c = creator
        self.host = host

    def scp_command(self, local: str, remote: str) -> List[str]:
        return ["gcloud", "compute", "scp", local, f"{self.host}:{remote}",
                f"--project={self.c.project}", f"--zone={self.c.zone}"]

    def ssh_command(self, command: str) -> List[str]:
        return ["gcloud", "compute", "ssh", self.host,
                f"--project={self.c.project}", f"--zone={self.c.zone}",
                f"--command={command}"]

    def upload(self, local: str, remote: str):
        return _run(self.scp_command(local, remote), self.c.dry_run,
                    self.c._runner)

    def run(self, command: str):
        return _run(self.ssh_command(command), self.c.dry_run,
                    self.c._runner)


class ClusterSetup:
    """End to end: create hosts, provision the repo, launch the
    coordinator on host 0 and one worker process a host
    (ClusterSetup.java + DistributedDeepLearningTrainer.java roles)."""

    def __init__(self, creator: GpuVmCreator, n_hosts: int = 1,
                 name_prefix: str = "dl4j-gpu", coordinator_port: int = 7077):
        self.creator = creator
        self.n_hosts = n_hosts
        self.name_prefix = name_prefix
        self.coordinator_port = coordinator_port

    def host_names(self) -> List[str]:
        return [f"{self.name_prefix}-{i}" for i in range(self.n_hosts)]

    def plan(self, repo_tarball: str, data_dir: str,
             coordinator_host: Optional[str] = None) -> List[List[str]]:
        """The full ordered command plan (inspectable before execution:
        what ClusterSetup's main() runs)."""
        cmds: List[List[str]] = []
        hosts = self.host_names()
        coord = coordinator_host or hosts[0]
        for h in hosts:
            cmds.append(self.creator.create_command(h))
        for h in hosts:
            prov = HostProvisioner(self.creator, h)
            cmds.append(prov.scp_command(repo_tarball, "~/dl4j_tpu.tar.gz"))
            cmds.append(prov.ssh_command(
                "tar xzf ~/dl4j_tpu.tar.gz -C ~/ && "
                "python3 -m pip install -q -e ~/repo || true"))
        # coordinator on host 0 (the Spark-driver role), then workers
        prov0 = HostProvisioner(self.creator, coord)
        cmds.append(prov0.ssh_command(
            f"nohup python3 -m "
            f"deeplearning4j_tpu_torch.parallel.coordinator_main "
            f"--port {self.coordinator_port} --n-workers {self.n_hosts} "
            f">/tmp/coordinator.log 2>&1 &"))
        for i, h in enumerate(hosts):
            prov = HostProvisioner(self.creator, h)
            cmds.append(prov.ssh_command(
                f"nohup python3 -m deeplearning4j_tpu_torch.parallel.worker "
                f"--host {coord} --port {self.coordinator_port} "
                f"--worker-id {i} --data-dir {data_dir}/worker_{i} "
                f">/tmp/worker_{i}.log 2>&1 &"))
        return cmds

    def execute(self, repo_tarball: str, data_dir: str):
        out = []
        for cmd in self.plan(repo_tarball, data_dir):
            out.append(_run(cmd, self.creator.dry_run, self.creator._runner))
        return out

    def teardown(self):
        return [_run(self.creator.delete_command(h), self.creator.dry_run,
                     self.creator._runner) for h in self.host_names()]


class DatasetTransfer:
    """GCS dataset up/download (s3/reader + s3/uploader roles)."""

    def __init__(self, bucket: str, dry_run: bool = False, runner=None):
        self.bucket = bucket.rstrip("/")
        self.dry_run = dry_run
        self._runner = runner

    def upload_command(self, local: str, remote_key: str) -> List[str]:
        return ["gsutil", "-m", "cp", "-r", local,
                f"{self.bucket}/{remote_key}"]

    def download_command(self, remote_key: str, local: str) -> List[str]:
        return ["gsutil", "-m", "cp", "-r",
                f"{self.bucket}/{remote_key}", local]

    def upload(self, local: str, remote_key: str):
        return _run(self.upload_command(local, remote_key), self.dry_run,
                    self._runner)

    def download(self, remote_key: str, local: str):
        return _run(self.download_command(remote_key, local), self.dry_run,
                    self._runner)
