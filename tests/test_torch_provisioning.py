"""The port's cluster provisioning (``deeplearning4j_tpu_torch/
provisioning``) against the JAX package's.

The reference's ``TestProvisioning`` cases (``tests/test_nlp_intl.py``)
restated for the port: GPU VMs (``gcloud compute instances``) in place
of TPU VMs, and the port's coordinator and worker entry points. The plan
for two hosts is compared item by item with the reference's
``ClusterSetup.plan`` on the same arguments: its length, the order of its
kinds (create, copy, install, coordinator, worker), the hosts each
command names, the port, and the coordinator's and workers' arguments.
"""

import os
import subprocess
import sys

import pytest

from deeplearning4j_tpu_torch.provisioning import (ClusterSetup,
                                                   DatasetTransfer,
                                                   GpuVmCreator,
                                                   HostProvisioner)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_command_plans():
    c = GpuVmCreator("proj", zone="us-east1-d",
                     machine_type="a3-highgpu-1g", dry_run=True)
    create = c.create_command("node-0")
    assert create[:4] == ["gcloud", "compute", "instances", "create"]
    assert "--project=proj" in create and "--zone=us-east1-d" in create
    assert "--machine-type=a3-highgpu-1g" in create

    cs = ClusterSetup(c, n_hosts=2, name_prefix="dl4j")
    plan = cs.plan("/tmp/repo.tar.gz", "/data")
    joined = [" ".join(cmd) for cmd in plan]
    # 2 creates + 2x(scp+install) + coordinator + 2 workers
    assert len(plan) == 2 + 4 + 1 + 2
    assert sum("instances create" in j for j in joined) == 2
    assert sum("coordinator_main" in j for j in joined) == 1
    assert sum("parallel.worker" in j for j in joined) == 2
    assert all("deeplearning4j_tpu_torch.parallel" in j for j in joined
               if "coordinator_main" in j or "parallel.worker" in j)
    # workers point at host 0
    assert all("--host dl4j-0" in j for j in joined
               if "parallel.worker" in j)
    # a dry run returns the quoted command line
    assert c.create("node-0") == " ".join(create)

    dt = DatasetTransfer("gs://bucket", dry_run=True)
    up = dt.upload_command("/local/x", "datasets/x")
    assert up[0] == "gsutil" and up[-1] == "gs://bucket/datasets/x"
    down = dt.download_command("datasets/x", "/local/x")
    assert down[-2:] == ["gs://bucket/datasets/x", "/local/x"]


def _kind(cmd):
    line = " ".join(cmd)
    for kind, mark in (("create", " create "), ("copy", " scp "),
                       ("coordinator", "coordinator_main"),
                       ("worker", "parallel.worker"),
                       ("install", "tar xzf")):
        if mark in line:
            return kind
    raise AssertionError(line)


def _hosts(cmd, names):
    return [n for n in names if any(n == a or a.startswith(n + ":")
                                    or f" {n} " in f" {a} " for a in cmd)]


def _launch_args(cmd):
    """The ``python3 -m <module> <args>`` of a launch, module stripped of
    its package."""
    inner = next(a for a in cmd if a.startswith("--command="))
    words = inner.split()
    mod = words[words.index("-m") + 1]
    args = words[words.index("-m") + 2:words.index(next(
        w for w in words if w.startswith(">")))]
    return mod.split(".", 1)[1], args


def test_plan_matches_the_reference_item_by_item():
    from deeplearning4j_tpu.provisioning import (ClusterSetup as RefSetup,
                                                 TpuVmCreator)
    port = ClusterSetup(GpuVmCreator("proj", dry_run=True), n_hosts=2,
                        name_prefix="dl4j", coordinator_port=7177)
    ref = RefSetup(TpuVmCreator("proj", dry_run=True), n_hosts=2,
                   name_prefix="dl4j", coordinator_port=7177)
    assert port.host_names() == ref.host_names() == ["dl4j-0", "dl4j-1"]
    got = port.plan("/tmp/repo.tar.gz", "/data")
    want = ref.plan("/tmp/repo.tar.gz", "/data")
    assert len(got) == len(want) == 2 + 4 + 1 + 2
    names = port.host_names()
    for g, w in zip(got, want):
        assert _kind(g) == _kind(w), (g, w)
        assert _hosts(g, names) == _hosts(w, names), (g, w)
        if _kind(g) in ("coordinator", "worker"):
            assert _launch_args(g) == _launch_args(w), (g, w)
            assert "--port 7177" in " ".join(g)
        if _kind(g) == "copy":
            assert g[3] == w[5] == "/tmp/repo.tar.gz"
            assert g[4] == w[6]
    assert [_kind(g) for g in got] == ["create", "create", "copy",
                                       "install", "copy", "install",
                                       "coordinator", "worker", "worker"]


def test_execute_records_commands_with_stub_runner():
    ran = []
    c = GpuVmCreator("p", dry_run=False, runner=ran.append)
    c.create("n0")
    c.delete("n0")
    assert len(ran) == 2 and ran[0][3] == "create" and ran[1][3] == "delete"
    assert ran[1][-1] == "--quiet"
    HostProvisioner(c, "n0").run("nvidia-smi")
    assert ran[2][:4] == ["gcloud", "compute", "ssh", "n0"]
    assert ran[2][-1] == "--command=nvidia-smi"
    cs = ClusterSetup(c, n_hosts=2, name_prefix="h")
    cs.execute("/r.tgz", "/d")
    assert ran[3:] == cs.plan("/r.tgz", "/d")
    del ran[:]
    cs.teardown()
    assert [cmd[3:5] for cmd in ran] == [["delete", "h-0"],
                                         ["delete", "h-1"]]


def test_coordinator_main_starts_and_stops():
    p = subprocess.Popen(
        [sys.executable, "-m",
         "deeplearning4j_tpu_torch.parallel.coordinator_main",
         "--port", "0", "--n-workers", "1", "--no-native"],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = p.stdout.readline()
        assert "coordinator listening" in line and "(1 workers" in line
    finally:
        p.terminate()
        p.wait(timeout=10)
        p.stdout.close()
    assert p.returncode is not None


@pytest.mark.parametrize("n_hosts", [1, 3])
def test_plan_shape_scales_with_hosts(n_hosts):
    cs = ClusterSetup(GpuVmCreator("p", dry_run=True), n_hosts=n_hosts)
    plan = cs.plan("/r.tgz", "/d")
    assert len(plan) == n_hosts * 4 + 1
    assert [_kind(c) for c in plan].count("worker") == n_hosts
    workers = [" ".join(c) for c in plan if _kind(c) == "worker"]
    for i, w in enumerate(workers):
        assert f"--worker-id {i} --data-dir /d/worker_{i}" in w
        assert f"--n-workers {n_hosts}" not in w
