"""The port's ops tools: the GPU fleet launcher (scripts/launch_gpu.py, its
dry-run command lists, after tests/test_launch_tpu.py), the per-host
program (scripts/pod_run_torch.sh, run against a stand-in ``torchrun``
that prints its arguments) and the image (Dockerfile.torch): none names
JAX or the JAX package, and every module the image runs imports in the
port."""

import importlib
import importlib.util
import os
import re
import stat
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("launch_gpu", ROOT / "scripts" / "launch_gpu.py")
launch_gpu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(launch_gpu)

TOOLS = [ROOT / "scripts" / "launch_gpu.py", ROOT / "scripts" / "pod_run_torch.sh", ROOT / "Dockerfile.torch"]


def _run(argv):
    a = launch_gpu.build_parser().parse_args(argv)
    runner = launch_gpu.Runner(dry_run=True)
    assert launch_gpu.VERBS[a.verb](a, runner) == 0
    return runner.commands


def _remote(cmd):
    assert cmd[:3] == ["gcloud", "compute", "ssh"] and cmd[-2] == "--command"
    return cmd[3], cmd[-1]


def test_every_verb_is_there():
    assert set(launch_gpu.VERBS) == {"up", "push", "start", "jobs", "ssh", "tail", "kill", "resize", "down"}


def test_up_creates_pushes_starts():
    cmds = _run(["up", "frost", "--zone", "z", "--num_hosts", "2", "--spot", "--algo", "ga",
                 "--exp_file", "c.json", "--log_dir", "logs/x"])
    create = cmds[0]
    assert create[:4] == ["gcloud", "compute", "instances", "create"]
    assert create[4:6] == ["frost-0", "frost-1"]
    for flag, value in (("--machine-type", "a3-highgpu-8g"), ("--accelerator", "count=8,type=nvidia-h100-80gb"),
                        ("--maintenance-policy", "TERMINATE"), ("--zone", "z"), ("--provisioning-model", "SPOT")):
        assert create[create.index(flag) + 1] == value
    # push: tar, mkdir on each host, scp to each host, untar on each host
    tar = cmds[1]
    assert tar[0] == "tar" and "--exclude=.git" in tar and tar[-3:] == ["-C", ".", "."]
    scps = [c for c in cmds if c[:3] == ["gcloud", "compute", "scp"]]
    assert [c[4].split(":")[0] for c in scps] == ["frost-0", "frost-1"]
    starts = [_remote(c) for c in cmds[-2:]]
    for rank, (host, remote) in enumerate(starts):
        assert host == f"frost-{rank}"
        assert f"NNODES=2 NODE_RANK={rank} MASTER_ADDR=frost-0 MASTER_PORT=29500 NPROC_PER_NODE=8" in remote
        assert "nohup ./scripts/pod_run_torch.sh ga c.json logs/x" in remote and "train.pid" in remote


def test_start_runs_the_next_file_on_every_host():
    cmds = _run(["start", "frost", "--num_hosts", "3", "--gpus_per_host", "4"])
    assert [_remote(c)[0] for c in cmds] == ["frost-0", "frost-1", "frost-2"]
    assert all("pod_run_torch.sh" in _remote(c)[1] and "NPROC_PER_NODE=4" in _remote(c)[1] for c in cmds)


def test_jobs_ssh_tail():
    (jobs,) = _run(["jobs", "--zone", "z"])
    assert jobs == ["gcloud", "compute", "instances", "list", "--zones", "z"]
    (ssh,) = _run(["ssh", "frost", "--worker", "1"])
    assert ssh[:4] == ["gcloud", "compute", "ssh", "frost-1"]
    (tail,) = _run(["tail", "frost", "--log_dir", "logs/x", "--lines", "7"])
    host, remote = _remote(tail)
    assert host == "frost-0" and remote == "tail -n 7 -f ~/deep_neuroevolution_torch_run/logs/x/log.txt"


def test_kill_uses_exact_pidfile_never_pattern():
    cmds = _run(["kill", "frost", "--num_hosts", "2"])
    assert [_remote(c)[0] for c in cmds] == ["frost-0", "frost-1"]
    for c in cmds:
        remote = _remote(c)[1]
        assert "kill $(cat" in remote and "train.pid" in remote
        assert "pkill" not in remote and "killall" not in remote


def test_resize_is_recreate_and_down_deletes():
    cmds = _run(["resize", "frost", "--old_num_hosts", "1", "--num_hosts", "2"])
    assert cmds[0][:4] == ["gcloud", "compute", "instances", "delete"] and cmds[0][4:5] == ["frost-0"]
    assert cmds[1][:6] == ["gcloud", "compute", "instances", "create", "frost-0", "frost-1"]
    (down,) = _run(["down", "frost", "--num_hosts", "2"])
    assert down[:6] == ["gcloud", "compute", "instances", "delete", "frost-0", "frost-1"] and "--quiet" in down


def _fake_torchrun(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "torchrun"
    fake.write_text('#!/usr/bin/env bash\nprintf "%s\\n" "$@"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return bindir


def test_pod_run_torch_execs_torchrun_on_the_ports_main_train(tmp_path):
    env = {**os.environ, "PATH": f"{_fake_torchrun(tmp_path)}:{os.environ['PATH']}", "NNODES": "2",
           "NODE_RANK": "1", "MASTER_ADDR": "frost-0", "NPROC_PER_NODE": "8"}
    p = subprocess.run(["bash", str(ROOT / "scripts" / "pod_run_torch.sh"), "es", "configurations/maze_es.json"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=60)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[:-1] == [
        "--nnodes", "2", "--node_rank", "1", "--nproc_per_node", "8", "--master_addr", "frost-0",
        "--master_port", "29500", "-m", "deep_neuroevolution_torch.main", "train", "--algo", "es",
        "--exp_file", "configurations/maze_es.json", "--log_dir", "logs/maze_es", "--snapshot_freq", "10",
    ]
    # the arguments it hands the port's CLI parse there
    from deep_neuroevolution_torch import main as tmain

    args = tmain.build_parser().parse_args(p.stdout.split("\n")[-10:-1])
    assert (args.algo, args.exp_file, args.log_dir, args.snapshot_freq) == (
        "es", "configurations/maze_es.json", "logs/maze_es", 10)


@pytest.mark.parametrize("path", TOOLS, ids=lambda p: p.name)
def test_tools_name_no_jax(path):
    text = path.read_text()
    assert not re.search(r"\bjax\b|deep_neuroevolution_tpu", text, re.I), path.name


def test_dockerfile_builds_and_runs_the_port():
    """The image: a CUDA devel base, the port and configurations/ copied,
    the engine and the kernels built by the port's modules, a CMD that
    trains maze_es.json; every module it runs imports here."""
    text = (ROOT / "Dockerfile.torch").read_text()
    assert re.search(r"^FROM nvidia/cuda:[\d.]+-devel-", text, re.M)
    assert "COPY deep_neuroevolution_torch ./deep_neuroevolution_torch" in text
    assert "COPY configurations ./configurations" in text
    assert "_cuda_build.build()" in text and "deep_neuroevolution_torch.native.build" in text
    cmd = re.search(r"^CMD (\[.*\])$", text, re.M).group(1)
    assert '"deep_neuroevolution_torch.main", "train"' in cmd and "configurations/maze_es.json" in cmd
    assert (ROOT / "configurations" / "maze_es.json").exists()
    modules = set(re.findall(r"python3 -m ([\w.]+)", text)) | set(re.findall(r'"-m", "([\w.]+)"', text))
    modules |= {m for m, _ in re.findall(r"from ([\w.]+) import (\w+)", text)}
    assert modules == {"deep_neuroevolution_torch.native.build", "deep_neuroevolution_torch.main",
                       "deep_neuroevolution_torch.ops"}
    for name in modules:
        importlib.import_module(name)
    from deep_neuroevolution_torch.ops import _cuda_build

    assert callable(_cuda_build.build)
