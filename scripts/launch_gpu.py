#!/usr/bin/env python
"""GPU fleet launcher + controller for the PyTorch port (deep_neuroevolution_torch).

The counterpart of scripts/launch_tpu.py on Compute Engine GPU machines (A3:
eight H100 cards a host) instead of TPU VMs, after the reference's AWS
machinery (scripts/launch.py: package the tree, boot the machines, start
the program on each, launch.py:18-57, 85-141, 213-290; scripts/ec2ctl:
jobs / ssh / tail / resize / kill).

A fleet is ``--num_hosts`` instances named ``NAME-0`` … ``NAME-{N-1}``.
Every host runs the same program, scripts/pod_run_torch.sh, which execs
``torchrun`` with the host's node rank and host 0 as the rendezvous
(``MASTER_ADDR``), one rank per card (parallel/: a rank takes
``cuda:LOCAL_RANK``, NCCL between ranks).

Verbs:
  up      create the instances (+ --spot)     (launch.py:213-235)
  push    tar + scp the repo to every host     (launch.py:18-57 tar→S3→boot fetch)
  start   nohup pod_run_torch.sh on every host (launch.py make_master/worker_script)
  jobs    list instances + state               (ec2ctl jobs)
  ssh     shell on one host                    (ec2ctl ssh)
  tail    follow the training log on host 0    (ec2ctl tail)
  kill    stop training via the recorded pidfile (ec2ctl kill)
  resize  delete + recreate at a new host count (ec2ctl resize; training
          resumes from the latest snapshot in --log_dir, utils/checkpoint.py)
  down    delete the instances

``--dry_run`` prints every gcloud/shell command instead of running it; it is
also the unit-test surface (tests/test_torch_launch.py).
"""

from __future__ import annotations

import argparse
import posixpath
import shlex
import subprocess
import sys
from typing import List

REMOTE_DIR = "~/deep_neuroevolution_torch_run"
PIDFILE = f"{REMOTE_DIR}/train.pid"
LOGFILE = f"{REMOTE_DIR}/train.out"
MASTER_PORT = 29500


def _gcloud(args) -> List[str]:
    return ["gcloud", "compute"] + args


class Runner:
    def __init__(self, dry_run: bool):
        self.dry_run = dry_run
        self.commands: List[List[str]] = []  # recorded for tests

    def run(self, cmd: List[str], **kw) -> int:
        self.commands.append(cmd)
        print("+ " + " ".join(shlex.quote(c) for c in cmd))
        if self.dry_run:
            return 0
        return subprocess.call(cmd, **kw)


def _zone_args(a) -> List[str]:
    return ["--zone", a.zone]


def hosts(a) -> List[str]:
    return [f"{a.name}-{i}" for i in range(a.num_hosts)]


def _ssh(a, runner: Runner, host: str, remote_cmd: str) -> int:
    return runner.run(_gcloud(["ssh", host, *_zone_args(a), "--command", remote_cmd]))


def _ssh_all(a, runner: Runner, remote_cmd) -> int:
    """``remote_cmd`` (a string, or a function of the host's index) on
    every host in turn; stops at the first failure."""
    for i, host in enumerate(hosts(a)):
        rc = _ssh(a, runner, host, remote_cmd(i) if callable(remote_cmd) else remote_cmd)
        if rc:
            return rc
    return 0


def cmd_up(a, runner: Runner) -> int:
    create = _gcloud([
        "instances", "create", *hosts(a), *_zone_args(a),
        "--machine-type", a.machine_type,
        "--accelerator", f"count={a.gpus_per_host},type={a.accelerator_type}",
        "--maintenance-policy", "TERMINATE",
        "--image-family", a.image_family, "--image-project", a.image_project,
        "--boot-disk-size", a.boot_disk_size,
    ])
    if a.spot:
        create += ["--provisioning-model", "SPOT", "--instance-termination-action", "DELETE"]
    rc = runner.run(create)
    if rc:
        return rc
    rc = cmd_push(a, runner)
    if rc:
        return rc
    return cmd_start(a, runner)


def cmd_push(a, runner: Runner) -> int:
    # tar locally, scp to every host, unpack: the S3-less equivalent of
    # launch.py:18-57's upload_archive
    tarball = "/tmp/nevo_torch_push.tar.gz"
    rc = runner.run([
        "tar", "--exclude=.git", "--exclude=logs", "--exclude=__pycache__", "--exclude=results",
        "--exclude=deep_neuroevolution_torch/_build", "-czf", tarball, "-C", a.repo, ".",
    ])
    if rc:
        return rc
    rc = _ssh_all(a, runner, f"mkdir -p {REMOTE_DIR}")
    if rc:
        return rc
    for host in hosts(a):
        rc = runner.run(_gcloud(["scp", tarball, f"{host}:{REMOTE_DIR}/", *_zone_args(a)]))
        if rc:
            return rc
    return _ssh_all(a, runner, f"cd {REMOTE_DIR} && tar -xzf {tarball.split('/')[-1]}")


def cmd_start(a, runner: Runner) -> int:
    # every host runs the same program; torchrun meets on host 0
    def train(rank: int) -> str:
        env = (f"NNODES={a.num_hosts} NODE_RANK={rank} MASTER_ADDR={hosts(a)[0]} MASTER_PORT={MASTER_PORT} "
               f"NPROC_PER_NODE={a.gpus_per_host}")
        return (
            f"cd {REMOTE_DIR} && {env} "
            f"nohup ./scripts/pod_run_torch.sh {shlex.quote(a.algo)} {shlex.quote(a.exp_file)} "
            f"{shlex.quote(a.log_dir)} > {LOGFILE} 2>&1 & echo $! > {PIDFILE}"
        )

    return _ssh_all(a, runner, train)


def cmd_jobs(a, runner: Runner) -> int:
    return runner.run(_gcloud(["instances", "list", "--zones", a.zone]))


def cmd_ssh(a, runner: Runner) -> int:
    return runner.run(_gcloud(["ssh", f"{a.name}-{a.worker}", *_zone_args(a)]))


def cmd_tail(a, runner: Runner) -> int:
    return _ssh(a, runner, f"{a.name}-0", f"tail -n {a.lines} -f {posixpath.join(REMOTE_DIR, a.log_dir, 'log.txt')}")


def cmd_kill(a, runner: Runner) -> int:
    # exact-pid kill via the pidfile recorded at start, never by pattern
    return _ssh_all(a, runner, f"test -f {PIDFILE} && kill $(cat {PIDFILE}) || true")


def cmd_down(a, runner: Runner) -> int:
    return runner.run(_gcloud(["instances", "delete", *hosts(a), *_zone_args(a), "--quiet"]))


def cmd_resize(a, runner: Runner) -> int:
    old = argparse.Namespace(**{**vars(a), "num_hosts": a.old_num_hosts})
    rc = cmd_down(old, runner)
    if rc:
        return rc
    return cmd_up(a, runner)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dry_run", action="store_true")
    sub = p.add_subparsers(dest="verb", required=True)

    def common(sp, name=True):
        if name:
            sp.add_argument("name", help="fleet name (instances NAME-0 … NAME-{N-1})")
            sp.add_argument("--num_hosts", type=int, default=1)
        sp.add_argument("--zone", default="us-central1-a")

    def traincfg(sp):
        sp.add_argument("--algo", default="es")
        sp.add_argument("--exp_file", default="configurations/frostbite_es.json")
        sp.add_argument("--log_dir", default="logs/run")
        sp.add_argument("--repo", default=".")
        sp.add_argument("--gpus_per_host", type=int, default=8)

    def machine(sp):
        sp.add_argument("--machine-type", default="a3-highgpu-8g")
        sp.add_argument("--accelerator-type", default="nvidia-h100-80gb")
        sp.add_argument("--image-family", default="common-cu124")
        sp.add_argument("--image-project", default="deeplearning-platform-release")
        sp.add_argument("--boot-disk-size", default="200GB")
        sp.add_argument("--spot", action="store_true")

    up = sub.add_parser("up")
    common(up)
    traincfg(up)
    machine(up)

    push = sub.add_parser("push")
    common(push)
    traincfg(push)

    start = sub.add_parser("start")
    common(start)
    traincfg(start)

    jobs = sub.add_parser("jobs")
    common(jobs, name=False)

    ssh = sub.add_parser("ssh")
    common(ssh)
    ssh.add_argument("--worker", default="0")

    tail = sub.add_parser("tail")
    common(tail)
    tail.add_argument("--log_dir", default="logs/run")
    tail.add_argument("--lines", type=int, default=50)

    kill = sub.add_parser("kill")
    common(kill)

    down = sub.add_parser("down")
    common(down)

    resize = sub.add_parser("resize")
    common(resize)
    traincfg(resize)
    machine(resize)
    resize.add_argument("--old_num_hosts", type=int, default=1, help="the fleet's host count before the resize")

    return p


VERBS = {
    "up": cmd_up,
    "push": cmd_push,
    "start": cmd_start,
    "jobs": cmd_jobs,
    "ssh": cmd_ssh,
    "tail": cmd_tail,
    "kill": cmd_kill,
    "down": cmd_down,
    "resize": cmd_resize,
}


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    runner = Runner(a.dry_run)
    return VERBS[a.verb](a, runner)


if __name__ == "__main__":
    sys.exit(main())
