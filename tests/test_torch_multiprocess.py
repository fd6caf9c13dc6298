"""Two real gloo ranks of the port's pods against their two-rank emulation.

The worker (tests/torch_pod_cases.py) runs as two processes joined through
a ``file://`` store under ``tmp_path``: every pod case of the cases file
(host-pod ES, GA, RS and NS-ES; device-pod ES in fixed-population and
quota mode, GA and NS-ES), then ``main train`` twice, the second run
resuming the first's trainer snapshot. Held here:

* every rank's returns, lengths, BCs, novelty, θ (and the GA's population,
  elite and parents) equal the same case's two-rank emulation in one
  process, bit for bit, and every rank ends with the same θ (the contract's
  first and third properties, parallel/__init__.py);
* only rank 0 writes the log directory (rank 1's own directory is never
  made; one tabular line a generation);
* the pod's snapshot loads back in the single trainer, whose next
  generation equals the pod's bit for bit (host pods update alike);
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  deep_neuroevolution_torch.main train`` on the CPU: the env:// world and
  the loader's ``pod: "auto"`` dispatch, both ranks ending with the θ of
  rank 0's snapshot, only rank 0 writing;
* ``dryrun_multichip(2, "cpu")``: a device-pod ES generation over two
  spawned gloo ranks.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_pod_cases as cases  # noqa: E402

from deep_neuroevolution_torch.utils import checkpoint, tabular  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results and their output directory."""
    out = tmp_path_factory.mktemp("pod_ranks")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, cases.__file__, str(r), "2", str(out / "store"), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-4000:] for log in logs)
    res = []
    for r in (0, 1):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, out


def _equal(a, b, what):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=what)
    elif isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif a is None or isinstance(a, (int, float, tuple, list, str)):
        assert b == a, what
    else:
        raise TypeError(type(a))


@pytest.mark.parametrize("name", list(cases.CASES))
def test_real_ranks_equal_the_emulation(ranks, name, monkeypatch):
    res, _ = ranks
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    emu = cases.build(name, emulate=True)
    try:
        runs = cases.run(emu, cases.CASES[name][3])
    finally:
        emu.close()
    assert res[0][name]["type"] == res[1][name]["type"] == type(emu).__name__
    for r in (0, 1):
        for g, (want, got) in enumerate(zip(runs, res[r][name]["runs"])):
            _equal(want, got, f"{name} rank {r} generation {g}")
    assert res[1][name]["calls"] > 0 and res[1][name]["seconds"] > 0  # the collectives crossed processes


def test_only_rank0_writes(ranks):
    _, out = ranks
    assert not (out / "cli_logs_rank1").exists()
    logs = out / "cli_logs"
    with open(logs / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2  # one generation a run, one writer
    assert sorted(p.name for p in logs.glob("snapshot_iter*.pkl")) == ["snapshot_iter00001_rew0.pkl",
                                                                       "snapshot_iter00002_rew0.pkl"]


def test_pod_snapshot_resumes_in_the_single_trainer(ranks, monkeypatch):
    """The host pod's snapshot after generation 1 into the single trainer:
    its generation 2 equals the pod's (the resumed two-rank run) bit for
    bit, and both ranks ended with that θ."""
    res, out = ranks
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    single = cases.build("host_es", single=True)
    try:
        checkpoint.load_trainer(str(out / "snapshot_gen1.pkl"), single)
        single.train_step()
    finally:
        single.close()
    assert single.iteration == 2
    for r in (0, 1):
        np.testing.assert_array_equal(res[r]["cli_1"], single.theta.numpy())
    np.testing.assert_array_equal(res[0]["cli_0"], res[1]["cli_0"])


def test_torchrun_main_train(tmp_path, monkeypatch):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    deep_neuroevolution_torch.main train`` on the CPU: the env:// world,
    the loader's ``pod: "auto"`` dispatch in a world of two (a maze ES
    pod), both ranks ending with the θ of rank 0's snapshot, and only rank
    0 writing the log directory."""
    import hashlib
    import re

    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    logs = tmp_path / "logs"
    exp, _, overrides, _ = cases.CASES["device_es"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "deep_neuroevolution_torch.main", "train", "--device", "cpu", "--exp_file",
                           str(cases.ROOT / "configurations" / exp), "--iterations", "2", "--snapshot_freq", "1",
                           "--log_dir", str(logs), "--overrides", json.dumps(overrides)],
                          cwd=cases.ROOT, env={**env, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=300)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, out[-4000:]
    digests = dict(re.findall(r"rank (\d) of 2: PodESTrainer θ sha256 ([0-9a-f]{64})", out))
    assert sorted(digests) == ["0", "1"], out[-4000:]
    single = cases.build("device_es", single=True)
    checkpoint.load_trainer(str(logs / "snapshot.pkl"), single)
    assert single.iteration == 2
    assert digests["0"] == digests["1"] == hashlib.sha256(single.theta.numpy().tobytes()).hexdigest()
    with open(logs / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2  # one generation a line, one writer
    assert sorted(p.name for p in logs.glob("snapshot_iter*.pkl")) == ["snapshot_iter00001_rew0.pkl",
                                                                       "snapshot_iter00002_rew0.pkl"]


def test_dryrun_multichip_on_two_gloo_ranks():
    from deep_neuroevolution_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, "cpu")
    assert out["world"] == 2 and out["backend"] == "gloo"
    assert out["returns"].shape == (4, 2) and out["eval_returns"].shape == (2,)
