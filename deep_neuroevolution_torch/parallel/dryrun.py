"""A pod ES generation over n ranks, as a check that scale-out starts.

The port's counterpart of the JAX package's ``dryrun_multichip``
(__graft_entry__.py:36-175), which runs the pod step on an n-device mesh:
``dryrun_multichip(n)`` starts n processes, one rank each, and runs one
``PodESTrainer`` generation of ``LinearClassifier`` on CartPole (eval
episodes included): gloo ranks on the CPU (``device="cpu"``), or one rank
per card on NCCL (``device="cuda"``, n cards).

    python -m deep_neuroevolution_torch.parallel.dryrun 2 cpu
"""

from __future__ import annotations

import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def _rank(rank: int, n: int, device: str, store: str, out: str) -> None:
    from ..algos.es import ESConfig
    from ..envs import CartPoleEnv
    from ..models import LinearClassifier
    from ..ops import optim
    from ..ops.noise import NoiseTable
    from ..utils import tabular
    from . import distributed
    from .trainers import PodESTrainer

    torch.set_num_threads(1)
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
    distributed.init_multihost(init_method=f"file://{store}", world_size=n, rank=rank, device=dev)
    try:
        tabular.dump_tabular = lambda: tabular._logger._kvs.clear()
        tr = PodESTrainer(CartPoleEnv(), LinearClassifier(obs_dim=4, num_actions=2),
                          ESConfig(population_size=4 * n, noise_stdev=0.2, episode_cutoff_mode=20, num_eval_episodes=2),
                          optimizer=optim.Adam(stepsize=0.1),
                          noise_table=NoiseTable.from_seed(count=50_000, device=dev), device=dev)
        st = tr.train_step()
        thetas = distributed.all_gather_object(tr.theta.cpu().numpy())
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(dict(world=n, backend=distributed.backend(), returns=st.returns, thetas=thetas,
                                 eval_returns=st.eval_returns), f)
    finally:
        distributed.shutdown()


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """One pod ES generation over ``n`` ranks; every rank must end it with
    the same θ. Returns the world size, backend, the generation's returns
    ``[2n, 2]`` and eval returns."""
    import torch.multiprocessing as mp

    if device != "cpu" and torch.cuda.device_count() < n:
        raise RuntimeError(f"one rank per card: {n} ranks need {n} cards, {torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="nevo_dryrun_") as tmp:
        out = str(Path(tmp) / "result.pkl")
        mp.spawn(_rank, args=(n, device, str(Path(tmp) / "store"), out), nprocs=n, join=True)
        with open(out, "rb") as f:
            res = pickle.load(f)
    if not all(np.array_equal(t, res["thetas"][0]) for t in res["thetas"]):
        raise AssertionError("the ranks ended the generation with different θ")
    if res["returns"].shape != (2 * n, 2):
        raise AssertionError(f"returns {res['returns'].shape}, not {(2 * n, 2)}")
    return dict(world=res["world"], backend=res["backend"], returns=res["returns"], eval_returns=res["eval_returns"])


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2, sys.argv[2] if len(sys.argv) > 2 else "cuda"))
