"""The port's parallel/ package in one process: each pod (its two-rank
emulation, or a world of one) against the single-device trainer, the pod
updates against the JAX package's pod functions on the 8-device CPU mesh,
the host-pod GA ladder's split against the JAX one, the loader's ``pod``
and ``host_pod`` dispatch and refusals, and the ``theta_hbm_budget`` cap of
the host-pod GA's rounds.

Contract (parallel/__init__.py): a pod equals the single trainer whose
rounds are its blocks. Returns, lengths and BCs bit for bit; θ bit for bit
on the host pods (the update is the single trainer's, from the gathered
columns) and within float reordering on the device pods (per-rank partial
gradients added), so a device pod is held to the single trainer for one
generation. NS-ES at two ranks splits an iteration the single trainer runs
as one round, so it is held here at one rank and to its emulation at two
(tests/test_torch_multiprocess.py).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_pod_cases as cases  # noqa: E402

from deep_neuroevolution_torch.envs import CartPoleEnv as TCartPole, MazeEnv as TMaze  # noqa: E402
from deep_neuroevolution_torch.models import ContinuousMLP as TContinuousMLP, LinearClassifier as TLinear  # noqa: E402
from deep_neuroevolution_torch.ops import optim as toptim  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable as TNoiseTable, VirtualNoise  # noqa: E402
from deep_neuroevolution_torch.parallel import distributed, host_pod as thp, trainers as tpt  # noqa: E402
from deep_neuroevolution_torch.utils import checkpoint, config, tabular  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())


# ------------------------------------------------------ pod vs single trainer

# the single trainer whose rounds are the pod's blocks: a device ES pod's
# eval_batch counts pairs a rank (4 of a 16-member population at two ranks),
# the GA's members a rank (8)
SINGLE = {"device_es": {"eval_batch": 4}, "device_es_quota": {"eval_batch": 4}, "device_ga": {"eval_batch": 8}}
# pods held to the single trainer at one rank (see the module docstring)
ONE_RANK = ("host_nses", "device_nses")


def _single(name):
    exp_file, algo, overrides, _ = cases.CASES[name]
    return config.load_experiment(cases.experiment(name), overrides={**overrides, **SINGLE.get(name, {})},
                                  device="cpu", algo=algo)


def _pod(name, ranks):
    if ranks == 2:
        return cases.build(name, emulate=True)
    _, algo, overrides, _ = cases.CASES[name]
    key = "host_pod" if name.startswith("host") else "pod"
    one = {key: 1 if key == "host_pod" else True}
    return config.load_experiment(cases.experiment(name), overrides={**overrides, **one}, device="cpu", algo=algo)


@pytest.mark.parametrize("name", list(cases.CASES))
def test_pod_equals_the_single_trainer(name):
    ranks = 1 if name in ONE_RANK else 2
    gens = 1 if name in ("device_es", "device_es_quota") else cases.CASES[name][3]
    single, pod = _single(name), _pod(name, ranks)
    try:
        assert type(pod).__name__.startswith(("Pod", "HostPod")) and pod.pod.size == ranks
        a, b = cases.run(single, gens), cases.run(pod, gens)
    finally:
        single.close()
        pod.close()
    for ra, rb in zip(a, b):
        for k in ra:
            if k == "theta" and name.startswith("device") and ranks > 1:
                np.testing.assert_allclose(rb[k], ra[k], rtol=0, atol=1e-6)  # partial gradients added
            elif isinstance(ra[k], np.ndarray):
                np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"{name}: {k}")
            else:
                assert rb[k] == ra[k], (name, k)


def test_device_pod_gradient_is_the_sum_of_rank_partials():
    """The two-rank device ES pod's gradient: K2's plain version over each
    rank's rows (its blocks), the two partial sums added."""
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient

    pod = cases.build("device_es", emulate=True)
    seen = {}
    real = pod._noise_gradient
    pod._noise_gradient = lambda idxs, w: seen.setdefault("g", (idxs, w, real(idxs, w)))[2]
    pod.train_step()
    idxs, w, g = seen["g"]
    assert [r.tolist() for r in pod._rows] == [list(range(0, 4)), list(range(4, 8))]
    D = pod.model.num_params
    parts = [noise_gradient(pod.noise.noise, idxs[r], w[r], D, pod.config.grad_chunk) for r in pod._rows]
    assert torch.equal(g, parts[0] + parts[1])


# -------------------------------------------------- against the JAX package


def _jax_mesh():
    from deep_neuroevolution_tpu.parallel.mesh import make_pop_mesh

    assert jax.device_count() == 8
    return make_pop_mesh()


def _blocks_of(pod, n_rows):
    """Contiguous rows a rank, the JAX mesh's pop sharding."""
    per = n_rows // pod.pod.size
    pod._rows = [torch.arange(p * per, (p + 1) * per) for p in range(pod.pod.size)]


@pytest.mark.parametrize("mode", ["centered_rank", "centered_sign_rank"])
def test_es_pod_update_matches_make_pod_update_eval(mode):
    """The same global returns, sign returns, noise indices, θ and Adam
    state into the JAX package's make_pod_update_eval (es_pod.py:175) and
    the port's device-pod update: θ within f32 reordering."""
    from deep_neuroevolution_tpu.envs import CartPoleEnv
    from deep_neuroevolution_tpu.models import LinearClassifier
    from deep_neuroevolution_tpu.ops import Adam, NoiseTable
    from deep_neuroevolution_tpu.parallel.es_pod import make_pod_update_eval

    from deep_neuroevolution_torch.algos.es import ESConfig

    rng = np.random.default_rng(5)
    n, count = 32, 60_000
    model = LinearClassifier(obs_dim=4, num_actions=2)
    D = model.num_params
    idxs = rng.integers(0, count - D + 1, size=n).astype(np.int32)
    rets = rng.normal(size=(n, 2)).astype(np.float32)
    srets = np.sign(rng.normal(size=(n, 2))).astype(np.float32)
    theta0 = rng.normal(size=D).astype(np.float32)
    step = make_pod_update_eval(CartPoleEnv(), model, Adam(stepsize=0.1), _jax_mesh(), return_proc_mode=mode,
                                l2coeff=0.005)
    opt = Adam(stepsize=0.1)
    jres = step(jnp.asarray(theta0), opt.init(D), NoiseTable.from_seed(count=count).noise, jnp.asarray(idxs),
                jnp.asarray(rets), jnp.asarray(srets), jax.random.PRNGKey(0), jnp.int32(20))

    pod = tpt.PodESTrainer(TCartPole(), TLinear(obs_dim=4, num_actions=2),
                           ESConfig(population_size=2 * n, return_proc_mode=mode, num_eval_episodes=0),
                           optimizer=toptim.Adam(stepsize=0.1),
                           noise_table=TNoiseTable.from_seed(count=count, device=CPU), device="cpu", emulate_procs=8)
    pod.theta = torch.from_numpy(theta0)
    _blocks_of(pod, n)
    g, _, theta, ratio = pod._compute_update(torch.from_numpy(idxs), rets, srets)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jres.theta), rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(torch.sum(g * g)), float(jres.grad_sq_sum), rtol=1e-5)
    np.testing.assert_allclose(float(ratio), float(jres.update_ratio), rtol=1e-5)


@pytest.mark.parametrize("algo_type", ["ns", "nsr"])
def test_nses_pod_update_matches_make_pod_nses_step(algo_type):
    """make_pod_nses_step (nses_pod.py:55) on the 8-device mesh: its
    returns, novelty and noise indices into the port's device NS pod update
    (NS: novelty ranks; NSR: their mean with the reward ranks), from the
    same θ and Adam state: θ within f32 reordering."""
    from deep_neuroevolution_tpu.envs import MazeEnv
    from deep_neuroevolution_tpu.models import ContinuousMLP
    from deep_neuroevolution_tpu.ops import Adam, NoiseTable, novelty
    from deep_neuroevolution_tpu.parallel.nses_pod import make_pod_nses_step

    from deep_neuroevolution_torch.algos.nses import NSESConfig

    count = 100_000
    model = ContinuousMLP(obs_dim=11, ac_dim=2, hidden=8)
    archive = novelty.archive_init(64, 2)
    for p in ([10.0, 10.0], [50.0, 50.0], [100.0, 20.0]):
        archive = novelty.archive_add(archive, jnp.asarray(p))
    step = make_pod_nses_step(MazeEnv(), model, Adam(stepsize=0.01), _jax_mesh(), npairs_per_device=2, k=2,
                              algo_type=algo_type, l2coeff=0.005)
    theta0 = model.init_theta(jax.random.PRNGKey(0))
    res = step(theta0, Adam(stepsize=0.01).init(model.num_params), NoiseTable.from_seed(count=count).noise,
               jax.random.split(jax.random.PRNGKey(7), 8), jnp.int32(30), jnp.float32(0.05), archive)

    pod = tpt.PodNSESTrainer(TMaze(), TContinuousMLP(obs_dim=11, ac_dim=2, hidden=8),
                             NSESConfig(population_size=32, algo_type=algo_type, k=2, meta_population_size=1,
                                        episode_cutoff_mode=5),
                             optimizer=toptim.Adam(stepsize=0.01),
                             noise_table=TNoiseTable.from_seed(count=count, device=CPU), device="cpu",
                             emulate_procs=8)
    pod.theta, pod.opt_state = torch.from_numpy(np.array(theta0)), pod.optimizer.init(model.num_params, CPU)
    _blocks_of(pod, 16)
    _, _, theta, _ = pod._compute_update(torch.from_numpy(np.array(res.noise_idxs)), np.array(res.returns_n2),
                                         np.array(res.novelty_n2))
    np.testing.assert_allclose(theta.numpy(), np.asarray(res.theta), rtol=0, atol=2e-6)


class _JaxLadder:
    """The attributes the JAX package's HostPodGATrainer._eval_chunked
    reads, its episodes recorded: (rank, round, candidate indices)."""

    def __init__(self, size, slots):
        self._hp_nproc, self._hp_pids, self._hp_emulate = size, tuple(range(size)), size
        self.env = type("E", (), {"batch_size": slots, "bc_dim": 2})()
        self.calls, self._k = [], jax.random.PRNGKey(0)

    def _next_key(self):
        return self._k

    def _eval_host(self, part, tslimit, key):
        self.calls.append(np.asarray(part)[:, 0].astype(int))
        n = part.shape[0]
        return np.zeros(n, np.float32), np.ones(n, np.int32), np.zeros((n, 2), np.float32)

    def _hp_gather_cols(self, cols):
        return tuple(np.asarray(c) for c in cols)


@pytest.mark.parametrize("n_candidates,episodes_per,size,slots", [(10, 3, 2, 4), (4, 2, 3, 2), (1, 2, 3, 4),
                                                                   (3, 1, 2, 8)])
def test_ladder_split_matches_the_jax_host_pod(n_candidates, episodes_per, size, slots):
    """The host-pod GA ladder's (candidate × episode) split, index for index,
    against host_pod.py:198-238 (a rank with no entries idle)."""
    from deep_neuroevolution_tpu.parallel.host_pod import HostPodGATrainer

    fake = _JaxLadder(size, slots)
    thetas = jnp.repeat(jnp.arange(n_candidates, dtype=jnp.float32)[:, None], 3, axis=1)
    rets, _, _ = HostPodGATrainer._eval_chunked(fake, thetas, 10, episodes_per)
    assert rets.shape == (n_candidates, episodes_per)
    ours = [c for rounds in thp.ladder_split(n_candidates, episodes_per, size, slots) for c in rounds]
    assert [c.tolist() for c in ours] == [c.tolist() for c in fake.calls]
    rounds = [len(r) for r in thp.ladder_split(n_candidates, episodes_per, size, slots)]
    if (n_candidates, episodes_per, size) == (1, 2, 3):
        assert rounds == [1, 1, 0]  # the third rank is idle


# ---------------------------------------------- theta_hbm_budget, host-pod GA


def test_host_pod_ga_rounds_keep_theta_under_budget(monkeypatch):
    """A budget of two SmallDQN θ rows: every fitness round of the host-pod GA
    evaluates at most two members (the JAX package's host pod would take the
    slots' four), and the pod still equals the single trainer."""
    from deep_neuroevolution_torch.algos.ga import GATrainer

    name = "host_ga"
    budget = {"theta_hbm_budget": 2 * 4 * 1_004_852 + 4, "env_kwargs": {"batch_size": 4, "num_threads": 1}}
    exp_file, algo, overrides, _ = cases.CASES[name]
    single = config.load_experiment(cases.experiment(name), overrides={**overrides, **budget}, device="cpu")
    pod = config.load_experiment(cases.experiment(name), overrides={**overrides, **budget, "host_pod": 2},
                                 device="cpu")
    sizes = []
    real = GATrainer._eval_host
    monkeypatch.setattr(GATrainer, "_eval_host",
                        lambda self, th, ts, seed=None: sizes.append((type(self).__name__, th.shape[0]))
                        or real(self, th, ts, seed))
    try:
        assert pod._chunk(-(-8 // 2)) == 2
        a, b = cases.run(single, 1), cases.run(pod, 1)
    finally:
        single.close()
        pod.close()
    for kind in ("GATrainer", "HostPodGATrainer"):  # each one's fitness rounds come first
        assert [n for t, n in sizes if t == kind][:4] == [2, 2, 2, 2]
    np.testing.assert_array_equal(b[0]["fitness"], a[0]["fitness"])
    assert b[0]["seeds"] == a[0]["seeds"]


# ------------------------------------------------------ loader and refusals

MAZE = {"population_size": 16, "episode_cutoff_mode": 30, "noise_size": 3_000_000}
TOY = {"game": "toy", "population_size": 8, "episode_cutoff_mode": 10, "noise_size": 3_000_000,
       "env_kwargs": {"batch_size": 4, "num_threads": 1}}


def _load(file, overrides, algo=None):
    with open(os.path.join(cases.ROOT, "configurations", file)) as f:
        tr = config.load_experiment(json.load(f), overrides=overrides, device="cpu", algo=algo)
    tr.close()
    return tr


@pytest.mark.parametrize("file,algo,overrides,expected", [
    ("maze_es.json", None, {}, "ESTrainer"),
    ("maze_es.json", None, {"pod": "auto"}, "ESTrainer"),
    ("maze_es.json", None, {"pod": True}, "PodESTrainer"),
    ("maze_es.json", None, {"pod": False}, "ESTrainer"),
    ("maze_es.json", "ga", {"pod": True}, "PodGATrainer"),
    ("maze_es.json", "rs", {"pod": True}, "PodRSTrainer"),
    ("maze_nses.json", None, {"pod": True}, "PodNSESTrainer"),
    ("maze_es.json", None, {"pod": "auto", "noise": "virtual"}, "ESTrainer"),
    ("es_atari_config.json", None, {"host_pod": 2}, "HostPodESTrainer"),
    ("ga_toy_config.json", None, {"host_pod": 2}, "HostPodGATrainer"),
    ("ga_toy_config.json", "rs", {"host_pod": 3}, "HostPodRSTrainer"),
    ("es_atari_config.json", None, {}, "ESTrainer"),
])
def test_loader_dispatch_as_in_jax(file, algo, overrides, expected):
    """The JAX package's pick_trainer (config.py:141-183): a device env gets a
    device pod with ``pod: true`` (or in a world of more than one rank), a
    host-engine env a host pod with ``host_pod: N``; ``pod: "auto"`` on
    ``noise: virtual`` stays single."""
    base = TOY if file.startswith(("es_atari", "ga_toy")) else MAZE
    if file == "es_atari_config.json":
        base = {**base, "population_size": 8, "num_eval_episodes": 1}
    tr = _load(file, {**base, **overrides}, algo)
    assert type(tr).__name__ == expected
    if "host_pod" in overrides:
        assert tr.pod.emulated and tr.pod.size == overrides["host_pod"] and len(tr._engines) == tr.pod.size
    assert checkpoint.trainer_type(tr) == expected.replace("HostPod", "").replace("Pod", "")


@pytest.mark.parametrize("file,overrides,error,match", [
    ("maze_es.json", {**MAZE, "host_pod": 2}, ValueError, "'host_pod' override applies to host-engine envs"),
    ("es_atari_config.json", {**TOY, "pod": True}, ValueError, "'pod' override applies to device envs"),
    ("maze_es.json", {**MAZE, "pod": "yes"}, ValueError, "'pod' override takes"),
    ("es_atari_config.json", {**TOY, "host_pod": 0}, ValueError, "rank count of at least 1"),
    ("maze_es.json", {**MAZE, "pod": True, "noise": "virtual"}, ValueError, "VirtualNoise is wired"),
])
def test_loader_refusals(file, overrides, error, match):
    with pytest.raises(error, match=match):
        _load(file, overrides)


def test_pods_refuse_the_other_kind_of_env():
    """A device pod refuses a host-engine env (trainers.py:48-52), a host pod
    a device env."""
    from deep_neuroevolution_torch.algos.es import ESConfig
    from deep_neuroevolution_torch.envs import AtariEnv
    from deep_neuroevolution_torch.models import SmallDQN

    env = AtariEnv("toy", batch_size=2, num_threads=1)
    try:
        with pytest.raises(NotImplementedError, match="device pods drive device envs"):
            tpt.PodESTrainer(env, SmallDQN(num_actions=env.num_actions), ESConfig(), device="cpu")
    finally:
        env.close()
    table = TNoiseTable.from_seed(count=50_000, device=CPU)
    with pytest.raises(ValueError, match="host pods drive host-engine envs"):
        thp.HostPodESTrainer(TCartPole(), TLinear(obs_dim=4, num_actions=2), ESConfig(), noise_table=table,
                             device="cpu", emulate_procs=2)
    with pytest.raises(ValueError, match="VirtualNoise"):
        tpt.PodGATrainer(TCartPole(), TLinear(obs_dim=4, num_actions=2), cases_ga_config(),
                         noise_table=VirtualNoise.from_seed(count=50_000, device=CPU), device="cpu")


def cases_ga_config():
    from deep_neuroevolution_torch.algos.ga import GAConfig

    return GAConfig(population_size=4)


def test_a_world_of_one_without_torchrun(monkeypatch):
    """No torchrun environment and no init_method: init_multihost makes no
    group, and the process is rank 0 of one, the coordinator."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_multihost(device="cpu") is False
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    assert distributed.coordinator_only(lambda: 7)() == 7


def test_a_torchrun_rank_gets_its_own_card(monkeypatch):
    """resolve_device(None) on local rank 1 of a two-card world is cuda:1;
    a local rank without a card of its own is refused, never sent to the
    CPU."""
    from deep_neuroevolution_torch.device import NoCudaDevice, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device(None) == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(NoCudaDevice, match="no card of its own"):
        resolve_device(None)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert resolve_device(None) == torch.device("cuda", 0)
