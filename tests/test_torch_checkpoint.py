"""The port's checkpoints against the JAX package's, on the CPU: policy
files that both packages read, the port's trainer snapshots and bit-for-bit
resume, ``load_from``, ``init_from`` and ``load_population`` from the JAX
package's files, and the refusal of a JAX trainer snapshot.

Policy files: θ, the obs stats and the reference batch must come back bit
for bit in either direction, the model equal to the one built from the same
name and arguments, and an MLP's actions within 1e-6·max of the other
package's. Resume: the uninterrupted run's and the resumed run's last
generation equal bit for bit (θ, returns and lengths)."""

import dataclasses
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import main as cli
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.ops import flat as tflat
from deep_neuroevolution_torch.utils import checkpoint as tckpt
from deep_neuroevolution_torch.utils import config as tconfig
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.algos import ga as jga
from deep_neuroevolution_tpu.envs import make as jmake
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.models import batchnorm as jbn
from deep_neuroevolution_tpu.ops import flat as jflat
from deep_neuroevolution_tpu.ops import obstat as jobstat
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import checkpoint as jckpt

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MLP_KW = dict(obs_dim=5, ac_dim=2, ac_low=(-1.0, -2.0), ac_high=(1.0, 2.0), hidden_dims=(8, 4))
POLICIES = {  # name → (JAX model, the port's model, obs-stat shape or None, ref batch shape or None)
    "vbn": (jbn.VirtualBNDQN(num_actions=4), tmodels.VirtualBNDQN(num_actions=4), None, (3, 84, 84, 4)),
    "large": (jmodels.LargeDQN(num_actions=18), tmodels.LargeDQN(num_actions=18), None, None),
    "mlp": (jmodels.MujocoMLP(**MLP_KW), tmodels.MujocoMLP(**MLP_KW), (5,), None),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs a worker per core, and these small
    CPU forwards lose most of their time to threads waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def quiet_loggers(monkeypatch):
    rows = []

    def dump():
        rows.append(dict(ttab._logger._kvs))
        ttab._logger._kvs.clear()

    monkeypatch.setattr(ttab, "dump_tabular", dump)
    return rows


def _policy_inputs(name):
    jm, tm, ob_shape, rb_shape = POLICIES[name]
    rs = np.random.RandomState(1)
    theta = rs.randn(jm.num_params).astype(np.float32)
    ob = None
    if ob_shape:
        ob = (rs.randn(*ob_shape).astype(np.float32), rs.rand(*ob_shape).astype(np.float32) + 2,
              np.asarray(7.5, np.float32))
    rb = rs.rand(*rb_shape).astype(np.float32) if rb_shape else None
    return jm, tm, theta, ob, rb


def _mlp_actions(jm, tm, theta, ob):
    """Both packages' actions of θ on 6 observations, normalized by the
    obs stats ``ob``."""
    obs = np.random.RandomState(2).randn(6, jm.obs_dim).astype(np.float32)
    jst = jobstat.RunningStat(*(jnp.asarray(v) for v in ob))
    jctx = jmodels.MLPContext(jobstat.mean(jst), jobstat.std(jst), jnp.asarray(0.0))
    ja = np.asarray(jax.vmap(lambda o: jm.act_parts(jm.unflatten(jnp.asarray(theta)), o, jax.random.PRNGKey(0),
                                                    jctx))(jnp.asarray(obs)))
    from deep_neuroevolution_torch.ops import obstat as tobstat

    tst = tobstat.RunningStat(*(torch.from_numpy(np.array(v)) for v in ob))
    tctx = tmodels.MLPContext(tobstat.mean(tst), tobstat.std(tst), 0.0)
    ta = tm.batch_act_parts(tm.unflatten(torch.from_numpy(theta)[None].expand(6, -1)), torch.from_numpy(obs), tctx)
    return ja, ta.numpy()


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_files_cross_between_the_packages(name, tmp_path):
    jm, tm, theta, ob, rb = _policy_inputs(name)
    # the JAX package's file, read by the port
    jpath = str(tmp_path / "jax.pkl")
    jckpt.save_policy_snapshot(jpath, jm, jnp.asarray(theta), ob_stat=None if ob is None else jobstat.RunningStat(
        *(jnp.asarray(v) for v in ob)), ref_batch=rb, extra={"iteration": 3})
    model, t, payload = tckpt.load_policy_snapshot(jpath, device="cpu")
    assert model == tm and type(model) is type(tm)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), theta)
    assert payload["extra"] == {"iteration": 3}
    if ob is not None:
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(payload["ob_stat"], ob))
    if rb is not None:
        assert np.array_equal(payload["ref_batch"].numpy(), rb)
    # the port's file, read by the JAX package with its own plain pickle.load
    tpath = str(tmp_path / "torch.pkl")
    tckpt.save_policy_snapshot(tpath, tm, torch.from_numpy(theta),
                               ob_stat=None if ob is None else tuple(torch.from_numpy(np.array(v)) for v in ob),
                               ref_batch=None if rb is None else torch.from_numpy(rb))
    jmodel, jt, jpayload = jckpt.load_policy_snapshot(tpath)
    assert dataclasses.asdict(jmodel) == dataclasses.asdict(jm) and type(jmodel) is type(jm)
    assert np.array_equal(jt, theta) and jt.dtype == np.float32
    if ob is not None:  # a plain (sum, sumsq, count) tuple, as utils/viz.py reads it
        assert type(jpayload["ob_stat"]) is tuple and all(np.array_equal(a, b) for a, b in zip(jpayload["ob_stat"], ob))
        ja, ta = _mlp_actions(jmodel, model, jt, jpayload["ob_stat"])
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6 * np.abs(ja).max())
    if rb is not None:
        assert np.array_equal(jpayload["ref_batch"], rb)


def test_fields_the_port_fixes_must_hold_its_values(tmp_path):
    theta = jnp.zeros(jmodels.SmallDQN(num_actions=4).num_params)
    path = str(tmp_path / "p.pkl")
    jckpt.save_policy_snapshot(path, jmodels.SmallDQN(num_actions=4, matvec_impl="pallas"), theta)
    model, _, _ = tckpt.load_policy_snapshot(path, device="cpu")  # a TPU-only knob is ignored
    assert model == tmodels.SmallDQN(num_actions=4)
    for kw in ({"nonlin_type": "tanh"}, {"in_hw": 64, "in_ch": 3}, {"out_std": 0.05}):
        jm = jmodels.SmallDQN(num_actions=4, **kw)
        jckpt.save_policy_snapshot(path, jm, jnp.zeros(jm.num_params))
        model, _, _ = tckpt.load_policy_snapshot(path, device="cpu")  # the JAX fields are the port's now
        assert model == tmodels.SmallDQN(num_actions=4, **kw)
    for kw in ({"FC": 128}, {"LAYERS": (("conv1", 16, 8, 4),)}):  # fixed per class in the port
        jckpt.save_policy_snapshot(path, jmodels.SmallDQN(num_actions=4, **kw), theta)
        with pytest.raises(NotImplementedError, match="per class"):
            tckpt.load_policy_snapshot(path, device="cpu")


def test_jax_trainer_snapshot_is_refused(tmp_path):
    env = jmake("maze")
    m = jmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
    jtr = jes.ESTrainer(env, m, jes.ESConfig(population_size=4), noise_table=JaxNoise.from_seed(count=10_000))
    path = str(tmp_path / "snapshot.pkl")
    jckpt.save_trainer(path, jtr)
    tr = tconfig.load_experiment(json.loads((ROOT / "configurations" / "maze_es.json").read_text()),
                                 overrides={"noise_size": 10_000}, device="cpu")
    with pytest.raises(ValueError, match="trainer states do not"):
        tckpt.load_trainer(path, tr)
    # a class of the JAX package that the port does not map is refused
    (tmp_path / "cutoff.pkl").write_bytes(pickle.dumps(jes.CutoffState(1, 0.0, 1.0, 1, False)))
    with pytest.raises(pickle.UnpicklingError, match="does not read"):
        tckpt.load_pickle(str(tmp_path / "cutoff.pkl"))


# --------------------------------------------------------------- resume

SMALL_TOY = {"population_size": 8, "episode_cutoff_mode": 12, "noise_size": 3_000_000,
             "env_kwargs": {"batch_size": 4}}


def _exp(name, **fields):
    return {**json.loads((ROOT / "configurations" / name).read_text()), **fields}


# the GA's ladder cut: its test episodes run to the env's own cutoff
GA_TOY = _exp("ga_toy_config.json", validation_threshold=2, num_validation_episodes=2, num_test_episodes=2)
RESUME_CASES = {  # name → (experiment, algo, overrides)
    "es_maze": (_exp("maze_es.json"), None, {"population_size": 16, "episode_cutoff_mode": 30,
                                             "noise_size": 3_000_000, "num_eval_episodes": 2}),
    # ToyCatch without EpisodicLife: a reset with its seed fixes the episode
    "es_toy": (_exp("es_toy_config.json"), None, {**SMALL_TOY, "num_eval_episodes": 2}),
    "nses_maze": (_exp("maze_nses.json"), None, {"population_size": 16, "episode_cutoff_mode": 30,
                                                 "noise_size": 3_000_000}),
    "ga_toy": (GA_TOY, None, SMALL_TOY),
    "rs_toy": (GA_TOY, "rs", SMALL_TOY),
}


def _train(name, log_dir, iterations, extra=()):
    exp, algo, overrides = RESUME_CASES[name]
    argv = ["train", "--exp_str", json.dumps(exp), "--overrides", json.dumps(overrides), "--device", "cpu",
            "--log_dir", str(log_dir), "--iterations", str(iterations), "--snapshot_freq", "1",
            *(["--algo", algo] if algo else []), *extra]
    return cli.cmd_train(cli.build_parser().parse_args(argv))


def _ga_view(tr):
    st = tr.state
    return ([(o.seeds, o.fitness, o.training_steps) for o in st.population], st.elite, st.curr_solution,
            tr.cached_parent_seeds, st.it, st.timesteps_so_far)


@pytest.mark.parametrize("name", sorted(RESUME_CASES))
def test_resume_is_bit_for_bit(name, tmp_path, quiet_loggers):
    """``main train --snapshot_freq 1``: 3 generations straight through
    against 2, then a resumed run of 1 from <log_dir>/snapshot.pkl."""
    a = _train(name, tmp_path / "a", 3)
    rows_a = list(quiet_loggers)
    _train(name, tmp_path / "b", 2)
    b = _train(name, tmp_path / "b", 1)
    rows_b = quiet_loggers[len(rows_a):]
    assert len(rows_a) == len(rows_b) == 3
    for key in ("EpRewMean", "EpLenMean", "EpNovMean", "PopulationEpRewMean", "TimestepsSoFar", "EpisodesSoFar",
                "ArchiveSize", "GradNorm", "Norm"):
        if key in rows_a[-1]:
            assert rows_a[-1][key] == rows_b[-1][key], key
    if name.startswith(("ga", "rs")):
        assert _ga_view(a) == _ga_view(b) and a.state.it == 3
        assert torch.equal(a.cached_parent_thetas, b.cached_parent_thetas) if a.cached_parent_thetas is not None \
            else b.cached_parent_thetas is None
        if name == "rs_toy":
            assert (a.best_score, a.best_seeds) == (b.best_score, b.best_seeds)
        return
    assert a.iteration == b.iteration == 3
    assert torch.equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.last_stats.returns, b.last_stats.returns)
    np.testing.assert_array_equal(a.last_stats.lengths, b.last_stats.lengths)
    if name == "nses_maze":
        assert all(torch.equal(p.theta, q.theta) for p, q in zip(a.parents, b.parents))
        assert torch.equal(a.archive.points, b.archive.points) and a.curr_parent == b.curr_parent
        return
    np.testing.assert_array_equal(a.last_stats.eval_returns, b.last_stats.eval_returns)
    # the policy file of generation 3 loads back to the same θ
    (policy,) = (tmp_path / "a").glob("snapshot_iter00003_rew*.pkl")
    _, theta, payload = tckpt.load_policy_snapshot(str(policy), device="cpu")
    assert torch.equal(theta, a.theta) and payload["extra"]["iteration"] == 3


def test_no_resume_starts_afresh(tmp_path, quiet_loggers):
    _train("es_maze", tmp_path, 1)
    tr = _train("es_maze", tmp_path, 1, ["--no_resume"])
    assert tr.iteration == 1


# ------------------------------------------------ load_from, init_from, load_population


def test_load_from_matches_jax(tmp_path):
    """The GA-seeded ES: θ₀ of a seed chain, bit for bit the JAX package's
    ``theta_from_seed_chain``; the path is formatted with the experiment.
    A CPU-style chain (bare indices) through ``theta_from_seed_chain(...,
    'cpu')``: the re-init of its first row is a float32 column sum in
    another order, so within 1e-6·max|θ| (tests/test_torch_ga_cpu.py)."""
    chain = [123, (4567, 0.002), 89, (10, 0.5)]
    (tmp_path / "toy.pkl").write_bytes(pickle.dumps(chain))
    exp = {**json.loads((ROOT / "configurations" / "es_toy_config.json").read_text()),
           "load_from": str(tmp_path / "{game}.pkl")}
    tr = tconfig.load_experiment(exp, overrides=SMALL_TOY, device="cpu")
    tr.close()
    jm = jbn.VirtualBNDQN(num_actions=tr.model.num_actions)
    jtheta = np.asarray(jckpt.theta_from_seed_chain(jm, JaxNoise.from_seed(count=3_000_000), chain))
    assert np.array_equal(tr.theta.numpy(), jtheta)
    cpu_chain = [123, 4567, 89, 10]
    jcpu = np.asarray(jckpt.theta_from_seed_chain(jm, JaxNoise.from_seed(count=3_000_000), cpu_chain,
                                                  genome_style="cpu", noise_stdev=0.005))
    tcpu = tckpt.theta_from_seed_chain(tr.model, tr.noise, cpu_chain, genome_style="cpu", noise_stdev=0.005)
    np.testing.assert_allclose(tcpu.numpy(), jcpu, rtol=0, atol=1e-6 * np.abs(jcpu).max())
    with pytest.raises(ValueError, match="genome_style"):
        tckpt.theta_from_seed_chain(tr.model, tr.noise, chain, genome_style="mixed")


def test_init_from_a_jax_policy_file(tmp_path):
    """The warm start: a smaller JAX MujocoMLP's tensors in the prefix slices
    of the maze ES's larger one, equal to the JAX package's
    ``partial_load`` from the same starting θ."""
    small = jmodels.MujocoMLP(obs_dim=11, ac_dim=2, hidden_dims=(8,))
    theta_small = np.random.RandomState(3).randn(small.num_params).astype(np.float32)
    path = str(tmp_path / "small.pkl")
    jckpt.save_policy_snapshot(path, small, jnp.asarray(theta_small))
    maze = json.loads((ROOT / "configurations" / "maze_es.json").read_text())
    policy = {"type": "MujocoPolicy", "args": {"hidden_dims": [16]}}
    kw = dict(overrides={"noise_size": 3_000_000}, device="cpu")
    base = tconfig.load_experiment({**maze, "policy": policy}, **kw)
    warm = tconfig.load_experiment({**maze, "policy": {**policy, "args": {**policy["args"], "init_from": path}}}, **kw)
    big = jmodels.MujocoMLP(obs_dim=11, ac_dim=2, ac_low=(-1.0, -1.0), ac_high=(1.0, 1.0), hidden_dims=(16,))
    assert big.num_params == warm.model.num_params > small.num_params
    jparts = jax.device_get(jflat.unflatten(jnp.asarray(theta_small), small.specs))
    want = np.asarray(jflat.partial_load(jnp.asarray(base.theta.numpy()), big.specs, jparts))
    assert np.array_equal(warm.theta.numpy(), want) and not np.array_equal(want, base.theta.numpy())
    assert torch.equal(tflat.partial_load(base.theta, warm.model.specs, {}), base.theta)


def test_load_population_from_a_jax_ga_snapshot(tmp_path):
    """A JAX GA trainer pickle (its Offspring records): the port imports the
    same population as the JAX package's ``copy_population``, bare-int
    mutations migrated to (idx, 0.005)."""
    env = JaxAtari("toy", batch_size=4, num_threads=1)
    try:
        jtr = jga.GATrainer(env, jmodels.SmallDQN(num_actions=env.num_actions), jga.GAConfig(population_size=4),
                            noise_table=JaxNoise.from_seed(count=3_000_000))
        jtr.state.population = [jga.Offspring((11, (22, 0.002)), 5.0, 30), jga.Offspring((33, 44), 4.0, 20),
                                jga.Offspring((55,), 1.0, 10)]
        jtr.state.elite = jtr.state.population[0]
        path = str(tmp_path / "snapshot.pkl")
        jckpt.save_trainer(path, jtr)
        jtr.copy_population(path)
        want = [(o.seeds, o.fitness, o.training_steps) for o in jtr.state.population]
    finally:
        env.close()
    assert want[1][0] == (33, (44, 0.005))
    exp = {**json.loads((ROOT / "configurations" / "ga_toy_config.json").read_text()), "load_population": path}
    tr = tconfig.load_experiment(exp, overrides=SMALL_TOY, device="cpu")
    tr.close()
    assert [(o.seeds, o.fitness, o.training_steps) for o in tr.state.population] == want
    assert tr.cached_parent_seeds == [] and tr.cached_parent_thetas is None
