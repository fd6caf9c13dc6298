"""The MuJoCo path of the port (envs/mujoco.py, rollout_host_vec, the host
arms' obs stats, the humanoid configurations) against the JAX package on
the CPU, from the same numpy inputs.

Humanoid-v5 on 2-8 slots and cutoffs of 20-50 steps. JAX's key streams
cannot be reproduced in torch, so the port is handed what the JAX side drew
(θ, noise offsets, rollout seeds, the eval and mean-BC seeds), and action
noise is off wherever two rollouts are compared: the JAX package draws it
from per-slot keys. The host generator's draws (the obs-stat masks, the
episode seeds) follow from a rollout seed in both packages alike.

The physics is chaotic and the two packages' float32 forwards differ in
their last bits, so the same rollout drifts apart with the horizon.
Measured on twelve populations of 8 members (an initial θ plus 0.02·N(0,
1), as an ES round perturbs it), with and without obs normalization,
largest differences relative to the largest value: over 15 steps the
returns 4.3e-5, the mass centres 2.4e-5 m, the obs sums 7.2e-4 and their
squares 2.6e-4; over 20 steps (where every population had an episode end
on the env's condition) 7.1e-4, 3.8e-4 m, 1.2e-2 and 1.9e-3; lengths
equal in all. Unperturbed initial θ drift less (returns 1.7e-3 over 30
steps, 2.2e-2 over 50). The tolerances below are those readings with a
margin; lengths, obs-stat counts and masks are compared exactly. A
rollout of one θ batch through both packages is held to the JAX one; the
port's own θ ± σε differ from the JAX package's by an ulp (see
``_feed_jax_batches``)."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

from deep_neuroevolution_torch import weights  # noqa: E402
from deep_neuroevolution_torch.algos import es as tes  # noqa: E402
from deep_neuroevolution_torch.algos import nses as tnses  # noqa: E402
from deep_neuroevolution_torch.algos import rollout_host as trh  # noqa: E402
from deep_neuroevolution_torch.envs import mujoco as tmj  # noqa: E402
from deep_neuroevolution_torch.models import MujocoMLP as TorchMLP  # noqa: E402
from deep_neuroevolution_torch.models.mlp import MLPContext as TorchCtx  # noqa: E402
from deep_neuroevolution_torch.ops import fitness as tfit  # noqa: E402
from deep_neuroevolution_torch.ops import noise_gradient as tng  # noqa: E402
from deep_neuroevolution_torch.ops import novelty as tnov  # noqa: E402
from deep_neuroevolution_torch.ops import obstat as tobstat  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise  # noqa: E402
from deep_neuroevolution_torch.utils import checkpoint as tckpt  # noqa: E402
from deep_neuroevolution_torch.utils import config as tconfig  # noqa: E402
from deep_neuroevolution_torch.utils import tabular as ttab  # noqa: E402
from deep_neuroevolution_torch.utils import viz as tviz  # noqa: E402
from deep_neuroevolution_tpu.algos import rollout_host as jrh  # noqa: E402
from deep_neuroevolution_tpu.envs import mujoco as jmj  # noqa: E402
from deep_neuroevolution_tpu.models import MujocoMLP as JaxMLP  # noqa: E402
from deep_neuroevolution_tpu.models.mlp import MLPContext as JaxCtx  # noqa: E402
from deep_neuroevolution_tpu.ops import fitness as jfit  # noqa: E402
from deep_neuroevolution_tpu.ops import obstat as jobstat  # noqa: E402
from deep_neuroevolution_tpu.utils import checkpoint as jckpt  # noqa: E402
from deep_neuroevolution_tpu.utils import config as jconfig  # noqa: E402
from deep_neuroevolution_tpu.utils import tabular as jtab  # noqa: E402
from deep_neuroevolution_tpu.utils import viz as jviz  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ENV = "Humanoid-v5"
COUNT = 2_000_000
# by horizon (see the module docstring): returns relative to the largest,
# mass centres in metres, obs sums relative to the largest
H15, RTOL15, BC15, OB15 = 15, 1e-4, 1e-4, 2e-3
H20, RTOL20, BC20, OB20 = 20, 2e-3, 1e-3, 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under the test runner's worker processes the CPU
    forwards lose most of their time to contended threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def quiet_loggers(monkeypatch):
    """Both packages' tabular rows, kept instead of printed."""
    rows = {"jax": [], "torch": []}

    def keep(mod, name):
        def dump():
            rows[name].append(dict(mod._logger._kvs))
            mod._logger._kvs.clear()

        return dump

    monkeypatch.setattr(jtab, "dump_tabular", keep(jtab, "jax"))
    monkeypatch.setattr(ttab, "dump_tabular", keep(ttab, "torch"))
    return rows


def _jax_seed(key) -> int:
    """The host RNG seed the JAX package derives from a key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def _models(env, noise: float = 0.0, hidden=(256, 256)):
    space = env.action_space
    kw = dict(obs_dim=env.obs_shape[0], ac_dim=space.dim, ac_low=space.low, ac_high=space.high,
              hidden_dims=hidden, ac_noise_std=noise)
    return JaxMLP(**kw), TorchMLP(**kw)


def _members(jm, B: int, seed: int) -> np.ndarray:
    return np.stack([np.asarray(jm.init_theta(k)) for k in jax.random.split(jax.random.PRNGKey(seed), B)])


def _population(jm, B: int, seed: int) -> np.ndarray:
    """An initial θ plus 0.02·N(0, 1) a member, as an ES round perturbs it."""
    rs = np.random.RandomState(seed)
    return _members(jm, 1, seed) + 0.02 * rs.randn(B, jm.num_params).astype(np.float32)


def _obs_stats(seed: int, dim: int = 348):
    rs = np.random.RandomState(seed)
    return rs.randn(dim).astype(np.float32) * 0.1, (rs.rand(dim) + 0.5).astype(np.float32)


def _close(*envs):
    for e in envs:
        e.close()


def _exp(name: str) -> dict:
    return json.loads((ROOT / "configurations" / name).read_text())


def _allclose(got, want, what: str, rtol: float = RTOL15):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1.0), err_msg=what)


# ------------------------------------------------------------- (a) ids


def test_env_ids_and_families_match_jax():
    assert tmj.MUJOCO_FAMILIES == jmj.MUJOCO_FAMILIES
    for env_id in ("Humanoid-v1", "Humanoid-v5", "HalfCheetah-v1", "InvertedPendulum-v5", "Hopper-v2"):
        assert tmj.resolve_env_id(env_id) == jmj.resolve_env_id(env_id)
    with pytest.raises(ValueError, match="no gymnasium registration"):
        tmj.resolve_env_id("NoSuchTask-v1")
    assert tmj.is_available()
    # the trap world: the JAX package's XML text, at one path however often asked
    path = tmj.deceptive_humanoid_xml()
    assert tmj.deceptive_humanoid_xml() == path and Path(path).parent == tmj.BUILD_DIR
    jpath = jmj.deceptive_humanoid_xml()
    try:
        assert Path(path).read_text() == Path(jpath).read_text()
    finally:
        Path(jpath).unlink()


# ----------------------------------------------------------- (b) engine


@pytest.mark.parametrize("bc_mode", ["final_pos", "traj"])
def test_engine_matches_jax_bit_for_bit(bc_mode):
    """Two slots from the same seeds under the same actions (the running
    slots only, as the rollout steps them): obs, rewards, dones and
    final_state bit for bit; 'traj' padded past each episode's end with its
    last position."""
    B, T, L = 2, 50, 40
    kw = dict(batch_size=B, num_threads=2, bc_mode=bc_mode, traj_len=L)
    j, t = jmj.MujocoHostEnv(ENV, **kw), tmj.MujocoHostEnv(ENV, **kw)
    try:
        ts, js = t.action_space, j.action_space
        assert (t.obs_shape, ts.dim, ts.low, ts.high, t.max_episode_steps, t.bc_dim, t.host_obs) == (
            j.obs_shape, js.dim, js.low, js.high, j.max_episode_steps, j.bc_dim, "vector")
        seeds = [11, 12]
        j.reset(seeds=seeds)
        t.reset(seeds=seeds)
        np.testing.assert_array_equal(t.observe(), j.observe())
        rs, done, steps = np.random.RandomState(0), np.zeros(B, bool), 0
        while not done.all() and steps < T:
            idx = np.nonzero(~done)[0]
            a = rs.uniform(-0.4, 0.4, size=(idx.size, 17)).astype(np.float32)
            (jr, jd), (tr, td) = j.step(a, indices=idx), t.step(a, indices=idx)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(t.observe(), j.observe())
            np.testing.assert_array_equal(t.final_state(), j.final_state())
            done[idx] |= td
            steps += 1
        assert done.any()  # the humanoid fell: an episode ended before the last step
        bc = t.final_state()
        if bc_mode == "traj":
            assert bc.shape == (B, 2 * L)
            lens = t._t
            for i in range(B):
                if lens[i] < L:
                    assert np.all(bc[i, lens[i]:L] == bc[i, lens[i] - 1])
                    assert np.all(bc[i, L + lens[i]:] == bc[i, L + lens[i] - 1])
        spawned = t.spawn()
        assert (spawned.env_id, spawned.batch_size, spawned.bc_mode, spawned.traj_len) == (ENV, B, bc_mode, L)
        spawned.close()
    finally:
        _close(j, t)


# ------------------------------------------------------ (c), (d) rollout


def test_forward_teacher_forced_matches_jax():
    """The same engine observations through both packages' population
    forwards, with the obs stats' normalization: actions within rtol 1e-5."""
    B = 4
    env = tmj.MujocoHostEnv(ENV, batch_size=B, num_threads=2)
    try:
        jm, tm = _models(env)
        thetas = _members(jm, B, 0)
        mean, std = _obs_stats(1)
        env.reset(seeds=[1, 2, 3, 4])
        rs = np.random.RandomState(2)
        for _ in range(5):
            obs = env.observe().copy()
            ja = np.asarray(jm.make_batch_act()((jnp.asarray(thetas), JaxCtx(jnp.asarray(mean), jnp.asarray(std),
                                                                                 jnp.asarray(0.0))),
                                                jnp.asarray(obs), jax.random.split(jax.random.PRNGKey(0), B)))
            ta = tm.make_batch_act()((torch.from_numpy(thetas), TorchCtx(torch.from_numpy(mean),
                                                                         torch.from_numpy(std), 0.0)),
                                     torch.from_numpy(obs)).numpy()
            assert ta.shape == (B, 17)
            np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-7)
            env.step(rs.uniform(-0.4, 0.4, size=(B, 17)))
    finally:
        env.close()


@pytest.mark.parametrize("prob", [None, 0.5])
def test_rollout_host_vec_matches_jax(prob):
    """``rollout_host_vec`` whole over 20 steps, a population of eight,
    action noise off, the same rollout seed: equal lengths, the same
    obs-stat mask (so equal counts); returns within rtol 2e-3, BCs within
    1e-3 m, obs sums within 3e-2 of their largest (the module docstring)."""
    B, T = 8, H20
    j, t = (m.MujocoHostEnv(ENV, batch_size=B, num_threads=2) for m in (jmj, tmj))
    try:
        jm, tm = _models(t)
        thetas = _population(jm, B, 3)
        mean, std = _obs_stats(4)
        key = jax.random.PRNGKey(5)
        jr = jrh.rollout_host(j, jm.make_batch_act(), (jnp.asarray(thetas), JaxCtx(jnp.asarray(mean),
                                                                                     jnp.asarray(std),
                                                                                     jnp.asarray(0.0))),
                              key, T, collect_obstat=True, obstat_prob=prob)
        tr = trh.rollout_host(t, tm.make_batch_act(), (torch.from_numpy(thetas), TorchCtx(
            torch.from_numpy(mean), torch.from_numpy(std), 0.0)), _jax_seed(key), T, CPU, collect_obstat=True,
            obstat_prob=prob)
    finally:
        _close(j, t)
    np.testing.assert_array_equal(tr.lengths, np.asarray(jr.lengths))
    assert tr.lengths.min() < T  # an episode ended on the env's own condition
    _allclose(tr.returns, jr.returns, "returns", RTOL20)
    np.testing.assert_allclose(tr.bc, np.asarray(jr.bc), rtol=0, atol=BC20)
    assert tr.ob_count == float(jr.ob_count) > 0
    if prob is None:
        assert tr.ob_count == tr.lengths.sum()
    _allclose(tr.ob_sum, jr.ob_sum, "ob_sum", OB20)
    _allclose(tr.ob_sumsq, jr.ob_sumsq, "ob_sumsq", OB20)
    assert tr.ep_seeds.shape == (B,)


def test_vector_rollout_clamps_to_the_env_cap_and_refuses_image_options():
    """The episode ends at min(timestep_limit, max_episode_steps); the
    dispatcher refuses a trajectory BC or mirrored draws on a vector
    engine."""
    env = tmj.MujocoHostEnv(ENV, batch_size=2, num_threads=1)
    try:
        env.max_episode_steps = 3
        _, tm = _models(env, hidden=(8,))
        thetas = torch.zeros(2, tm.num_params)
        res = trh.rollout_host(env, tm.make_batch_act(), (thetas, None), 1, 50, CPU)
        np.testing.assert_array_equal(res.lengths, [3, 3])
        for kw in ({"collect_bc_traj": True}, {"mirror_pairs": 1}):
            with pytest.raises(ValueError, match="vector engine"):
                trh.rollout_host(env, tm.make_batch_act(), (thetas, None), 1, 5, CPU, **kw)
    finally:
        env.close()


# ----------------------------------------------------------- (g) padding


def test_padded_slots_stay_out_of_the_obs_moments():
    """``obstat_valid`` takes the padded copies out after the Bernoulli
    draw (the other draws unchanged), and ES's round on more slots than
    members counts the real members' steps only."""
    B = 4
    env = tmj.MujocoHostEnv(ENV, batch_size=B, num_threads=2)
    try:
        _, tm = _models(env, hidden=(8,))
        thetas = torch.from_numpy(np.random.RandomState(0).randn(B, tm.num_params).astype(np.float32) * 0.1)
        act = tm.make_batch_act()
        full = trh.rollout_host_vec(env, act, (thetas, None), 9, 20, CPU, collect_obstat=True)
        valid = np.array([True, True, False, False])
        part = trh.rollout_host_vec(env, act, (thetas, None), 9, 20, CPU, collect_obstat=True, obstat_valid=valid)
        np.testing.assert_array_equal(part.lengths, full.lengths)  # the same episodes
        assert part.ob_count == full.lengths[:2].sum() < full.ob_count
        # the Bernoulli draws come first (the episode seeds after them): with
        # p = 0.5 the mask is the draw ANDed with valid
        rng = np.random.default_rng(9)
        mask = rng.random(B) < 0.5
        drawn = trh.rollout_host_vec(env, act, (thetas, None), 9, 20, CPU, collect_obstat=True, obstat_prob=0.5,
                                     obstat_valid=valid)
        np.testing.assert_array_equal(drawn.ep_seeds, rng.integers(0, 2**31 - 1, size=B))
        assert (mask & valid).any() and drawn.ob_count == drawn.lengths[mask & valid].sum()
    finally:
        env.close()
    env = tmj.MujocoHostEnv(ENV, batch_size=8, num_threads=2)
    _, tm = _models(env, hidden=(8,))
    tr = tes.ESTrainer(env, tm, tes.ESConfig(population_size=4, episode_cutoff_mode=15, calc_obstat_prob=1.0,
                                             num_eval_episodes=0),
                       noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), device="cpu")
    eps = float(tr.ob_stat.count)
    try:
        st = tr.train_step()
    finally:
        tr.close()
    assert st.lengths.shape == (2, 2)
    assert float(tr.ob_stat.count) == pytest.approx(eps + st.lengths.sum(), abs=1e-4)  # 4 real members of 8 slots


# ------------------------------------------------------ (e) ES generation


def _cut_humanoid(obstat_prob: float = 0.5) -> dict:
    """humanoid.json cut to a CPU size: cutoff 15, action noise off (the
    JAX package's per-slot keys cannot be reproduced), calc_obstat_prob 0.5
    (the file's 0.01 samples no rollout of a handful)."""
    exp = _exp("humanoid.json")
    exp["config"] = {**exp["config"], "episode_cutoff_mode": H15, "calc_obstat_prob": obstat_prob}
    exp["policy"] = {**exp["policy"], "args": {**exp["policy"]["args"], "ac_noise_std": 0.0}}
    return exp


CUT = {"episodes_per_batch": 8, "timesteps_per_batch": 150, "num_eval_episodes": 2, "noise_size": COUNT,
       "env_kwargs": {"batch_size": 4, "num_threads": 2}}


def _feed_jax_batches(tr, theta, table, keys, npairs: int) -> list:
    """Each round's offsets as the JAX package draws them from its round
    key, and its θ ± σε batch (``_make_antithetic``), fed to the port's
    trainer in place of its own. XLA fuses θ + σε into one FMA, so the
    port's batch differs in ~3% of its entries by the rounding of σε (held
    here to one ulp of the larger of |θ ± σε| and |σε|); the humanoid turns such a difference into returns 0.4%
    apart within 30 steps, so the rollouts are compared on the JAX
    batch. Returns the draws."""
    from deep_neuroevolution_tpu.algos.es import _make_antithetic

    draws, batches = [], {}
    for k in keys:
        idxs, jth = _make_antithetic(jnp.asarray(theta), table, k, npairs, jnp.asarray(0.02, jnp.float32))
        idxs = np.asarray(idxs)
        draws.append((torch.from_numpy(idxs.copy()), _jax_seed(k)))
        batches[idxs.tobytes()] = np.asarray(jth)
    own = tr._perturbed

    def perturbed(idxs):
        jth = batches[idxs.numpy().astype(np.int32).tobytes()]
        ulp = np.spacing(np.maximum(np.abs(jth), np.abs(jth - theta[None])).astype(np.float32))
        assert np.all(np.abs(own(idxs).numpy() - jth) <= ulp)
        return torch.from_numpy(jth.copy())

    tr._perturbed = perturbed
    queue = list(draws)
    tr._draw_round = lambda n: queue.pop(0)
    return draws


def test_humanoid_es_generation_matches_jax(quiet_loggers):
    """One quota-mode generation of the cut humanoid.json, both packages'
    loaders, the JAX draws and θ ± σε batches fed in (three rounds of 2
    pairs: 8 episodes, then 150 steps): equal lengths and counts; returns
    and eval returns within rtol 1e-4, the obs stat's sums within 2e-3 of
    their largest; the ranks equal; g within 1e-5·max|g| (K2's plain version); θ'
    within 1e-6 where Adam's first step is steady (tests/test_torch_es.py);
    the tabular rows (exact, the return and norm metrics within 1e-4)."""
    exp = _cut_humanoid()
    jtr = jconfig.load_experiment(exp, overrides=CUT, seed=0)
    assert type(jtr.env).__name__ == "MujocoHostEnv"
    theta0, key = np.asarray(jtr.state.theta), jtr.state.key
    D = jtr.model.num_params
    try:
        jst = jtr.train_step()
    finally:
        jtr.env.close()
    npairs = 2
    key, keval = jax.random.split(key)
    round_keys = []
    for _ in range(jst.returns.shape[0] // npairs):
        key, kround = jax.random.split(key)
        round_keys.append(kround)
    assert len(round_keys) == 3  # the step quota took a round more than the episodes

    ttr = tconfig.load_experiment(exp, overrides=CUT, device="cpu")
    assert isinstance(ttr.env, tmj.MujocoHostEnv) and ttr.model.num_params == D and ttr.quota_mode
    ttr.theta = weights.from_jax(theta0, device="cpu")
    draws = _feed_jax_batches(ttr, theta0, jtr.noise.noise, round_keys, npairs)
    ttr._draw_eval_seed = lambda: _jax_seed(keval)
    try:
        tst = ttr.train_step()
    finally:
        ttr.close()
    np.testing.assert_array_equal(tst.lengths, jst.lengths)
    _allclose(tst.returns, jst.returns, "returns")
    np.testing.assert_array_equal(tst.eval_lengths, np.asarray(jst.eval_lengths))
    _allclose(tst.eval_returns, np.asarray(jst.eval_returns), "eval returns")
    jstat = jtr.state.ob_stat
    assert float(ttr.ob_stat.count) == float(jstat.count) > 1  # rollouts were sampled
    _allclose(ttr.ob_stat.sum.numpy(), jstat.sum, "ob_stat.sum", OB15)
    _allclose(ttr.ob_stat.sumsq.numpy(), jstat.sumsq, "ob_stat.sumsq", OB15)

    idxs = torch.cat([d[0] for d in draws])
    jw = jfit.process_returns(jnp.asarray(jst.returns), jnp.zeros_like(jnp.asarray(jst.returns)), "centered_rank")
    tw = tfit.process_returns(torch.from_numpy(tst.returns), torch.zeros(tst.returns.shape), "centered_rank")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise.noise, jnp.asarray(idxs.numpy()), jw[:, 0] - jw[:, 1],
                                             D)) / jst.returns.size
    tg = tng.noise_gradient(ttr.noise.noise, idxs, (tw[:, 0] - tw[:, 1]).contiguous(), D).numpy() / tst.returns.size
    gmax = np.abs(jg).max()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * gmax)
    lr, eps_ = 0.01, 1e-8 / np.sqrt(1 - 0.999)
    G = -jg + 0.005 * theta0
    steady = lr * eps_ * (1e-5 * gmax) / (np.abs(G) + eps_) ** 2 < 1e-6
    np.testing.assert_allclose(ttr.theta.numpy()[steady], np.asarray(jtr.state.theta)[steady], rtol=0, atol=1e-6)
    assert steady.mean() > 0.99

    (jrow,), (trow,) = quiet_loggers["jax"], quiet_loggers["torch"]
    for name in ("EpisodesThisIter", "TimestepsThisIter", "EpLenMean", "ObCount", "EvalEpCount", "EvalEpLenMean",
                 "TimestepLimitPerEpisode", "EvalPopRank"):
        assert float(trow[name]) == float(jrow[name]), name
    for name in ("EpRewMean", "EpRewStd", "EvalEpRewMean", "Norm", "GradNorm", "UpdateRatio"):
        assert float(trow[name]) == pytest.approx(float(jrow[name]), rel=1e-4), name


# ----------------------------------------------------- (f) NS-ES iteration


def test_humanoid_nses_iteration_matches_jax(quiet_loggers):
    """One iteration of humanoid_nses.json cut (HumanoidTrap, 'final_pos'
    BC, population 8 on 8 slots, M = 3, k = 10, novelty_prob, cutoff 15,
    calc_obstat_prob 0.5, action noise off), the JAX parents, archive,
    draws and θ ± σε batch fed in: the rollouts' lengths equal, their
    returns, BCs and obs sums as in the module docstring, their novelty
    within 1e-4 m, the ranks equal, g and θ' as in the ES test. The
    archive's new point is the updated parent's mean BC: the JAX package's
    mean BC of the port's updated parent and obs stat, within 1e-4 m. The
    next parent is novelty_prob's draw from the iteration's probabilities."""
    exp = _exp("humanoid_nses.json")
    exp["config"] = {**exp["config"], "episode_cutoff_mode": H15, "calc_obstat_prob": 0.5}
    exp["policy"] = {**exp["policy"], "args": {**exp["policy"]["args"], "ac_noise_std": 0.0}}
    ov = {"noise_size": COUNT, "env_kwargs": {"batch_size": 8, "num_threads": 2}}
    jtr = jconfig.load_experiment({**exp, "config": {**exp["config"], "episodes_per_batch": 8}}, overrides=ov, seed=3)
    # the JAX package's loader leaves calc_obstat_prob out of NSESConfig (the port's reads it)
    assert jtr.config.calc_obstat_prob == 0.0
    jtr.config = dataclasses.replace(jtr.config, calc_obstat_prob=0.5)
    key, thetas = jtr.key, [np.asarray(p.theta) for p in jtr.parents]
    archive = jtr.archive
    D = jtr.model.num_params
    try:
        jres = jtr.train_step()
    finally:
        jtr.env.close()
    keys = []
    for _ in range(6):  # the round, the new mean BC, three selection BCs, the choice
        key, k = jax.random.split(key)
        keys.append(k)

    ttr = tconfig.load_experiment(exp, overrides={**ov, "population_size": 8}, device="cpu")
    try:
        assert isinstance(ttr, tnses.NSESTrainer) and ttr.config.bc_mode == "final" and ttr.env.bc_dim == 2
        assert ttr.config.calc_obstat_prob == 0.5
        assert "humanoid_trap" in ttr.env.xml_file and ttr._npairs_round() == 4
        ttr.parents = [tnses.Parent(weights.from_jax(th, device="cpu"), ttr.optimizer.init(D, CPU),
                                    tobstat.init(ttr.env.obs_shape, eps=1e-2, device=CPU)) for th in thetas]
        ttr.archive = tnov.Archive(torch.from_numpy(np.array(archive.points)),
                                   torch.tensor(int(archive.count), dtype=torch.int32))
        ttr.curr_parent = 0
        (draw,) = _feed_jax_batches(ttr, thetas[0], jtr.noise.noise, keys[:1], 4)
        seeds = [_jax_seed(k) for k in keys[1:]]
        ttr._draw_seed = lambda: seeds.pop(0)
        tst = ttr.train_step()
    finally:
        ttr.close()
    np.testing.assert_array_equal(tst.lengths, jres["lengths"])
    _allclose(tst.returns, jres["returns"], "returns")
    np.testing.assert_allclose(tst.novelty, jres["novelty"], rtol=0, atol=BC15)
    assert tst.bc.shape == (4, 2, 2) and tst.novelty.dtype == np.float32
    jstat, tstat = jtr.parents[0].ob_stat, ttr.parents[0].ob_stat
    assert float(tstat.count) == float(jstat.count) > 1
    _allclose(tstat.sum.numpy(), jstat.sum, "parent ob_stat.sum", OB15)
    _allclose(tstat.sumsq.numpy(), jstat.sumsq, "parent ob_stat.sumsq", OB15)

    # the update: centered_rank of the returns (the file's mode), novelty in the sign returns' slot
    jproc = jfit.process_returns(jnp.asarray(jres["returns"]), jnp.asarray(jres["novelty"]), "centered_rank")
    tproc = ttr._process_returns(torch.from_numpy(tst.returns), torch.from_numpy(tst.novelty))
    np.testing.assert_array_equal(tproc.numpy(), np.asarray(jproc))
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise.noise, jnp.asarray(draw[0].numpy()),
                                             jproc[:, 0] - jproc[:, 1], D)) / jres["returns"].size
    gmax = np.abs(jg).max()
    np.testing.assert_allclose(tst.g.numpy(), jg, rtol=0, atol=1e-5 * gmax)
    eps_ = 1e-8 / np.sqrt(1 - 0.999)
    steady = 0.01 * eps_ * (1e-5 * gmax) / (np.abs(-jg + 0.005 * thetas[0]) + eps_) ** 2 < 1e-6
    ttheta = ttr.parents[0].theta.numpy()
    np.testing.assert_allclose(ttheta[steady], np.asarray(jtr.parents[0].theta)[steady], rtol=0, atol=1e-6)

    # the archive's new point: the JAX package's mean BC of the port's parent
    jenv = jmj.MujocoHostEnv(ENV, batch_size=8, num_threads=2, xml_file=ttr.env.xml_file)
    jtr.env = jenv
    try:
        jctx = JaxCtx(*(jnp.asarray(x) for x in (jobstat.mean(jobstat.RunningStat(
            *(jnp.asarray(v.numpy()) for v in tstat))), jobstat.std(jobstat.RunningStat(
                *(jnp.asarray(v.numpy()) for v in tstat))))), jnp.asarray(0.0))
        jnew = np.asarray(jtr._host_mean_bc(jnp.asarray(ttheta), keys[1], jctx))
    finally:
        jenv.close()
    np.testing.assert_allclose(tst.new_bc, jnew, rtol=0, atol=BC15)
    assert int(ttr.archive.count) == 4
    np.testing.assert_array_equal(ttr.archive.points[:3].numpy(), np.asarray(archive.points[:3]))
    np.testing.assert_array_equal(ttr.archive.points[3].numpy(), tst.new_bc)
    probs = tst.selection_probs
    assert probs.shape == (3,) and probs.sum() == pytest.approx(1.0)
    assert ttr.curr_parent == int(np.random.default_rng(_jax_seed(keys[5])).choice(3, p=probs))
    (jrow,), (trow,) = quiet_loggers["jax"], quiet_loggers["torch"]
    for name in ("ParentId", "EpisodesThisIter", "TimestepsThisIter", "EpLenMean", "ArchiveSize", "ObCount"):
        assert float(trow[name]) == float(jrow[name]), name


# ------------------------------------------------------- (i) the loader


HOST_CUT = {"episode_cutoff_mode": 20, "env_kwargs": {"batch_size": 8}}


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configurations").glob("*.json")))
def test_every_configuration_loads(name, quiet_loggers):
    """All 16 files load on the CPU, the GPU-stack Atari files on game
    'toy' (the engine has no ALE), with a table of 2M floats (5M for the
    two LargeDQN files), the Atari engine on 8 slots; the humanoid files
    as they stand (64 MuJoCo slots, the env's 1000-step cap)."""
    exp = _exp(name)
    overrides = {"noise_size": 5_000_000 if "Large" in exp.get("model", "") else COUNT}
    if "game" in exp:
        overrides["game"] = "toy"
    if name.startswith(("frostbite", "es_toy", "ga_toy", "es_atari", "ga_atari", "rs_atari")):
        overrides.update(HOST_CUT)
    tr = tconfig.load_experiment(exp, overrides=overrides, device="cpu")
    try:
        if name.startswith("humanoid"):
            assert isinstance(tr.env, tmj.MujocoHostEnv) and tr.env.batch_size == 64
            assert tr.model.num_params == 159_505 and tr.cutoff.tslimit == 1000
            assert tr.model.needs_ob_stat and tr.ob_stat.sum.shape == (348,)
            if name == "humanoid.json":
                assert tr.quota_mode and tr.config.num_eval_episodes == 30 and tr._npairs_round() == 32
                assert tr.config.calc_obstat_prob == 0.01
            else:
                assert isinstance(tr, tnses.NSESTrainer) and tr.config.bc_mode == "final"
                assert tr._archive_size() == 3 and "humanoid_trap" in tr.env.xml_file
    finally:
        tr.close()


def test_loader_refuses_a_trajectory_bc_on_a_vector_engine():
    """'traj' is the Atari RAM trajectory: refused on the MuJoCo engine,
    as the JAX package's nses.py:205-208 asserts."""
    with pytest.raises(ValueError, match="Atari host engines only"):
        tconfig.load_experiment(_exp("humanoid_nses.json"), overrides={
            "noise_size": COUNT, "bc_mode": "traj", "env_kwargs": {"batch_size": 2, "num_threads": 1}}, device="cpu")


def test_cli_trains_both_humanoid_files_on_the_cpu(quiet_loggers):
    """``main train --device cpu`` runs a cut humanoid.json generation and
    a cut humanoid_nses.json iteration."""
    from deep_neuroevolution_torch import main as cli

    small = {"noise_size": COUNT, "episode_cutoff_mode": 20, "env_kwargs": {"batch_size": 4, "num_threads": 2}}
    es = {**small, "episodes_per_batch": 8, "timesteps_per_batch": 20, "num_eval_episodes": 2}
    for name, ov in (("humanoid.json", es), ("humanoid_nses.json", {**small, "population_size": 4})):
        argv = ["train", "--device", "cpu", "--exp_file", str(ROOT / "configurations" / name), "--iterations", "1",
                "--overrides", json.dumps(ov)]
        assert cli.main(argv) == 0
    es_row, ns_row = quiet_loggers["torch"]
    assert es_row["EpisodesThisIter"] == 8 and es_row["EvalEpCount"] == 2
    assert ns_row["EpisodesThisIter"] == 4 and ns_row["ArchiveSize"] == 4


# ------------------------------------------------- (j) a JAX policy file


def test_jax_humanoid_policy_file_replays_the_same(tmp_path, monkeypatch):
    """A JAX policy file of a humanoid.json MujocoMLP, with its obs stat,
    loads in the port (θ and the stat as in the file) and replays: 4
    noiseless episodes on 2 slots to the env's own end (the humanoid falls
    within 30 steps), the JAX round seeds fed in: equal lengths, returns
    within rtol 1e-2 and the mass-centre BCs within 5e-2 m (the 30-step
    drift of the module docstring), the .npz files with the same keys."""
    env = jmj.MujocoHostEnv(ENV, batch_size=1)
    jm, _ = _models(env, noise=0.01)
    env.close()
    theta = _members(jm, 1, 7)[0]
    mean, std = _obs_stats(8)
    jstat = jobstat.set_from_init(jnp.asarray(mean), jnp.asarray(std), 50.0)
    path = str(tmp_path / "snapshot_iter00001_rew100.pkl")
    jckpt.save_policy_snapshot(path, jm, theta, ob_stat=jstat, extra={"env_id": ENV, "iteration": 1})
    model, ttheta, payload = tckpt.load_policy_snapshot(path, device="cpu")
    assert isinstance(model, TorchMLP) and model.num_params == 159_505 and model.ac_noise_std == 0.01
    np.testing.assert_array_equal(ttheta.numpy(), theta)
    for got, want in zip(payload["ob_stat"], jstat):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(episodes=4, seed=3, env_kwargs={"batch_size": 2, "num_threads": 2})
    jz, tz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j = jviz.replay_snapshot(path, save_frames=jz, **kw)
    key, seeds = jax.random.PRNGKey(3), []
    for _ in range(2):
        key, kround = jax.random.split(key)
        seeds.append(_jax_seed(kround))
    monkeypatch.setattr(tviz, "_draw_seeds", lambda gen, n: seeds[:n])
    t = tviz.replay_snapshot(path, save_frames=tz, device="cpu", **kw)
    assert t["lengths"] == j["lengths"] and len(t["returns"]) == 4
    _allclose(t["returns"], j["returns"], "replay returns", 1e-2)
    jn, tn = np.load(jz), np.load(tz)
    assert sorted(tn.files) == sorted(jn.files) == ["bc_trajectory", "lengths", "returns"]
    assert tn["bc_trajectory"].shape == (4, 2)
    np.testing.assert_allclose(tn["bc_trajectory"], jn["bc_trajectory"], rtol=0, atol=5e-2)


def test_weights_from_jax_carry_a_mujoco_policy_and_its_obs_stat():
    """``weights.from_jax``: a JAX MujocoMLP θ and RunningStat as the port's
    tensors, unchanged; the port's mean and std of them equal the JAX
    package's."""
    env = jmj.MujocoHostEnv(ENV, batch_size=1)
    jm, tm = _models(env)
    env.close()
    theta = _members(jm, 1, 4)[0]
    mean, std = _obs_stats(5)
    jstat = jobstat.increment(jobstat.init((348,), 1e-2), jnp.asarray(mean * 20.0),
                              jnp.asarray((mean * mean + std * std) * 20.0), 20.0)
    t = weights.from_jax(theta, device="cpu")
    st = weights.from_jax(jstat, device="cpu")
    assert t.dtype == torch.float32 and tm.num_params == t.numel() == 159_505
    np.testing.assert_array_equal(t.numpy(), theta)
    assert isinstance(st, tobstat.RunningStat)
    for got, want in zip(st, jstat):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tobstat.mean(st).numpy(), np.asarray(jobstat.mean(jstat)))
    np.testing.assert_allclose(tobstat.std(st).numpy(), np.asarray(jobstat.std(jstat)), rtol=1e-6)


def test_experiment_env_kwargs_reach_the_env():
    """An experiment's own ``env_kwargs`` reach the env, patched by the
    overrides' (the JAX package's config.py:185-187; the port read only the
    overrides' before)."""
    exp = {**_exp("humanoid.json"), "env_kwargs": {"bc_mode": "traj", "traj_len": 7, "num_threads": 1}}
    ov = {"noise_size": COUNT, "num_eval_episodes": 1}
    for env_kwargs, bc_dim in (({"batch_size": 2}, 14), ({"batch_size": 2, "traj_len": 5}, 10)):
        tr = tconfig.load_experiment(exp, overrides={**ov, "env_kwargs": env_kwargs}, device="cpu")
        try:
            assert (tr.env.bc_mode, tr.env.bc_dim, tr.env.batch_size) == ("traj", bc_dim, 2)
        finally:
            tr.close()


def test_ga_runs_on_the_vector_engine(quiet_loggers):
    """``--algo ga`` on humanoid.json (the CPU stack's GA loader): the GA's
    host rounds go through ``rollout_host`` to the vector engine, as the
    JAX package's ``_eval_host`` does; two generations, finite fitness."""
    from deep_neuroevolution_torch.algos import ga as tga

    tr = tconfig.load_experiment(_exp("humanoid.json"), algo="ga", device="cpu", overrides={
        "noise_size": COUNT, "population_size": 6, "episode_cutoff_mode": 10,
        "env_kwargs": {"batch_size": 4, "num_threads": 2}})
    try:
        assert isinstance(tr, tga.GATrainer) and tr.is_host_env
        for _ in range(2):
            st = tr.train_step()
        assert len(st.population) == 6 and all(np.isfinite(o.fitness) for o in st.population)
    finally:
        tr.close()


@pytest.mark.parametrize("mirror", [False, True])
def test_image_rollout_obs_stats_match_jax(mirror):
    """``rollout_host_batch`` with ``collect_obstat``, ``obstat_prob`` 0.5
    and ``obstat_valid`` on ToyCatch (8 slots in two pipeline groups, FIRE
    every step, 30 steps; with ``mirror_pairs`` the mask is drawn after the
    mirrored noops and seeds, as there): the JAX package's lengths and
    returns, its obs-stat count, and its sums of the stacked observations:
    each observation within 1e-6 (the frames' resize, tests/test_torch_es.py),
    so a sum within count·1e-6 and a sum of squares (values in [0, 1])
    within count·2e-6."""
    from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
    from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari

    B, T = 8, 30
    valid = np.arange(B) != 5
    j, t = JaxAtari("toy", batch_size=B, num_threads=2), TorchAtari("toy", batch_size=B, num_threads=2)

    def jfire(params, obs, keys):
        return jnp.ones((obs.shape[0],), jnp.int32)

    def tfire(params, obs):
        return torch.ones(obs.shape[0], dtype=torch.int32)

    tfire.prepare = lambda p: p
    key = jax.random.PRNGKey(11)
    try:
        jr = jrh.rollout_host_batch(j, jfire, None, key, T, collect_obstat=True, obstat_prob=0.5, obstat_valid=valid,
                                    mirror_pairs=mirror)
        tr = trh.rollout_host_batch(t, tfire, (torch.zeros(B, 1), None), _jax_seed(key), T, CPU, collect_obstat=True,
                                    obstat_prob=0.5, obstat_valid=valid, mirror_pairs=B // 2 if mirror else 0)
    finally:
        _close(j, t)
    np.testing.assert_array_equal(tr.lengths, np.asarray(jr.lengths))
    np.testing.assert_array_equal(tr.returns, np.asarray(jr.returns))
    assert tr.ob_count == float(jr.ob_count) > 0 and tr.ob_count < tr.lengths[valid].sum()
    assert tr.ob_sum.shape == (84, 84, 4) and tr.ob_sum.dtype == np.float32
    np.testing.assert_allclose(tr.ob_sum, np.asarray(jr.ob_sum), rtol=0, atol=1e-6 * tr.ob_count)
    np.testing.assert_allclose(tr.ob_sumsq, np.asarray(jr.ob_sumsq), rtol=0, atol=2e-6 * tr.ob_count)


def test_snapshots_carry_the_obs_stat(tmp_path, quiet_loggers):
    """After a cut humanoid.json generation whose obs stat moved: the
    policy file holds it (and the env id), loads back in the port and in
    the JAX package as the same arrays; the trainer snapshot restores it,
    the ES trainer's and each NS-ES parent's."""
    ov = {**CUT, "timesteps_per_batch": 10, "num_eval_episodes": 1}
    tr = tconfig.load_experiment(_cut_humanoid(1.0), overrides=ov, device="cpu")
    try:
        tr.train_step()
        assert float(tr.ob_stat.count) > 1
        path = tckpt.save_policy_snapshot_auto(str(tmp_path), tr, 1)
        tckpt.save_trainer(str(tmp_path / "snapshot.pkl"), tr)
    finally:
        tr.close()
    _, _, payload = tckpt.load_policy_snapshot(path, device="cpu")
    jmodel, jtheta, jpayload = jckpt.load_policy_snapshot(path)
    assert payload["extra"]["env_id"] == ENV and type(jmodel).__name__ == "MujocoMLP"
    np.testing.assert_array_equal(np.asarray(jtheta), tr.theta.numpy())
    for got, jgot, want in zip(payload["ob_stat"], jpayload["ob_stat"], tr.ob_stat):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(np.asarray(jgot), want.numpy())
    fresh = tconfig.load_experiment(_cut_humanoid(1.0), overrides=ov, device="cpu")
    try:
        tckpt.load_trainer(str(tmp_path / "snapshot.pkl"), fresh)
        for got, want in zip(fresh.ob_stat, tr.ob_stat):
            assert torch.equal(got, want)
    finally:
        fresh.close()
    ns_ov = {"noise_size": COUNT, "population_size": 4, "episode_cutoff_mode": 10,
             "env_kwargs": {"batch_size": 4, "num_threads": 2}}
    exp = _exp("humanoid_nses.json")
    exp["config"] = {**exp["config"], "calc_obstat_prob": 1.0}
    ns = tconfig.load_experiment(exp, overrides=ns_ov, device="cpu")
    try:
        ns.train_step()
        tckpt.save_trainer(str(tmp_path / "ns.pkl"), ns)
    finally:
        ns.close()
    assert float(ns.parents[0].ob_stat.count) > 1
    fresh = tconfig.load_experiment(exp, overrides=ns_ov, device="cpu")
    try:
        tckpt.load_trainer(str(tmp_path / "ns.pkl"), fresh)
        for p, q in zip(fresh.parents, ns.parents):
            assert all(torch.equal(a, b) for a, b in zip(p.ob_stat, q.ob_stat))
    finally:
        fresh.close()
