"""The port's device envs (Hard Maze, CartPole, Pendulum), its MLP policies
and its obs stats against the JAX package's, on the CPU.

Inputs are drawn from a numpy seed and fed to both packages. Tolerances:

* maze: ``observe``, ``step``, ``_collides``, ``_rangefinders`` and
  ``_radar`` on 1024 random states and actions, float32, within atol 1e-5
  (booleans and the step counter exactly; rangefinder distances as the
  observation holds them, divided by their range of 100; state fields
  within atol 1e-5 plus one float32 epsilon of their value, as a
  coordinate past 128 has an ulp of 1.5e-5); a whole 400-step trajectory of
  8 ContinuousMLP members compared teacher-forced: every JAX state is fed
  into the port's ``observe`` and ``step`` and that one step compared, so a
  last-place difference cannot grow into a different episode;
* CartPole and Pendulum: ``step`` within atol 1e-6 (CartPole) and 1e-5
  (Pendulum, whose θ spans ±π), ``done`` exactly;
* models: scores (or actions) within 1e-6·max|score| with equal argmax;
* obs stats: within float32 rounding (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import envs as tenvs
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.envs import maze as tmaze
from deep_neuroevolution_torch.ops import obstat as tobstat
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.envs import maze as jmaze
from deep_neuroevolution_tpu.ops import obstat as jobstat

CPU = torch.device("cpu")
N = 1024


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _maze_states(rs, n=N):
    """Random maze states: positions over the maze's box, any heading,
    speeds and turn rates within their clamps, any step count."""
    return (
        rs.uniform(0.0, 200.0, n).astype(np.float32),
        rs.uniform(0.0, 210.0, n).astype(np.float32),
        rs.uniform(0.0, 360.0, n).astype(np.float32),
        rs.uniform(-3.0, 3.0, n).astype(np.float32),
        rs.uniform(-3.0, 3.0, n).astype(np.float32),
        rs.randint(0, 401, n).astype(np.int32),
    )


def _jax_maze_state(fields):
    return jmaze.MazeState(*(jnp.asarray(f) for f in fields))


def _torch_maze_state(fields):
    return tmaze.MazeState(*(_t(f) for f in fields))


def _close_f32(a, b, what=""):
    """Within atol 1e-5 plus one float32 epsilon of the value: maze
    coordinates past 128 and headings past 256 have an ulp of 1.5e-5 and
    3.1e-5, and sin/cos differ in the last place between the packages."""
    np.testing.assert_allclose(a, b, rtol=2.0**-23, atol=1e-5, err_msg=what)


def _vmap_step(env, state, actions):
    return jax.vmap(lambda s, a: env.step(s, a, None))(state, actions)


# ------------------------------------------------------------------ maze


class TestMazeGolden:
    """tests/test_envs.py's golden cases of the JAX package's maze, on the
    port (B=1 unless said)."""

    def test_parse_equals_the_jax_packages(self):
        assert tmaze.HARD_MAZE_TXT == jmaze.HARD_MAZE_TXT
        ours, theirs = tmaze.parse_maze(tmaze.HARD_MAZE_TXT), jmaze.parse_maze(jmaze.HARD_MAZE_TXT)
        assert ours.keys() == theirs.keys()
        for k in ours:
            if k == "segs":
                assert ours[k].dtype == theirs[k].dtype == np.float32
                np.testing.assert_array_equal(ours[k], theirs[k])
            else:
                assert ours[k] == theirs[k], k
        assert ours["start"] == (36.0, 184.0) and ours["end"] == (31.0, 20.0)
        assert ours["segs"].shape == (13, 4) and ours["steps"] == 400

    def test_everything_is_float32(self):
        """No float64 leaks: the geometry, the state and every output."""
        env = tmaze.MazeEnv()
        assert all(g.dtype == torch.float32 for g in env.geometry(CPU))
        s = env.reset(3, None, CPU)
        assert all(f.dtype == torch.float32 for f in s[:5]) and s.t.dtype == torch.int32
        s2, r, d = env.step(s, torch.full((3, 2), 0.3))
        assert all(f.dtype == torch.float32 for f in s2[:5]) and s2.t.dtype == torch.int32
        assert r.dtype == torch.float32 and d.dtype == torch.bool
        assert env.observe(s2).dtype == torch.float32 and env.behavior(s2).dtype == torch.float32

    def test_point_angle_quadrants(self):
        f = lambda x, y: float(tmaze._point_angle(torch.tensor([x]), torch.tensor([y]))[0])  # noqa: E731
        assert f(0.0, 5.0) == 90.0 and f(0.0, -5.0) == 270.0
        np.testing.assert_allclose([f(1.0, 1.0), f(-1.0, 1.0), f(-1.0, -1.0), f(1.0, -1.0)],
                                   [45.0, 135.0, 225.0, -45.0], rtol=1e-4)  # x > 0, y < 0: raw atan

    def test_initial_observation(self):
        env = tmaze.MazeEnv()
        obs = env.observe(env.reset(1, None, CPU))[0].numpy()
        assert obs.shape == (11,) and obs[0] == 1.0
        assert np.all(obs[1:7] >= 0) and np.all(obs[1:7] <= 1.0)
        np.testing.assert_array_equal(obs[7:], [0, 0, 0, 1])  # goal at ~268°: [225, 315)

    def test_zero_action_stays_put(self):
        env = tmaze.MazeEnv()
        s = env.reset(1, None, CPU)
        for _ in range(5):
            s, r, d = env.step(s, torch.zeros(1, 2))
        assert float(s.x[0]) == 36.0 and float(s.y[0]) == 184.0
        assert float(r[0]) == 0.0 and not bool(d[0])

    def test_episode_end_reward_is_neg_distance(self):
        env = tmaze.MazeEnv()
        s = env.reset(1, None, CPU)
        for _ in range(tmaze.EPISODE_STEPS):
            s, r, d = env.step(s, torch.zeros(1, 2))
        assert bool(d[0])
        np.testing.assert_allclose(float(r[0]), -float(env.distance_to_target(s)[0]), rtol=1e-5)
        np.testing.assert_allclose(-float(r[0]), np.hypot(36 - 31, 184 - 20), rtol=1e-5)

    def test_wall_collision_blocks(self):
        env = tmaze.MazeEnv()
        s = env.reset(1, None, CPU)
        for _ in range(100):
            s, _, _ = env.step(s, torch.tensor([[0.0, 0.5]]))
        assert float(s.x[0]) < 195.0  # the outer wall, radius 8

    def test_speed_and_turn_limits(self):
        env = tmaze.MazeEnv()
        s = env.reset(1, None, CPU)
        for _ in range(50):
            s, _, _ = env.step(s, torch.tensor([[0.5, 0.5]]))
        assert abs(float(s.speed[0])) <= 3.0 and abs(float(s.ang_vel[0])) <= 3.0
        assert 0.0 <= float(s.heading[0]) <= 360.0

    def test_behavior_is_position(self):
        env = tmaze.MazeEnv()
        np.testing.assert_array_equal(env.behavior(env.reset(2, None, CPU)).numpy(), [[36.0, 184.0]] * 2)


class TestMazeAgainstJax:
    """1024 random states and actions through both packages, atol 1e-5."""

    def setup_method(self):
        rs = np.random.RandomState(0)
        self.fields = _maze_states(rs)
        self.actions = rs.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
        self.jenv, self.tenv = jmaze.MazeEnv(), tmaze.MazeEnv()
        self.js, self.ts = _jax_maze_state(self.fields), _torch_maze_state(self.fields)

    def test_observe(self):
        j = _np(jax.vmap(self.jenv.observe)(self.js))
        t = self.tenv.observe(self.ts).numpy()
        assert t.shape == (N, 11)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)

    def test_rangefinders_and_radar(self):
        # compared as they enter the observation, divided by their range (100):
        # raw distances to 100 differ by up to 4 float32 ulps (3.05e-5 at 64)
        j = _np(jax.vmap(self.jenv._rangefinders)(self.js))
        t = self.tenv._rangefinders(self.ts).numpy()
        np.testing.assert_allclose(t / tmaze.RANGEFINDER_RANGE, j / jmaze.RANGEFINDER_RANGE, rtol=0, atol=1e-5)
        assert (j < 100.0).any() and (j == 100.0).any()  # hits and misses both
        j = _np(jax.vmap(self.jenv._radar)(self.js))
        np.testing.assert_array_equal(self.tenv._radar(self.ts).numpy(), j)
        assert (j.sum(0) > 0).all()  # every quadrant fires somewhere

    def test_collides(self):
        x, y = self.fields[0], self.fields[1]
        j = _np(jax.vmap(self.jenv._collides)(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_array_equal(self.tenv._collides(_t(x), _t(y)).numpy(), j)
        assert 0 < j.sum() < N

    def test_step(self):
        js2, jr, jd = _vmap_step(self.jenv, self.js, jnp.asarray(self.actions))
        ts2, tr, td = self.tenv.step(self.ts, _t(self.actions))
        for name, a, b in zip(tmaze.MazeState._fields, ts2, js2):
            if name == "t":
                np.testing.assert_array_equal(a.numpy(), _np(b))
            else:
                _close_f32(a.numpy(), _np(b), name)
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=0, atol=1e-5)
        assert _np(jd).any() and (_np(jr) < 0).any()
        blocked = (_np(js2.x) == self.fields[0]) & (np.abs(self.fields[3]) > 0.5)
        assert blocked.any()  # some moves undone by a wall
        _close_f32(self.tenv.behavior(ts2).numpy(), _np(jax.vmap(self.jenv.behavior)(js2)))

    def test_teacher_forced_trajectory(self):
        """8 ContinuousMLP members over a whole episode on the JAX package;
        at each of the 400 steps the port takes the JAX state and obs: its
        actions, next state, reward and done must match that step's."""
        B = 8
        jm = jmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
        tm = tmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
        thetas = np.stack([np.asarray(jm.init_theta(k)) for k in jax.random.split(jax.random.PRNGKey(1), B)])
        thetas[:, -2:] = np.random.RandomState(2).uniform(-2, 2, (B, 2))  # out/b: turn and move
        jparts = jax.vmap(jm.unflatten)(jnp.asarray(thetas))
        tparts = tm.unflatten(weights.from_jax(thetas, device="cpu"))
        jact = jax.jit(jax.vmap(lambda p, o: jm.act_parts(p, o)))
        jstep = jax.jit(lambda s, a: _vmap_step(self.jenv, s, a))
        jobs = jax.jit(jax.vmap(self.jenv.observe))
        js = jax.vmap(self.jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
        moved = 0
        for step in range(jmaze.EPISODE_STEPS):
            ts = tmaze.MazeState(*(_t(f) for f in js))
            obs_j = jobs(js)
            np.testing.assert_allclose(self.tenv.observe(ts).numpy(), _np(obs_j), rtol=0, atol=1e-5)
            a_j = jact(jparts, obs_j)
            a_t = tm.batch_act_parts(tparts, _t(obs_j))
            np.testing.assert_allclose(a_t.numpy(), _np(a_j), rtol=0, atol=1e-6)
            js2, jr, jd = jstep(js, a_j)
            ts2, tr, td = self.tenv.step(ts, _t(a_j))
            for name, a, b in zip(tmaze.MazeState._fields, ts2, js2):
                _close_f32(a.numpy(), _np(b), f"{name} at step {step}")
            np.testing.assert_array_equal(td.numpy(), _np(jd))
            np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=0, atol=1e-5)
            moved += int((_np(js2.x) != _np(js.x)).sum())
            js = js2
        assert bool(_np(jd).all()) and moved > 0
        print(f"final distances {-_np(jr)}")


# ------------------------------------------------------- classic control


def test_cartpole_step_against_jax():
    rs = np.random.RandomState(3)
    lim = np.array([3.0, 3.0, 0.3, 3.0], np.float32)
    v = (rs.uniform(-1, 1, (N, 4)) * lim).astype(np.float32)
    latched = rs.rand(N) < 0.1
    actions = rs.randint(0, 2, N).astype(np.int32)
    jenv, tenv = jenvs.CartPoleEnv(), tenvs.CartPoleEnv()
    from deep_neuroevolution_tpu.envs.cartpole import CartPoleState as JS
    from deep_neuroevolution_torch.envs.cartpole import CartPoleState as TS

    js = JS(*(jnp.asarray(v[:, i]) for i in range(4)), jnp.asarray(latched))
    ts = TS(*(_t(v[:, i]) for i in range(4)), _t(latched))
    js2, jr, jd = _vmap_step(jenv, js, jnp.asarray(actions))
    ts2, tr, td = tenv.step(ts, _t(actions).long())
    for name, a, b in zip(TS._fields[:4], ts2, js2):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_array_equal(ts2.done.numpy(), _np(js2.done))
    np.testing.assert_array_equal(tr.numpy(), np.ones(N, np.float32))  # the terminal step pays too
    assert 0 < _np(jd).sum() < N and (td[torch.from_numpy(latched)]).all()
    np.testing.assert_allclose(tenv.observe(ts2).numpy(), _np(jax.vmap(jenv.observe)(js2)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tenv.behavior(ts).numpy(), _np(jax.vmap(jenv.behavior)(js)))
    assert tenvs.make("gym.CartPole-v0").default_timestep_cutoff == jenvs.make("gym.CartPole-v0").default_timestep_cutoff


def test_cartpole_reset_draws_in_range():
    s = tenvs.CartPoleEnv().reset(4096, torch.Generator().manual_seed(0), CPU)
    v = torch.stack(s[:4])
    assert v.dtype == torch.float32 and float(v.min()) >= -0.05 and float(v.max()) < 0.05
    assert not bool(s.done.any())


def test_pendulum_step_against_jax():
    rs = np.random.RandomState(4)
    theta = rs.uniform(-7, 7, N).astype(np.float32)
    dot = rs.uniform(-8, 8, N).astype(np.float32)
    t = rs.randint(0, 201, N).astype(np.int32)
    u = rs.uniform(-3, 3, (N, 1)).astype(np.float32)
    from deep_neuroevolution_tpu.envs.pendulum import PendulumState as JS
    from deep_neuroevolution_torch.envs.pendulum import PendulumState as TS

    jenv, tenv = jenvs.PendulumEnv(), tenvs.PendulumEnv()
    js, ts = JS(jnp.asarray(theta), jnp.asarray(dot), jnp.asarray(t)), TS(_t(theta), _t(dot), _t(t))
    js2, jr, jd = _vmap_step(jenv, js, jnp.asarray(u))
    ts2, tr, td = tenv.step(ts, _t(u))
    np.testing.assert_allclose(ts2.theta.numpy(), _np(js2.theta), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts2.theta_dot.numpy(), _np(js2.theta_dot), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts2.t.numpy(), _np(js2.t))
    np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    assert _np(jd).any() and not _np(jd).all()
    np.testing.assert_allclose(tenv.observe(ts2).numpy(), _np(jax.vmap(jenv.observe)(js2)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tenv.behavior(ts2).numpy(), _np(jax.vmap(jenv.behavior)(js2)), rtol=0, atol=1e-5)
    from deep_neuroevolution_tpu.envs.pendulum import _angle_normalize as jnorm
    from deep_neuroevolution_torch.envs.pendulum import _angle_normalize as tnorm

    np.testing.assert_allclose(tnorm(_t(theta)).numpy(), _np(jnorm(jnp.asarray(theta))), rtol=0, atol=1e-6)


def test_make_resolves_like_the_jax_package():
    import dataclasses

    for name in ("maze", "gym.CartPole-v1", "CartPole-v1", "gym.Pendulum-v1"):
        t, j = tenvs.make(name), jenvs.make(name)
        assert type(t.action_space).__name__ == type(j.action_space).__name__, name
        assert (t.obs_shape, dataclasses.astuple(t.action_space), t.default_timestep_cutoff, t.bc_dim,
                t.discrete_action) == (tuple(j.obs_shape), dataclasses.astuple(j.action_space),
                                       j.default_timestep_cutoff, j.bc_dim, j.discrete_action), name
    with pytest.raises(ValueError, match="unknown gym env"):
        tenvs.make("gym.NoSuchEnv-v0")
    with pytest.raises(NotImplementedError, match="no ALE"):
        tenvs.make("frostbite")


# ---------------------------------------------------------------- models


def _members(jm, B, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    thetas = np.stack([np.asarray(jm.init_theta(k)) for k in keys])
    # non-zero biases, so that every term of each layer counts
    return thetas + np.random.RandomState(seed).normal(0, 0.1, thetas.shape).astype(np.float32)


MODELS = [
    ("LinearClassifier", dict(obs_dim=4, num_actions=2), 4),
    ("SimpleClassifier", dict(obs_dim=4, num_actions=2), 4),
    ("SimpleClassifier", dict(obs_dim=11, num_actions=5, nonlin_type="elu"), 11),
    ("SimpleClassifier", dict(obs_dim=11, num_actions=5, nonlin_type="lrelu"), 11),
    ("ContinuousMLP", dict(obs_dim=11, ac_dim=2), 11),
    ("ContinuousMLP", dict(obs_dim=11, ac_dim=2, hidden=32, nonlin_type="relu"), 11),
]


@pytest.mark.parametrize("name,kw,obs_dim", MODELS, ids=[f"{m[0]}-{i}" for i, m in enumerate(MODELS)])
def test_simple_models_against_jax(name, kw, obs_dim):
    """Same θ, same observations: scores (classifiers) within 1e-6·max with
    equal argmax, or actions (ContinuousMLP) within 1e-6."""
    B = 16
    jm, tm = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    assert tm.num_params == jm.num_params
    assert [(s.name, tuple(s.shape), s.init, s.std) for s in tm.specs] == [
        (s.name, tuple(s.shape), s.init, s.std) for s in jm.specs]
    thetas = _members(jm, B, 5)
    obs = np.random.RandomState(6).normal(0, 2, (B, obs_dim)).astype(np.float32)
    jparts = jax.vmap(jm.unflatten)(jnp.asarray(thetas))
    tparts = tm.unflatten(weights.from_jax(thetas, device="cpu"))
    ja = _np(jax.vmap(lambda p, o: jm.act_parts(p, o))(jparts, jnp.asarray(obs)))
    ta = tm.batch_act_parts(tparts, _t(obs)).numpy()
    if name == "ContinuousMLP":
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6)
        return
    np.testing.assert_array_equal(ta, ja)
    from deep_neuroevolution_tpu.models.core import dense

    def jscores(p, o):
        if name == "LinearClassifier":
            return dense(p, "out", o)
        nl = jmodels.NONLINS[jm.nonlin_type]
        return dense(p, "out", nl(dense(p, "fc2", nl(dense(p, "fc1", o)))))

    js = _np(jax.vmap(jscores)(jparts, jnp.asarray(obs)))
    ts = tm.batch_scores_parts(tparts, _t(obs)).numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6 * np.abs(js).max())


@pytest.mark.parametrize("bins", ["continuous:", "uniform:5", "custom:-1,-0.3,0,0.5,1"])
def test_mujoco_mlp_against_jax(bins):
    """Every action head, observations normalized by a context: actions
    within 1e-6·max (continuous) or equal (binned); and action noise from a
    generator, shared by a paired batch's halves."""
    B, obs_dim, ac_dim = 16, 5, 3
    kw = dict(obs_dim=obs_dim, ac_dim=ac_dim, ac_low=(-2.0, -1.0, 0.0), ac_high=(2.0, 1.0, 3.0), ac_bins=bins,
              hidden_dims=(16, 8))
    jm, tm = jmodels.MujocoMLP(**kw), tmodels.MujocoMLP(**kw)
    assert tm.num_params == jm.num_params
    thetas = _members(jm, B, 7)
    rs = np.random.RandomState(8)
    obs = rs.normal(1.0, 3.0, (B, obs_dim)).astype(np.float32)
    mean, std = rs.normal(0, 1, obs_dim).astype(np.float32), rs.uniform(0.5, 2, obs_dim).astype(np.float32)
    jctx = jmodels.MLPContext(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(0.0, jnp.float32))
    tctx = tmodels.MLPContext(_t(mean), _t(std), 0.0)
    jparts = jax.vmap(jm.unflatten)(jnp.asarray(thetas))
    tparts = tm.unflatten(weights.from_jax(thetas, device="cpu"))
    ja = _np(jax.vmap(lambda p, o: jm.act_parts(p, o, jax.random.PRNGKey(0), jctx))(jparts, jnp.asarray(obs)))
    ta = tm.batch_act_parts(tparts, _t(obs), tctx).numpy()
    assert ta.shape == (B, ac_dim) and ta.dtype == np.float32
    if bins == "continuous:":
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6 * np.abs(ja).max())
    else:
        np.testing.assert_array_equal(ta, ja)
        assert len(np.unique(ta)) > 2
    # noise: N(0, 1)·ac_noise_std from the context's generator, the halves alike when paired
    noisy = tctx._replace(noise_scale=1.0, gen=torch.Generator().manual_seed(3), paired=True)
    tn = tm.batch_act_parts(tparts, _t(obs), noisy).numpy()
    z = (tn - ta) / tm.ac_noise_std
    np.testing.assert_allclose(z[: B // 2], z[B // 2:], rtol=0, atol=1e-3)
    z0 = torch.randn((B // 2, ac_dim), generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_allclose(z[: B // 2], z0, rtol=0, atol=1e-3)


def test_registry_names():
    for name in ("LinearClassifier", "SimpleClassifier", "ContinuousMLP", "MujocoPolicy"):
        assert tmodels.get_model(name).__name__ == jmodels.get_model(name).__name__
    assert not tmodels.ContinuousMLP(obs_dim=11, ac_dim=2).needs_ob_stat
    assert tmodels.MujocoMLP(obs_dim=3, ac_dim=1).needs_ob_stat


# ------------------------------------------------------------- obs stats


def test_obstat_against_jax():
    rs = np.random.RandomState(9)
    s, ssq = rs.normal(0, 5, 7).astype(np.float32), rs.uniform(0, 50, 7).astype(np.float32)
    j = jobstat.increment(jobstat.init((7,), 1e-2), jnp.asarray(s), jnp.asarray(ssq), 12.0)
    t = tobstat.increment(tobstat.init((7,), 1e-2), _t(s), _t(ssq), 12.0)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
    np.testing.assert_allclose(tobstat.mean(t).numpy(), _np(jobstat.mean(j)), rtol=1e-6)
    np.testing.assert_allclose(tobstat.std(t).numpy(), _np(jobstat.std(j)), rtol=1e-6)
    assert (tobstat.std(t).numpy() >= 0.1 - 1e-7).all()
    ji = jobstat.set_from_init(s, ssq, 5.0)
    ti = tobstat.set_from_init(s, ssq, 5.0)
    for a, b in zip(ti, ji):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
    moved = weights.from_jax(j, device="cpu")
    assert isinstance(moved, tobstat.RunningStat)
    for a, b in zip(moved, j):
        np.testing.assert_array_equal(a.numpy(), _np(b))
