"""Replay in the port against the JAX package, on the CPU: the scan rollout
with per-step trajectories, ``replay_policy``, ``replay_seed_chain`` and
``main replay``.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX package drew: reset states (``rollout_batch_scan``) and each
engine round's host seed (from which both packages draw the noop counts
and the engine's episode seeds). The maze resets every slot alike, so its
replays need nothing fed in. Tolerances, fixed before the comparison:

* ToyCatch (the host engine): returns and lengths equal, the final RAM
  equal (discrete actions from float32 scores in another order; a near
  tie would part them, and none occurs here);
* the scan on CartPole and the maze (60 and 50 steps): lengths, alive
  masks and CartPole's returns equal; observations, behavior and other
  returns within rtol 1e-5 / atol 1e-4, as tests/test_torch_rollout.py;
* the maze's whole 400-step episodes, free-running: returns within rtol
  1e-5, the trajectories within 1e-2 (read: 1.7e-3 at most, where a
  rangefinder's float32 rounding moves a step).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import main as tmain
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch import envs as tenvs
from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.algos import rollout as trollout
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.utils import viz as tviz
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import main as jmain
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import rollout as jrollout
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import checkpoint as jckpt
from deep_neuroevolution_tpu.utils import viz as jviz

CPU = torch.device("cpu")
SLOTS, COUNT = 4, 2_000_000


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_seed(key) -> int:
    """The host RNG seed the JAX package derives from a round key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def _round_seeds(seed: int, rounds: int) -> list:
    """The host seeds of the JAX ``replay_policy``'s rounds."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, kround = jax.random.split(key)
        out.append(_jax_seed(kround))
    return out


def _to_torch_state(tenv, jstate):
    cls = type(tenv.reset(1, torch.Generator(), CPU))
    return cls(*(torch.from_numpy(np.array(f)) for f in jstate))


# --------------------------------------------------------------- the scan

SCAN_CASES = {
    "cartpole": ("gym.CartPole-v1", "SimpleClassifier", dict(obs_dim=4, num_actions=2), 60),
    "maze": ("maze", "ContinuousMLP", dict(obs_dim=11, ac_dim=2), 50),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("save_obs", [False, True])
def test_rollout_batch_scan_against_jax(case, save_obs):
    """B=6 with the JAX reset states; CartPole's episodes end early, so the
    port's stop at "every slot done" and its filled tail are held against
    the JAX scan's remaining steps. The JAX package's jitted scan cannot
    take ``save_obs`` (a traced bool), so that case runs it unjitted."""
    env_id, model_name, kw, T = SCAN_CASES[case]
    jenv, tenv = jenvs.make(env_id), tenvs.make(env_id)
    jm, tm = jmodels.get_model(model_name)(**kw), tmodels.get_model(model_name)(**kw)
    B = 6
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    thetas = np.stack([np.asarray(jm.init_theta(k)) for k in keys])
    thetas += 0.3 * np.random.RandomState(0).randn(*thetas.shape).astype(np.float32)
    jparams = (jnp.asarray(thetas), None)
    if save_obs:  # not among the jit's static arguments (ROADMAP Queue 3): the function unjitted
        jres, jtraj = jrollout.rollout_batch_scan.__wrapped__(jenv, jm.make_batch_act(), jparams, keys, T,
                                                              save_obs=True)
    else:
        jres, jtraj = jrollout.rollout_batch_scan(jenv, jm.make_batch_act(), jparams, keys, T)
    state0 = _to_torch_state(tenv, jax.vmap(jenv.reset)(keys))
    tres, ttraj = trollout.rollout_batch_scan(tenv, tm.make_batch_act(), (weights.from_jax(thetas, device="cpu"), None),
                                              state0, T, save_obs)
    assert len(ttraj) == len(jtraj) == (3 if save_obs else 2)
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_array_equal(ttraj[-1].numpy(), np.asarray(jtraj[-1]))  # alive [T, B]
    for t, j in zip(ttraj[:-1], jtraj[:-1]):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
    np.testing.assert_allclose(tres.returns.numpy(), np.asarray(jres.returns), **tol)
    np.testing.assert_allclose(tres.bc.numpy(), np.asarray(jres.bc), **tol)
    if case == "cartpole":
        np.testing.assert_array_equal(tres.returns.numpy(), np.asarray(jres.returns))
        assert int(tres.lengths.max()) < T  # every slot done before the end: the tail was filled
    assert tuple(ttraj[-1].shape) == (T, B)


# ---------------------------------------------------- replays on the engine


def _vbn_policy(jm, seed):
    theta = np.asarray(jm.init_theta(jax.random.PRNGKey(seed)))
    return theta + 0.05 * np.random.RandomState(seed).randn(jm.num_params).astype(np.float32)


def _feed_seeds(monkeypatch, *draws):
    """The port's host-seed draws (``viz._draw_seeds``) replaced by the
    given lists, one a call."""
    draws = list(draws)
    monkeypatch.setattr(tviz, "_draw_seeds", lambda gen, n: draws.pop(0))


def test_replay_policy_on_toycatch_against_jax(tmp_path, monkeypatch):
    """The VBN-DQN of a policy θ and reference batch on 4 engine slots, 6
    episodes (two rounds), the JAX round seeds fed in: equal returns,
    lengths and final RAM, and .npz files with the same keys."""
    jm, tm = jmodels.get_model("ModelVirtualBN")(num_actions=4), tmodels.VirtualBNDQN(num_actions=4)
    theta = _vbn_policy(jm, 1)
    ref = np.random.RandomState(2).rand(16, 84, 84, 4).astype(np.float32)
    jenv, tenv = JaxAtari("toy", batch_size=SLOTS), TorchAtari("toy", batch_size=SLOTS)
    try:
        jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        j = jviz.replay_policy(jm, jnp.asarray(theta), jenv, episodes=6, save_frames=jpath, seed=5,
                               ref_batch=jnp.asarray(ref))
        _feed_seeds(monkeypatch, _round_seeds(5, 2))
        t = tviz.replay_policy(tm, theta, tenv, episodes=6, save_frames=tpath, seed=5, ref_batch=ref, device="cpu")
    finally:
        tenv.close()
        jenv.close()
    assert t["lengths"] == j["lengths"] and t["returns"] == j["returns"]
    assert t["return_mean"] == pytest.approx(j["return_mean"]) and len(t["returns"]) == 6
    jz, tz = np.load(jpath), np.load(tpath)
    assert sorted(tz.files) == sorted(jz.files) == ["bc_trajectory", "lengths", "returns"]
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k])


@pytest.mark.parametrize("style", ["gpu", "cpu"])
def test_replay_seed_chain_against_jax(style, monkeypatch):
    """A SmallDQN elite rebuilt from its chain (GPU-style (idx, power)
    entries, or CPU-style bare indices with noise_stdev 0.01) on a 2M-float
    table, 4 episodes on ToyCatch with the JAX round seed fed in."""
    chain = [1234, [56789, 0.01], [424242, 0.02]] if style == "gpu" else [1234, 56789, 424242]
    kw = dict(model_kwargs={"num_actions": 4}, genome_style=style, noise_stdev=0.01, episodes=4, seed=9,
              env_kwargs={"batch_size": SLOTS}, return_trajectory=True)
    j = jviz.replay_seed_chain(chain, "GAAtariPolicy", "toy", noise_table=JaxNoise.from_seed(count=COUNT), **kw)
    _feed_seeds(monkeypatch, _round_seeds(9, 1), _round_seeds(9, 1))
    t = tviz.replay_seed_chain(chain, "GAAtariPolicy", "toy", noise_table=TorchNoise.from_seed(count=COUNT),
                               device="cpu", **kw)
    assert t["lengths"] == j["lengths"] and t["returns"] == j["returns"]
    np.testing.assert_array_equal(t["bc_trajectory"], j["bc_trajectory"])
    # the GPU stack's own name of the small DQN: the JAX package resolves
    # "Model" to its abstract base class first (ROADMAP Queue 3); the port
    # to the registry's SmallDQN
    with pytest.raises(TypeError):
        jviz.replay_seed_chain(chain, "Model", "toy", noise_table=JaxNoise.from_seed(count=COUNT), **kw)
    m = tviz.replay_seed_chain(chain, "Model", "toy", noise_table=TorchNoise.from_seed(count=COUNT), device="cpu",
                               **kw)
    assert m["returns"] == t["returns"]


def test_replay_seed_chain_vbn_collects_its_reference_batch(monkeypatch):
    """A VBN-DQN chain: the reference batch from a random policy on the
    engine (the JAX package's ``collect_ref_batch_host`` seed fed in), then
    the replay, on 4 slots."""
    chain = [777, [888, 0.005]]
    kw = dict(model_kwargs={"num_actions": 4}, episodes=4, seed=3, env_kwargs={"batch_size": SLOTS})
    j = jviz.replay_seed_chain(chain, "ModelVirtualBN", "toy", noise_table=JaxNoise.from_seed(count=COUNT), **kw)
    _feed_seeds(monkeypatch, [_jax_seed(jax.random.PRNGKey(3))], _round_seeds(3, 1))
    t = tviz.replay_seed_chain(chain, "ModelVirtualBN", "toy", noise_table=TorchNoise.from_seed(count=COUNT),
                               device="cpu", **kw)
    assert t["lengths"] == j["lengths"] and t["returns"] == j["returns"]


# ------------------------------------------------------------- main replay


def _cli_stats(main, argv, capsys) -> dict:
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_replay_on_the_maze(tmp_path, capsys):
    """``main replay --device cpu`` of a JAX policy file (ContinuousMLP with
    obs stats) on the maze, whole 400-step episodes, against the JAX
    ``main replay``: returns, lengths and the .npz's keys."""
    jm = jmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
    theta = np.asarray(jm.init_theta(jax.random.PRNGKey(0)))
    theta = theta + 0.3 * np.random.RandomState(0).randn(jm.num_params).astype(np.float32)
    rs = np.random.RandomState(1)
    ob = (rs.randn(11).astype(np.float32), (rs.rand(11) + 1).astype(np.float32), np.float32(3.0))
    path = str(tmp_path / "policy.pkl")
    jckpt.save_policy_snapshot(path, jm, jnp.asarray(theta), ob_stat=ob)
    argv = ["replay", "--snapshot", path, "--env", "maze", "--episodes", "2"]
    j = _cli_stats(jmain.main, argv + ["--save_frames", str(tmp_path / "j.npz")], capsys)
    t = _cli_stats(tmain.main, argv + ["--save_frames", str(tmp_path / "t.npz"), "--device", "cpu"], capsys)
    assert t["lengths"] == j["lengths"] == [400, 400]
    np.testing.assert_allclose(t["returns"], j["returns"], rtol=1e-5)
    jz, tz = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(tz.files) == sorted(jz.files)
    assert tz["bc_trajectory"].shape == jz["bc_trajectory"].shape == (400, 2, 2)
    np.testing.assert_allclose(tz["bc_trajectory"], jz["bc_trajectory"], rtol=0, atol=1e-2)


def test_main_replay_on_toycatch(tmp_path, capsys, monkeypatch):
    """A SmallDQN policy file on 4 engine slots, 4 episodes, both CLIs with
    the same seed; the port's round seed is the JAX one (fed in where the
    port draws it)."""
    jm = jmodels.SmallDQN(num_actions=4)
    theta = np.asarray(jm.init_theta(jax.random.PRNGKey(3)))
    path = str(tmp_path / "policy.pkl")
    jckpt.save_policy_snapshot(path, jm, jnp.asarray(theta))
    argv = ["replay", "--snapshot", path, "--env", "toy", "--episodes", "4", "--seed", "11",
            "--env_kwargs", json.dumps({"batch_size": SLOTS})]
    j = _cli_stats(jmain.main, argv, capsys)
    _feed_seeds(monkeypatch, _round_seeds(11, 1))
    t = _cli_stats(tmain.main, argv + ["--device", "cpu"], capsys)
    assert t == j


def test_main_replay_needs_a_policy_and_a_card(tmp_path, capsys, monkeypatch):
    assert tmain.main(["replay", "--device", "cpu"]) == 2
    path = str(tmp_path / "policy.pkl")
    jm = jmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
    jckpt.save_policy_snapshot(path, jm, jnp.zeros(jm.num_params))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain.main(["replay", "--snapshot", path, "--env", "maze"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_vector_engine_replay_is_not_ported():
    """The vector-engine replay this test once saw refused runs since the
    MuJoCo slice (``rollout_host`` → ``rollout_host_vec``; the Humanoid
    replay against the JAX package is in tests/test_torch_mujoco.py): on a
    2-slot engine whose episodes end after 3 + slot steps, 3 episodes take
    two rounds, each slot's BC is its final state, the cap bounds nothing."""

    class VectorEngine:
        is_host_env, host_obs, batch_size, obs_shape = True, "vector", 2, (3,)
        max_episode_steps = default_timestep_cutoff = 50

        def reset(self, indices=None, seeds=None):
            self.t = np.zeros(2, np.int64)

        def step(self, actions, indices):
            assert actions.shape == (len(indices), 1)
            self.t[indices] += 1
            return np.ones(len(indices), np.float32), self.t[indices] >= 3 + np.asarray(indices)

        def observe(self):
            return np.stack([self.t, self.t, self.t], axis=1).astype(np.float32)

        def final_state(self):
            return self.t[:, None].astype(np.float32)

    model = tmodels.ContinuousMLP(obs_dim=3, ac_dim=1)
    out = tviz.replay_policy(model, np.zeros(model.num_params, np.float32), VectorEngine(), episodes=3,
                             return_trajectory=True, device="cpu")
    assert out["lengths"] == [3, 4, 3] and out["returns"] == [3.0, 4.0, 3.0]
    np.testing.assert_array_equal(out["bc_trajectory"], [[3.0], [4.0], [3.0]])
