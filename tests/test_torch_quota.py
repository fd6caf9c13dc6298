"""ES's quota mode, mirrored pairs (``mirror_crn``), ``eval_batch`` and
``grad_chunk`` in the port against the JAX package's, on the CPU.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX trainer drew: the initial θ, each round's noise offsets and rollout
seed (host engine) or reset states (device env), and the eval episodes'.
The JAX package's host round fails where it has fewer pairs than half the
engine's slots, so its comparisons run at 2·pairs = slots; the port's
padded rounds are checked on their own. Tolerances, fixed before the
comparison: returns, lengths and round counts exactly; g within
1e-5·max|g|; θ' by tests/test_torch_es.py's rule for Adam near G = 0."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import envs as tenvs
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos import rollout_host as trh
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.ops import fitness as tfit
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.algos import rollout_host as jrh
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import tabular as jtab

COUNT = 2_000_000
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs a worker per core, and these small
    CPU forwards lose most of their time to threads waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def quiet_loggers(monkeypatch):
    monkeypatch.setattr(jtab, "dump_tabular", lambda: jtab._logger._kvs.clear())
    monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())


def _jax_seed(key) -> int:
    """The host RNG seed the JAX package derives from a round key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


class _Injected(tes.ESTrainer):
    """The port's trainer, handed its rounds' draws, the device rounds' and
    eval episodes' reset states, and the eval seed."""

    def __init__(self, *a, rounds, starts=None, eval_seed=0, **kw):
        super().__init__(*a, **kw)
        self._rounds, self._starts, self._eval_seed = list(rounds), starts, eval_seed

    def _draw_round(self, npairs):
        idxs, seed = self._rounds.pop(0)
        assert idxs.shape == (npairs,)
        return torch.from_numpy(np.array(idxs)), seed

    def _draw_eval_seed(self):
        return self._eval_seed

    def _episode_starts(self, seed, n, paired):
        state = self._starts["round"].pop(0) if paired else self._starts["eval"]
        assert state[0].shape == ((2 * n,) if paired else (n,))
        return state, self._episode_gen(seed)


def _check_update(ttr, jtr, theta0, returns, idxs, lr, chunk=256):
    """g both packages' way from the same returns (within 1e-5·max|g|) and
    θ' by the Adam rule of tests/test_torch_es.py."""
    D = ttr.model.num_params
    srets = np.zeros_like(returns)
    jw = jfit.process_returns(jnp.asarray(returns), jnp.asarray(srets), "centered_rank")
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise.noise, jnp.asarray(idxs), jw[:, 0] - jw[:, 1], D,
                                             chunk)) / returns.size
    tw = tfit.process_returns(torch.from_numpy(returns), torch.from_numpy(srets), "centered_rank")
    tg = noise_gradient(ttr.noise.noise, torch.from_numpy(idxs), (tw[:, 0] - tw[:, 1]).contiguous(), D,
                        chunk).numpy() / returns.size
    gmax = np.abs(jg).max()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * gmax)
    eps_ = 1e-8 / np.sqrt(1 - 0.999)
    steady = lr * eps_ * (1e-5 * gmax) / (np.abs(-jg + 0.005 * theta0) + eps_) ** 2 < 1e-6
    ttheta, jtheta = ttr.theta.numpy(), np.asarray(jtr.state.theta)
    np.testing.assert_allclose(ttheta[steady], jtheta[steady], rtol=0, atol=1e-6)
    assert np.abs(ttheta - theta0).max() <= lr * (1 + 1e-5) and steady.mean() > 0.9


def test_host_quota_matches_jax():
    """Quota mode on the ToyCatch engine, 8 slots, 4 pairs a round (the JAX
    default of 64 capped by the slots): rounds until 16 episodes and 330
    steps are both met; mirrored pairs (``mirror_crn``) share their draws
    as the JAX package's do. (Without ``mirror_crn`` a round's draws are
    the fixed-population mode's, tests/test_torch_es.py.)"""
    slots, npairs, cutoff = 8, 4, 20
    cfg = dict(episodes_per_batch=16, timesteps_per_batch=330, num_eval_episodes=slots, episode_cutoff_mode=cutoff,
               mirror_crn=True)
    jenv = JaxAtari("toy", batch_size=slots, num_threads=2)
    jm = jmodels.SmallDQN(num_actions=jenv.num_actions)
    jtr = jes.ESTrainer(jenv, jm, jes.ESConfig(**cfg), optimizer=jopt.Adam(stepsize=0.01),
                        noise_table=JaxNoise.from_seed(count=COUNT), seed=1)
    theta0, key = np.asarray(jtr.state.theta), jtr.state.key
    jstats = jtr.train_step()
    jenv.close()
    key, keval = jax.random.split(key)
    rounds = []
    for _ in range(12):  # more than the JAX trainer ran
        key, kround = jax.random.split(key)
        idxs = np.array(jax.random.randint(kround, (npairs,), 0, COUNT - jm.num_params + 1, dtype=jnp.int32))
        rounds.append((idxs, _jax_seed(kround)))
    n_rounds = jstats.returns.shape[0] // npairs
    assert n_rounds >= 3 and jstats.lengths.sum() >= 330  # the steps' quota took a third round or more

    tenv = TorchAtari("toy", batch_size=slots, num_threads=2)
    ttr = _Injected(tenv, tmodels.SmallDQN(num_actions=tenv.num_actions), tes.ESConfig(**cfg),
                    optimizer=topt.Adam(stepsize=0.01), noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"),
                    seed=1, device="cpu", rounds=rounds, eval_seed=_jax_seed(keval))
    ttr.theta = weights.from_jax(theta0, device="cpu")
    tstats = ttr.train_step()
    ttr.close()
    assert len(rounds) - len(ttr._rounds) == n_rounds
    np.testing.assert_array_equal(tstats.lengths, jstats.lengths)
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    np.testing.assert_array_equal(tstats.eval_lengths, np.asarray(jstats.eval_lengths))
    np.testing.assert_array_equal(tstats.eval_returns, np.asarray(jstats.eval_returns))
    assert ttr.episodes_so_far == 2 * npairs * n_rounds and ttr.timesteps_so_far == int(jstats.lengths.sum())
    _check_update(ttr, jtr, theta0, tstats.returns, np.concatenate([r[0] for r in rounds[:n_rounds]]), 0.01)


def _to_torch_state(tenv, jstate):
    cls = type(tenv.reset(1, torch.Generator(), CPU))
    return cls(*(torch.from_numpy(np.array(f)) for f in jstate))


def test_device_quota_tops_up_like_jax(monkeypatch):
    """Quota mode on CartPole, ``eval_batch`` 4 pairs a round and
    ``grad_chunk`` 3: the first estimate from the cutoff (50 steps) falls
    short of 300 steps, so the trainer tops up from the mean length it
    read, as the JAX package's device arm does; the rounds of each estimate,
    the returns, the eval episodes, g and θ' as the JAX package's."""
    cfg = dict(episodes_per_batch=8, timesteps_per_batch=300, eval_batch=4, grad_chunk=3, num_eval_episodes=4,
               episode_cutoff_mode=50)
    jenv, tenv = jenvs.make("gym.CartPole-v1"), tenvs.make("gym.CartPole-v1")
    kw = dict(obs_dim=4, num_actions=2)
    jm, tm = jmodels.SimpleClassifier(**kw), tmodels.SimpleClassifier(**kw)
    calls, real = [], jes._eval_rounds

    def recorded(*args):
        calls.append((args[4], args[7], args[8]))  # the round key, pairs, rounds
        return real(*args)

    monkeypatch.setattr(jes, "_eval_rounds", recorded)
    jtr = jes.ESTrainer(jenv, jm, jes.ESConfig(**cfg), optimizer=jopt.Adam(stepsize=0.01),
                        noise_table=JaxNoise.from_seed(count=COUNT), seed=4)
    theta0, key = np.asarray(jtr.state.theta), jtr.state.key
    jstats = jtr.train_step()
    assert len(calls) >= 2 and calls[0][2] == 1  # a top-up after the first estimate
    _, keval = jax.random.split(key)
    rounds, states = [], []
    for kround, npairs, n in calls:
        for rkey in jax.random.split(kround, n):
            kidx, kroll = jax.random.split(rkey)
            rounds.append((np.array(jax.random.randint(kidx, (npairs,), 0, COUNT - jm.num_params + 1,
                                                       dtype=jnp.int32)), 0))
            ep = jax.random.randint(kroll, (npairs,), 0, 2**31 - 1, dtype=jnp.int32)
            keys = jax.vmap(lambda s: jax.random.PRNGKey(s.astype(jnp.uint32)))(ep)
            states.append(_to_torch_state(tenv, jax.vmap(jenv.reset)(jnp.concatenate([keys, keys]))))
    starts = {"round": states, "eval": _to_torch_state(tenv, jax.vmap(jenv.reset)(jax.random.split(keval, 4)))}
    ttr = _Injected(tenv, tm, tes.ESConfig(**cfg), optimizer=topt.Adam(stepsize=0.01),
                    noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), seed=4, device="cpu",
                    rounds=rounds, starts=starts)
    ttr.theta = weights.from_jax(theta0, device="cpu")
    tstats = ttr.train_step()
    assert ttr.last_dispatches == [n for _, _, n in calls] and not ttr._rounds
    np.testing.assert_array_equal(tstats.lengths, jstats.lengths)
    np.testing.assert_array_equal(tstats.returns, jstats.returns)  # CartPole: a return is a length
    np.testing.assert_array_equal(tstats.eval_lengths, np.asarray(jstats.eval_lengths))
    assert ttr._mean_len_est == jtr._mean_len_est
    _check_update(ttr, jtr, theta0, tstats.returns, np.concatenate([r[0] for r in rounds]), 0.01, chunk=3)


class _Recording:
    """A host env that records each reset's noop counts and episode seeds."""

    def __init__(self, env):
        self._real, self.resets = env, []

    def __getattr__(self, name):
        return getattr(self._real, name)

    def reset(self, noops=None, indices=None, max_frames=None, seeds=None):
        self.resets.append((np.array(noops), np.array(seeds)))
        return self._real.reset(noops=noops, indices=indices, max_frames=max_frames, seeds=seeds)


class _NoActions:
    """An act function that takes no step: the draws are all that is read."""

    def prepare(self, params):
        return params

    def __call__(self, params, obs, keys=None):
        return torch.zeros(obs.shape[0], dtype=torch.int32) if torch.is_tensor(obs) else jnp.zeros(obs.shape[0])


def test_mirror_pairs_draws_match_jax():
    """Where 2·pairs is the slot count, the port's mirrored draws are the JAX
    package's (noops and engine episode seeds, slot i with slot n + i);
    with a padded round the pad slots take the last pair's draws."""
    key = jax.random.PRNGKey(5)
    envs = [_Recording(cls("toy", batch_size=8, num_threads=1)) for cls in (JaxAtari, TorchAtari)]
    try:
        jrh.rollout_host_batch(envs[0], _NoActions(), (jnp.zeros((8, 3)), None), key, 0, mirror_pairs=True)
        trh.rollout_host_batch(envs[1], _NoActions(), (torch.zeros(8, 3), None), _jax_seed(key), 0, CPU,
                               mirror_pairs=4)
        trh.rollout_host_batch(envs[1], _NoActions(), (torch.zeros(8, 3), None), 9, 0, CPU, mirror_pairs=2)
    finally:
        for e in envs:
            e.close()
    (jn, js), = envs[0].resets
    (tn, ts), (pn, ps) = envs[1].resets
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ts, js)
    assert np.array_equal(tn[:4], tn[4:]) and len(set(ts[:4])) == 4
    rng = np.random.default_rng(9)
    n2, s2 = rng.integers(1, 31, size=2), rng.integers(1, 2**31 - 1, size=2, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(pn, n2[[0, 1, 0, 1, 1, 1, 1, 1]])
    np.testing.assert_array_equal(ps, s2[[0, 1, 0, 1, 1, 1, 1, 1]])


@pytest.mark.parametrize("mirror", [False, True])
def test_padded_round_and_mirrored_pairs(mirror):
    """2 pairs a round (``eval_batch``) on 8 slots, quota 8 episodes: two
    padded rounds. With σ = 0 the pair's members are one θ, so with
    ``mirror_crn`` each pair's returns and lengths are equal; without it
    their episodes differ (a cutoff of 100 steps, past the first game
    overs, so that they show it)."""
    env = TorchAtari("toy", batch_size=8, num_threads=2)
    tr = tes.ESTrainer(env, tmodels.SmallDQN(num_actions=env.num_actions),
                       tes.ESConfig(episodes_per_batch=8, eval_batch=2, mirror_crn=mirror, noise_stdev=0.0,
                                    episode_cutoff_mode=100, num_eval_episodes=0),
                       noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), seed=2, device="cpu")
    st = tr.train_step()
    tr.close()
    assert st.returns.shape == (4, 2) and tr.episodes_so_far == 8
    same = np.array_equal(st.lengths[:, 0], st.lengths[:, 1]) and np.array_equal(st.returns[:, 0], st.returns[:, 1])
    assert same == mirror


NPAIRS_CASES = [  # population, eval_batch, quotas (episodes, steps), slots (None: device env), θ budget, D
    (512, 0, (0, 0), 256, 2**31, 1000),
    (512, 0, (0, 0), None, 2**31, 1000),
    (512, 0, (0, 0), None, 2 * 4 * 1000 * 20, 1000),
    (0, 0, (5000, 10000), 256, 2**31, 1_004_852),
    (0, 0, (5000, 10000), 100, 2**31, 1_004_852),
    (0, 0, (0, 300), None, 2 * 4 * 1000 * 10, 1000),
    (0, 16, (100, 0), 8, 2**31, 1000),
    (64, 16, (0, 0), None, 2 * 4 * 1000 * 4, 1000),
    (3, 0, (0, 0), None, 2**31, 1000),
]


@pytest.mark.parametrize("case", NPAIRS_CASES)
def test_npairs_round_matches_jax(case):
    """Pairs a round, the JAX package's rule (es.py:616-629): ``eval_batch``,
    else the population's or 64 in quota mode, under the θ budget; on the
    host engine at most half the slots."""
    pop, eval_batch, (epb, tpb), slots, budget, D = case
    cfg = dict(population_size=pop, eval_batch=eval_batch, episodes_per_batch=epb, timesteps_per_batch=tpb,
               theta_hbm_budget=budget)
    ns = lambda c: types.SimpleNamespace(  # noqa: E731
        config=c, is_host_env=slots is not None, env=types.SimpleNamespace(batch_size=slots),
        model=types.SimpleNamespace(num_params=D))
    cap = max(1, budget // (2 * D * 4))
    assert tes.ESTrainer._npairs_round(ns(tes.ESConfig(**cfg))) == jes.ESTrainer._npairs_round(
        ns(jes.ESConfig(**cfg)), cap)
