"""The host engine's obs modes ('gray', 'indexed', 'preproc') in the port
against the JAX package, on ToyCatch engine frames, on the CPU.

Tolerances, fixed before the comparison:

* engine frames of each mode: equal bit for bit (the same C++ source, the
  same flags, the same seeds and actions);
* the device's part from the same frames: 'preproc' bit for bit (one exact
  scale); 'gray' and 'indexed' within 1e-6 (two resize products whose
  float32 sums may run in another order); the 4-stacks likewise;
* 'preproc' against 'gray' on the same engine state: within 0.5/255 (the
  engine rounds to uint8 after the resize) plus the resize's 1e-6;
* rollouts and one ES generation on 'preproc': returns and lengths equal,
  as on 'gray' (tests/test_torch_es.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos.rollout_host import collect_ref_batch_host, rollout_host_batch
from deep_neuroevolution_torch.envs import preprocess as tpre
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.models import SmallDQN as TorchDQN
from deep_neuroevolution_torch.models import VirtualBNDQN as TorchVBN
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.algos import rollout_host as jroll
from deep_neuroevolution_tpu.envs import preprocess as jpre
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN
from deep_neuroevolution_tpu.models.dqn import SmallDQN as JaxDQN
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import tabular as jtab

MODES = ("gray", "indexed", "preproc")
CPU = torch.device("cpu")
SLOTS, COUNT = 8, 2_000_000


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_seed(key) -> int:
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def _drive(env, steps: int = 6):
    """The engine's frames after a seeded reset and each of ``steps`` fixed
    steps of every slot."""
    rng = np.random.default_rng(4)
    env.reset(noops=rng.integers(1, 31, size=SLOTS), seeds=rng.integers(1, 2**31 - 1, size=SLOTS).astype(np.int32))
    frames = [env.observe()]
    for _ in range(steps):
        env.step(rng.integers(0, env.num_actions, size=SLOTS).astype(np.int32))
        frames.append(env.observe())
    env.close()
    return frames


def _device_part(pkg: str, frames, mode: str) -> np.ndarray:
    if pkg == "torch":
        return tpre.preprocess_obs(torch.from_numpy(frames), mode).numpy()
    if mode == "preproc":
        return np.asarray(jpre.scale_preproc_frames(jnp.asarray(frames)))
    pre = jpre.preprocess_gray_frames if mode == "gray" else jpre.preprocess_frames
    return np.asarray(pre(jnp.asarray(frames), 84, 84))


@pytest.fixture(scope="module")
def engine_frames():
    """Each mode's frames, from each package's engine, over one episode
    start."""
    out = {}
    for mode in MODES:
        out[mode] = [_drive(cls("toy", batch_size=SLOTS, num_threads=2, obs_mode=mode))
                     for cls in (JaxAtari, TorchAtari)]
    return out


@pytest.mark.parametrize("mode", MODES)
def test_engine_frames_equal(engine_frames, mode):
    jframes, tframes = engine_frames[mode]
    shape = (SLOTS, 84, 84) if mode == "preproc" else (SLOTS, 2, 210, 160)
    for j, t in zip(jframes, tframes):
        assert t.shape == shape and t.dtype == np.uint8
        np.testing.assert_array_equal(t, j)
    bytes_a_slot = tframes[0].nbytes // SLOTS
    assert bytes_a_slot == (7_056 if mode == "preproc" else 67_200)


@pytest.mark.parametrize("mode", MODES)
def test_device_part_and_stacks_match_jax(engine_frames, mode):
    """The device's part of each mode and the 4-stack over the steps."""
    frames = engine_frames[mode][1]
    tstack = jstack = None
    for f in frames:
        t, j = _device_part("torch", f, mode), _device_part("jax", f, mode)
        assert t.shape == (SLOTS, 84, 84, 1) and t.dtype == np.float32
        if mode == "preproc":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
        if tstack is None:
            tstack = tpre.stack_reset(torch.from_numpy(t))
            jstack = np.asarray(jroll._device_reset(jnp.asarray(f), 84, 84, mode))
        else:
            tstack = tpre.stack_step(tstack, torch.from_numpy(t))
            jstack = np.asarray(jpre.stack_step(jnp.asarray(jstack), jnp.asarray(j)))
        np.testing.assert_allclose(tstack.numpy(), jstack, rtol=0, atol=0 if mode == "preproc" else 1e-6)


def test_preproc_differs_from_gray_by_the_rounding(engine_frames):
    """On the same engine state: the engine's uint8 rounding after the
    resize moves a pixel by at most 0.5/255; 'indexed' differs from 'gray'
    by the LUT's rounding before the resize, also at most 0.5/255."""
    gray = [_device_part("torch", f, "gray") for f in engine_frames["gray"][1]]
    for mode in ("preproc", "indexed"):
        other = [_device_part("torch", f, mode) for f in engine_frames[mode][1]]
        diff = max(float(np.abs(a - b).max()) for a, b in zip(gray, other))
        assert 0 < diff <= 0.5 / 255 + 1e-6, (mode, diff)


@pytest.mark.parametrize("mode", ["indexed", "preproc"])
def test_rollout_matches_jax(mode):
    """SmallDQN members on 8 slots for 30 steps on each mode, from the same
    seed: returns, lengths and final RAM equal to the JAX package's."""
    model = TorchDQN(num_actions=4)
    sb = model.scale_by().numpy()
    th = (np.random.RandomState(0).randn(SLOTS, model.num_params) * sb).astype(np.float32)
    key = jax.random.PRNGKey(9)
    tenv = TorchAtari("toy", batch_size=SLOTS, num_threads=2, obs_mode=mode)
    t = rollout_host_batch(tenv, model.make_batch_act(), (torch.from_numpy(th), None), _jax_seed(key), 30, CPU)
    tenv.close()
    jenv = JaxAtari("toy", batch_size=SLOTS, num_threads=2, obs_mode=mode)
    j = jroll.rollout_host_batch(jenv, JaxDQN(num_actions=4).make_batch_act(), (jnp.asarray(th), None), key, 30)
    jenv.close()
    np.testing.assert_array_equal(t.lengths, np.asarray(j.lengths))
    np.testing.assert_array_equal(t.returns, np.asarray(j.returns))
    np.testing.assert_array_equal(t.bc, np.asarray(j.bc))


@pytest.mark.parametrize("mode", ["indexed", "preproc"])
def test_ref_batch_matches_jax(mode):
    """The random-policy reference batch from the same host seed on each
    mode: 'preproc' bit for bit, 'indexed' within the resize's 1e-6."""
    jenv = JaxAtari("toy", batch_size=SLOTS, num_threads=2, obs_mode=mode)
    tenv = TorchAtari("toy", batch_size=SLOTS, num_threads=2, obs_mode=mode)
    kref = jax.random.PRNGKey(3)
    j = np.asarray(jroll.collect_ref_batch_host(jenv, kref, batch_size=20))
    t = collect_ref_batch_host(tenv, _jax_seed(kref), CPU, batch_size=20)
    jenv.close()
    tenv.close()
    assert t.shape == (20, 84, 84, 4)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=0 if mode == "preproc" else 1e-6)


class _InjectedES(tes.ESTrainer):
    def __init__(self, *a, rounds, eval_seed, **kw):
        super().__init__(*a, **kw)
        self._rounds, self._eval_seed = list(rounds), eval_seed

    def _draw_round(self, npairs):
        idxs, seed = self._rounds.pop(0)
        assert idxs.shape == (npairs,)
        return torch.from_numpy(idxs), seed

    def _draw_eval_seed(self):
        return self._eval_seed


def test_es_generation_on_preproc_matches_jax(monkeypatch):
    """One fixed-population ES generation (VBN-DQN, 8 slots, population 16,
    cutoff 20, 8 eval episodes) on 'preproc', from the JAX trainer's θ,
    reference batch, offsets and seeds: returns, lengths and the eval
    episodes equal; the port's own reference batch on 'preproc' equals the
    JAX trainer's bit for bit."""
    monkeypatch.setattr(jtab, "dump_tabular", lambda: jtab._logger._kvs.clear())
    monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())
    jenv = JaxAtari("toy", batch_size=SLOTS, num_threads=2, pipeline_groups=2, obs_mode="preproc")
    jm = JaxVBN(num_actions=jenv.num_actions)
    jtr = jes.ESTrainer(jenv, jm, jes.ESConfig(population_size=16, episode_cutoff_mode=20, num_eval_episodes=8),
                        optimizer=jopt.Adam(stepsize=0.01), noise_table=JaxNoise.from_seed(count=COUNT), seed=0)
    theta0, key = np.asarray(jtr.state.theta), jtr.state.key
    jstats = jtr.train_step()
    jenv.close()
    key, keval = jax.random.split(key)
    rounds = []
    for _ in range(2):
        key, kround = jax.random.split(key)
        idxs = np.array(jax.random.randint(kround, (4,), 0, COUNT - jm.num_params + 1, dtype=jnp.int32))
        rounds.append((idxs, _jax_seed(kround)))
    # the JAX trainer drew its reference batch from the key it started with
    _, kref = jax.random.split(jax.random.PRNGKey(0))
    tenv = TorchAtari("toy", batch_size=SLOTS, num_threads=2, pipeline_groups=2, obs_mode="preproc")
    np.testing.assert_array_equal(collect_ref_batch_host(tenv, _jax_seed(kref), CPU).numpy(), np.asarray(jtr.ref_batch))
    ttr = _InjectedES(tenv, TorchVBN(num_actions=tenv.num_actions),
                      tes.ESConfig(population_size=16, episode_cutoff_mode=20), optimizer=topt.Adam(stepsize=0.01),
                      noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), device="cpu", rounds=rounds,
                      eval_seed=_jax_seed(keval))
    ttr.theta = weights.from_jax(theta0, device="cpu")
    ttr.ref_batch = weights.from_jax(np.asarray(jtr.ref_batch), device="cpu")
    tstats = ttr.train_step()
    ttr.close()
    assert not ttr._rounds
    np.testing.assert_array_equal(tstats.lengths, jstats.lengths)
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    np.testing.assert_array_equal(tstats.eval_lengths, np.asarray(jstats.eval_lengths))
    np.testing.assert_array_equal(tstats.eval_returns, np.asarray(jstats.eval_returns))
