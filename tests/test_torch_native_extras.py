"""The port's native extras against the JAX package's: the engine's ALE
backend compiled against the ALE API stub (native/ale_stub/, a scripted
counter game, not ALE), the engine's concurrency stress binary under
ThreadSanitizer, and the engine library's ALE build switch.

The JAX package's stub library is compiled here from its own sources into
a temporary directory, so nothing is written into its folder."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deep_neuroevolution_torch.envs import atari as tatari
from deep_neuroevolution_torch.native import build as tbuild
from deep_neuroevolution_torch.native.bridge import HostBatchEnv as TorchEngine
from deep_neuroevolution_tpu.native.bridge import HostBatchEnv as JaxEngine

ROOT = Path(__file__).resolve().parent.parent
JAX_NATIVE = ROOT / "deep_neuroevolution_tpu" / "native"


@pytest.fixture(scope="module")
def stub_libs(tmp_path_factory):
    """(the port's stub engine, the JAX package's stub engine built from its
    sources with its flags)."""
    out = tmp_path_factory.mktemp("jax_stub") / "libnevo_env_alestub.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-DHAVE_ALE",
                    f"-I{JAX_NATIVE / 'ale_stub'}", str(JAX_NATIVE / "env_engine.cpp"), "-o", str(out)],
                   check=True, capture_output=True)
    return tbuild.build_ale_stub(), out


def test_ale_stub_engine_compiles_and_steps(stub_libs):
    """The JAX package's tests/test_atari_path.py:383-418 on the port's
    stub engine: 4 actions, 128 RAM bytes, (2, 210, 160) frames, rewards,
    and EpisodicLife through the ALE lives() surface."""
    so, _ = stub_libs
    assert so.parent == tbuild.BUILD_DIR and so.name.startswith("libnevo_env_alestub-")
    assert tbuild.build_ale_stub() == so  # named by its sources and flags: built once
    env = TorchEngine("ale", "stub.rom", batch_size=2, num_threads=1, lib_path=str(so))
    assert env.num_actions == 4
    assert env.final_state_size == 128
    assert (env.frames_per_obs, env.height, env.width) == (2, 210, 160)
    env.reset(np.array([2, 5], np.int32), max_frames=10_000)
    total_rew, done = 0.0, np.zeros(2, bool)
    for _ in range(10):
        r, d = env.step(np.zeros(2, np.int32))
        total_rew += float(r.sum())
        done |= d
    obs = env.observe()
    assert obs.shape == (2, 2, 210, 160) and obs.any()
    assert env.final_state().shape == (2, 128)
    assert total_rew > 0  # +1 every 7th emulator frame; 10 steps × frameskip 4
    env.close()
    env2 = TorchEngine("ale", "stub.rom", batch_size=1, num_threads=1, episodic_life=True, lib_path=str(so))
    env2.reset(np.array([1], np.int32), max_frames=10_000)
    d, steps = False, 0
    while not d and steps < 100:
        _, dd = env2.step(np.zeros(1, np.int32))
        d, steps = bool(dd[0]), steps + 1
    assert d
    assert int(env2.final_state()[0, 2]) == 2  # stub RAM[2] = lives
    env2.close()


@pytest.mark.parametrize("episodic_life", [False, True])
def test_ale_stub_engine_matches_jax_bit_for_bit(stub_libs, episodic_life):
    """Both packages' stub engines, 4 slots, the same noops and actions
    (NOOP, FIRE, RIGHT, LEFT) over 10 steps: frames, RAM, rewards and dones
    bit for bit."""
    so, jso = stub_libs
    t = TorchEngine("ale", "stub.rom", batch_size=4, num_threads=2, episodic_life=episodic_life, lib_path=str(so))
    j = JaxEngine("ale", "stub.rom", batch_size=4, num_threads=2, episodic_life=episodic_life, lib_path=str(jso))
    try:
        noops = np.array([1, 2, 5, 30], np.int32)
        t.reset(noops, max_frames=10_000)
        j.reset(noops=noops, max_frames=10_000)
        rs = np.random.RandomState(0)
        for _ in range(10):
            a = rs.randint(0, 4, 4).astype(np.int32)
            (tr, td), (jr, jd) = t.step(a), j.step(a)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(t.observe(), j.observe())
            np.testing.assert_array_equal(t.final_state(), j.final_state())
    finally:
        t.close()
        j.close()


def test_default_engine_has_no_ale_and_games_are_refused_by_the_build():
    """The default build is ToyCatch only: ``is_available`` is False, a game
    is refused naming the build, 'toy' runs; the ALE build is a library of
    its own name (the prefix is part of its flags)."""
    assert not tatari.is_available()
    with pytest.raises(NotImplementedError, match="NEVO_ALE_PREFIX"):
        tatari.AtariEnv("frostbite", batch_size=1)
    with pytest.raises(ValueError, match="not in the Atari suite"):
        tatari.AtariEnv("no_such_game", batch_size=1)
    with pytest.raises(RuntimeError, match="unavailable"):
        TorchEngine("ale", "x.bin", batch_size=1)
    env = tatari.AtariEnv("toy", batch_size=2)
    assert env.num_actions == 4 and env.spawn().rom_path is None
    env.close()
    assert tbuild.lib_path() == tbuild.ensure_built()
    assert tbuild.lib_path("/opt/ale") != tbuild.lib_path() and "/opt/ale" not in str(tbuild.lib_path("/opt/ale"))
    assert set(tatari.GAME_ACTIONS) >= {"frostbite", "pong", "breakout"} and tatari.GAME_ACTIONS["frostbite"] == 18


def _stress(*flags):
    return subprocess.run([sys.executable, "-m", "deep_neuroevolution_torch.native.build", "--stress", *flags],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


@pytest.mark.parametrize("tsan", [True, False])
def test_stress_binary(tsan):
    """The engine's stress binary (32 slots, 4 threads, 300 steps with
    resets of finished slots) builds into ``_build/`` and prints ``stress
    ok``; under ThreadSanitizer, with no report (the JAX package's
    tests/test_atari_path.py:152-168)."""
    p = _stress() if tsan else _stress("--no-tsan")
    assert p.returncode == 0, p.stderr[-2000:] + p.stdout[-500:]
    assert "stress ok" in p.stdout
    assert "WARNING: ThreadSanitizer" not in p.stderr
    binary = Path(p.stdout.splitlines()[0])
    assert binary.parent == tbuild.BUILD_DIR and binary.name.startswith("stress_tsan-" if tsan else "stress-")
    assert os.access(binary, os.X_OK)
