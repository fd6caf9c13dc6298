"""Checks on the port as a whole that catch a run on a card breaking before
it gets there: the port and chip_smoke.py must not import JAX or the JAX
package (the card's machine has neither), nor build with PyTorch's C++
extension builder; and without a CUDA device every entry point stops with
the package's "no CUDA device" error."""

import json
import os
import pkgutil
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

import deep_neuroevolution_torch
from deep_neuroevolution_torch import NoCudaDevice, resolve_device
from deep_neuroevolution_torch import main as cli

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deep_neuroevolution_torch"
PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(deep_neuroevolution_torch.__path__, "deep_neuroevolution_torch.")
)

# an import of jax or of the JAX package, in any form
_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|deep_neuroevolution_tpu)\b"
    r"|__import__\(\s*['\"](jax|deep_neuroevolution_tpu)"
    r"|import_module\(\s*['\"](jax|deep_neuroevolution_tpu)",
    re.M,
)


def _port_files():
    """chip_smoke.py, the port's A/B and campaign scripts and every source
    of the port, its CUDA headers included."""
    files = [ROOT / "chip_smoke.py", ROOT / "scripts" / "launch_gpu.py", *sorted((ROOT / "scripts").glob("torch_*.py")),
             *sorted((ROOT / "scripts").glob("*_torch.py"))]
    for ext in ("*.py", "*.cu", "*.cuh", "*.cpp", "*.h", "*.hpp"):
        files += [p for p in PORT.rglob(ext) if "_build" not in p.parts]
    return files


def test_every_module_is_listed():
    assert "deep_neuroevolution_torch.ops.population_linear" in PORT_MODULES
    assert "deep_neuroevolution_torch.algos.es" in PORT_MODULES
    # slice 3: the VBN-DQN's routes and the K4/K6 wrappers, and their CUDA source
    for name in ("models.batchnorm", "ops.fused_dqn"):
        assert f"deep_neuroevolution_torch.{name}" in PORT_MODULES
    from deep_neuroevolution_torch.ops import _cuda_build

    assert "vbn_dqn_fused.cu" in [p.name for p in _cuda_build.sources()]
    # long runs: checkpoints, VINE dumps, TensorBoard events, the launcher
    for name in ("utils.checkpoint", "utils.vine", "utils.tb_events", "train"):
        assert f"deep_neuroevolution_torch.{name}" in PORT_MODULES


def test_no_jax_import_and_no_cpp_extension_in_the_port():
    """No file of the port, chip_smoke.py or the port's A/B scripts imports
    jax or the JAX package (naming the JAX package's files in prose, as each
    kernel's note does, is fine), and none uses torch.utils.cpp_extension or
    torch/extension.h."""
    names = {p.name for p in _port_files()}
    assert {"dqn_conv_mma.cuh", "bulk_ring.cuh", "torch_k3_ab.py", "torch_ab.py", "parity_study_torch.py"} <= names
    offenders = []
    for path in _port_files():
        text = path.read_text()
        if _IMPORT.search(text):
            offenders.append(f"{path.relative_to(ROOT)}: imports jax or deep_neuroevolution_tpu")
        if "cpp_extension" in text or "torch/extension.h" in text:
            offenders.append(f"{path.relative_to(ROOT)}: uses PyTorch's C++ extension builder")
    assert not offenders, offenders


_BLOCKED = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["deep_neuroevolution_tpu"] = None
import importlib
for name in {modules!r}:
    importlib.import_module(name)
print("imported", len({modules!r}), "modules", flush=True)
sys.argv = ["chip_smoke.py"]
runpy.run_path({smoke!r}, run_name="__main__")
"""


def test_imports_and_smoke_without_jax_or_cuda():
    """With jax and the JAX package blocked, every module of the port
    imports, and chip_smoke.py stops with the "no CUDA device" error, never
    an ImportError."""
    code = _BLOCKED.format(modules=PORT_MODULES, smoke=str(ROOT / "chip_smoke.py"))
    p = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)},
    )
    assert f"imported {len(PORT_MODULES)} modules" in p.stdout, p.stderr[-2000:]
    assert p.returncode != 0
    assert "NoCudaDevice: no CUDA device" in p.stderr, p.stderr[-2000:]
    assert "ImportError" not in p.stderr and "ModuleNotFoundError" not in p.stderr, p.stderr[-2000:]
    assert '"ok": true' not in p.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means cuda: without a card the trainer, the config loader
    and the CLI stop with NoCudaDevice, and never fall back to the CPU."""
    import torch

    from deep_neuroevolution_torch.utils import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(NoCudaDevice, match="no CUDA device"):
            resolve_device(dev)
    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    with pytest.raises(NoCudaDevice):
        config.load_experiment(exp, overrides={"game": "toy"})
    assert cli.main(["train", "--exp_file", str(ROOT / "configurations" / "es_atari_config.json"),
                     "--overrides", '{"game": "toy"}']) == 1
    assert resolve_device("cpu") == torch.device("cpu")


_NO_GYMNASIUM = """
import sys
sys.modules["gymnasium"] = None
sys.modules["mujoco"] = None
sys.modules["jax"] = None
from deep_neuroevolution_torch import envs
from deep_neuroevolution_torch.envs import mujoco
from deep_neuroevolution_torch.utils import config
assert not mujoco.is_available() and envs.MujocoHostEnv is mujoco.MujocoHostEnv
try:
    config.resolve_env("Humanoid-v1")
except RuntimeError as e:
    print("refused:", e)
"""


def test_mujoco_modules_import_without_gymnasium():
    """The MuJoCo slice's modules are listed, the native extras' sources
    are the port's own, and envs/mujoco.py imports where gymnasium and
    mujoco do not (the card's machine has neither): a MuJoCo id is then
    refused by name."""
    for name in ("envs.mujoco", "algos.rollout_host", "native.build", "native.bridge"):
        assert f"deep_neuroevolution_torch.{name}" in PORT_MODULES
    names = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"native/ale_stub/ale_interface.hpp", "native/engine_stress_test.cpp", "envs/mujoco.py"} <= names
    from deep_neuroevolution_torch.algos import rollout_host
    from deep_neuroevolution_torch.native import build

    assert callable(rollout_host.rollout_host) and callable(rollout_host.rollout_host_vec)
    assert callable(build.build_ale_stub) and callable(build.build_stress)
    p = subprocess.run([sys.executable, "-c", _NO_GYMNASIUM], capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert p.returncode == 0, p.stderr[-2000:]
    assert "refused: env id 'Humanoid-v1' needs gymnasium and mujoco" in p.stdout


def test_inspector_modules_are_listed():
    """The last slice: a counterpart of each of the JAX package's seven
    inspector files, every one among the files the import check reads, and
    the GPU launcher too."""
    jax_inspector = sorted(p.name for p in (ROOT / "deep_neuroevolution_tpu" / "inspector").glob("*.py"))
    assert len(jax_inspector) == 7
    for name in jax_inspector:
        module = "deep_neuroevolution_torch.inspector" + ("" if name == "__init__.py" else "." + name[:-3])
        assert module in PORT_MODULES
        assert PORT / "inspector" / name in _port_files()
    assert ROOT / "scripts" / "launch_gpu.py" in _port_files()


def test_slice_two_modules_are_listed():
    for name in ("ops.fused_dqn", "ops.genome", "ops.schedules", "models.dqn", "algos.ga"):
        assert f"deep_neuroevolution_torch.{name}" in PORT_MODULES


@pytest.mark.parametrize("algo", ["ga", "rs"])
def test_ga_entry_points_raise_without_cuda(monkeypatch, algo):
    """``main train --algo ga|rs`` and the GA trainer stop with NoCudaDevice
    without a card; nothing falls back to the CPU."""
    import torch

    from deep_neuroevolution_torch.algos import ga
    from deep_neuroevolution_torch.models import SmallDQN
    from deep_neuroevolution_torch.utils import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = ROOT / "configurations" / f"{algo}_atari_config.json"
    with pytest.raises(NoCudaDevice):
        config.load_experiment(json.loads(path.read_text()), overrides={"game": "toy"}, algo=algo)
    assert cli.main(["train", "--algo", algo, "--exp_file", str(path), "--overrides", '{"game": "toy"}']) == 1
    with pytest.raises(NoCudaDevice):
        ga.GATrainer(types.SimpleNamespace(is_host_env=True), SmallDQN(num_actions=4), ga.GAConfig())


def test_config_rejects_what_is_not_ported(tmp_path):
    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    import pickle

    import torch

    from deep_neuroevolution_torch.utils import checkpoint, config

    with pytest.raises(NotImplementedError, match="no ALE"):
        config.load_experiment(exp, device="cpu")  # frostbite needs ALE
    with pytest.raises(ValueError, match="unsupported overrides"):
        config.load_experiment(exp, overrides={"mesh": 8}, device="cpu")
    with pytest.raises(ValueError, match="'pod' override applies to device envs"):  # parallel/: host envs scale by host_pod
        config.load_experiment(exp, overrides={"game": "toy", "pod": True, "noise_size": 3_000_000,
                                               "env_kwargs": {"batch_size": 4}}, device="cpu")
    tr = config.load_experiment(exp, device="cpu", algo="ga", overrides={  # the GA's round size now acts
        "game": "toy", "eval_batch": 64, "noise_size": 3_000_000, "env_kwargs": {"batch_size": 4}})
    tr.close()
    assert tr.config.eval_batch == 64
    with pytest.raises(NotImplementedError, match="nses"):
        config.load_experiment(exp, overrides={"game": "toy"}, device="cpu", algo="nses")

    # keys the JAX package acts on (its utils/config.py:222, 233-245, 260-261)
    # act where it reads them; mirror_crn on a GA file, which its GA never
    # reads, stops the loader, naming the key, instead of being dropped
    small = {"population_size": 4, "episode_cutoff_mode": 5, "noise_size": 3_000_000, "env_kwargs": {"batch_size": 4}}
    ga_toy, es_toy = (json.loads((ROOT / "configurations" / f).read_text())
                      for f in ("ga_toy_config.json", "es_toy_config.json"))
    with pytest.raises(NotImplementedError, match="mirror_crn.*not ported yet"):
        config.load_experiment({**ga_toy, "mirror_crn": True}, overrides=small, device="cpu")
    population = tmp_path / "population.pkl"
    population.write_bytes(pickle.dumps([[7, 11], (5, (13, 0.002))]))
    tr = config.load_experiment({**ga_toy, "load_population": str(population)}, overrides=small, device="cpu")
    tr.close()
    assert [o.seeds for o in tr.state.population] == [(7, (11, 0.005)), (5, (13, 0.002))]
    seeds = tmp_path / "toy_seeds.pkl"  # load_from's path is formatted with the experiment's fields
    seeds.write_bytes(pickle.dumps([123, (456, 0.02)]))
    tr = config.load_experiment({**es_toy, "mirror_crn": True, "load_from": str(tmp_path / "{game}_seeds.pkl")},
                                overrides=small, device="cpu")
    tr.close()
    assert tr.config.mirror_crn
    assert torch.equal(tr.theta, checkpoint.theta_from_seed_chain(tr.model, tr.noise, [123, (456, 0.02)]))
    tr = config.load_experiment(es_toy, overrides={**small, "mirror_crn": True, "eval_batch": 64, "grad_chunk": 32},
                                device="cpu")
    tr.close()
    assert (tr.config.mirror_crn, tr.config.eval_batch, tr.config.grad_chunk) == (True, 64, 32)
    assert tr._npairs_round() == 2  # eval_batch, capped by the 4 engine slots
    # num_eval_episodes: accepted for ES, as in the JAX package (its
    # config.py:223); the GA has no eval episodes
    tr = config.load_experiment(es_toy, overrides={**small, "num_eval_episodes": 3}, device="cpu")
    tr.close()
    assert tr.config.num_eval_episodes == 3
    with pytest.raises(ValueError, match="ES only"):
        config.load_experiment(ga_toy, overrides={**small, "num_eval_episodes": 3}, device="cpu")
