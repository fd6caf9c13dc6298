"""The port's Humanoid campaign scripts against the JAX package's, on the CPU,
on real MuJoCo physics.

scripts/humanoid_curve_torch.py, scripts/run_humanoid_nses_torch.py and
scripts/assemble_humanoid_r05_torch.py are the counterparts of the JAX
scripts of the same name without ``_torch``; both sets are imported by
path. Sizes are cut to population 8 on 4 slots (8 for NS-ES) and a cutoff
of 15-30 steps.

A generation is compared from the JAX trainer's own draws, fed to the
port's trainer as tests/test_torch_mujoco.py does (``_feed_jax_batches``:
the JAX θ ± σε batch, its offsets, rollout and eval seeds), with action
noise off in both (the JAX package draws it from per-slot keys) and that
file's 15-step tolerances: returns within 1e-4 of the largest, mass
centres within 1e-4 m, obs sums within 2e-3; lengths and counts exact;
θ' within 1e-6 where Adam's first step is steady. The scripts' other cut,
for the ``run_arm`` trainers whose cutoff (1000) and calc_obstat_prob
(0.01) are fixed in both scripts, is made on the built trainer in both
packages alike: cutoff 15, calc_obstat_prob 0.5.

The JAX scripts' ``main`` writes into results/; the assembler's runs only
with its ``REPO`` pointed at a temporary copy, and the others' mains are
never called.
"""

import dataclasses
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_mujoco import BC15, H15, OB15, _allclose, _feed_jax_batches, _jax_seed  # noqa: E402

from deep_neuroevolution_torch import weights  # noqa: E402
from deep_neuroevolution_torch.algos import es as tes  # noqa: E402
from deep_neuroevolution_torch.algos import nses as tnses  # noqa: E402
from deep_neuroevolution_torch.device import NoCudaDevice  # noqa: E402
from deep_neuroevolution_torch.ops import fitness as tfit  # noqa: E402
from deep_neuroevolution_torch.ops import novelty as tnov  # noqa: E402
from deep_neuroevolution_torch.ops import obstat as tobstat  # noqa: E402
from deep_neuroevolution_torch.utils import checkpoint as tckpt  # noqa: E402
from deep_neuroevolution_tpu import models as jmodels  # noqa: E402
from deep_neuroevolution_tpu.algos import es as jes  # noqa: E402
from deep_neuroevolution_tpu.algos import nses as jnses  # noqa: E402
from deep_neuroevolution_tpu.envs import mujoco as jmj  # noqa: E402
from deep_neuroevolution_tpu.models.mlp import MLPContext as JaxCtx  # noqa: E402
from deep_neuroevolution_tpu.ops import fitness as jfit  # noqa: E402
from deep_neuroevolution_tpu.ops import obstat as jobstat  # noqa: E402
from deep_neuroevolution_tpu.utils import tabular as jtab  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
PORT = {"curve": "humanoid_curve_torch", "nses": "run_humanoid_nses_torch", "assemble": "assemble_humanoid_r05_torch"}
CPU = torch.device("cpu")
D = 159_505  # the 256×256 MujocoMLP on Humanoid-v5's 348 observations and 17 actions
POP, SLOTS, NS_SLOTS = 8, 4, 8
# the ES arm's horizon: this population's rollouts are bit for bit the JAX
# package's through step 5; between steps 5 and 8 one of them (pair 1's
# θ − σε) jumps 8e-3 apart (0.158 by step 15, 2.1e-3 of the largest return,
# 5e-4 m in its final position) while the other seven read within 4e-6 at
# step 8: an ulp of the forward tipping a contact. run_seed's generation, the same
# ESTrainer, is held at 15 steps.
ES_ARM_STEPS = 5


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_humanoid_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


curve_t, nses_t, asm_t = (_script(PORT[k]) for k in ("curve", "nses", "assemble"))


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_scripts(monkeypatch):
    """The JAX scripts, with their tabular rows dropped (they replace the
    module's ``dump_tabular`` themselves: restored after the test)."""
    monkeypatch.setattr(jtab, "dump_tabular", jtab.dump_tabular)
    return {k: _script(k) for k in ("humanoid_curve", "run_humanoid_nses", "assemble_humanoid_r05")}


@pytest.fixture
def noiseless(monkeypatch):
    """Both packages' MujocoMLP without action noise, in the scripts (the
    widths are the scripts' own)."""
    def wrap(cls):
        return lambda **kw: cls(**{**kw, "ac_noise_std": 0.0})

    monkeypatch.setattr(jmodels, "MujocoMLP", wrap(jmodels.MujocoMLP))
    for mod in (curve_t, nses_t):
        monkeypatch.setattr(mod, "MujocoMLP", wrap(mod.MujocoMLP))


class _Built(Exception):
    """Stops a JAX script at its first ``train_step``, with the trainer."""

    def __init__(self, tr):
        super().__init__("built")
        self.tr = tr


def _capture(monkeypatch, cls, cut=None, stop=False):
    """Patches ``cls.train_step``: records the trainer, its config as the
    script built it and its pre-step state, applies ``cut`` to it, then runs
    the step (or raises ``_Built`` with ``stop``)."""
    seen, real = [], cls.train_step

    def step(self):
        rec = dict(tr=self, config=self.config)
        if isinstance(self, jnses.NSESTrainer):
            rec.update(key=self.key, thetas=[np.asarray(p.theta) for p in self.parents], archive=self.archive)
        else:
            rec.update(key=self.state.key, theta=np.asarray(self.state.theta))
        seen.append(rec)
        if stop:
            raise _Built(self)
        if cut:
            cut(self)
        rec["out"] = real(self)
        return rec["out"]

    monkeypatch.setattr(cls, "train_step", step)
    return seen


def _cut_jax(tr, horizon=H15):
    tr.config = dataclasses.replace(tr.config, calc_obstat_prob=0.5)
    tr.cutoff = jes.parse_cutoff(horizon, tr.env.default_timestep_cutoff)


def _cut_port(tr, horizon=H15):
    tr.config = dataclasses.replace(tr.config, calc_obstat_prob=0.5)
    tr.cutoff = tes.parse_cutoff(horizon, tr.env.default_timestep_cutoff)


def _jax_trainer(monkeypatch, js, which):
    """The trainer a JAX script builds (``which``: 'curve', 'es', 'nses'),
    stopped before its first step; its env is closed by the caller."""
    cls = jnses.NSESTrainer if which == "nses" else jes.ESTrainer
    _capture(monkeypatch, cls, stop=True)
    with pytest.raises(_Built) as built:
        if which == "curve":
            js["humanoid_curve"].run_seed(0, 1, 128, SLOTS, 1000, 0.01)
        else:
            js["run_humanoid_nses"].run_arm(which, 1, 128, NS_SLOTS, 4.0, 0)
    return built.value.tr


def _port_trainer(which):
    if which == "curve":
        return curve_t.make_trainer(0, 128, SLOTS, 1000, 0.01, device="cpu")
    return nses_t.make_trainer(which, 128, NS_SLOTS, 4.0, 0, device="cpu")


def _steady(jg, theta0):
    """Where Adam's first step is steady: the port's θ' lies within 1e-6 of
    the JAX one where a 1e-5·max|g| change of g moves it by less than 1e-6
    (tests/test_torch_es.py)."""
    eps_ = 1e-8 / np.sqrt(1 - 0.999)
    G = -jg + 0.005 * theta0
    return 0.01 * eps_ * (1e-5 * np.abs(jg).max()) / (np.abs(G) + eps_) ** 2 < 1e-6


def _check_update(theta0, theta_t, theta_j, table, idxs, returns, second, mode):
    """g from both packages' ranks (equal), and θ' where steady."""
    jw = jfit.process_returns(jnp.asarray(returns), jnp.asarray(second), mode)
    tw = tfit.process_returns(torch.from_numpy(returns), torch.from_numpy(second), mode)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jg = np.asarray(jfit.gradient_from_noise(table, jnp.asarray(idxs), jw[:, 0] - jw[:, 1], D)) / returns.size
    steady = _steady(jg, theta0)
    assert steady.mean() > 0.99
    np.testing.assert_allclose(theta_t[steady], np.asarray(theta_j)[steady], rtol=0, atol=1e-6)


# ------------------------------------------------ (a) imports and the card


@pytest.mark.parametrize("name", sorted(PORT.values()))
def test_scripts_import_no_jax_and_ask_for_a_card(name, tmp_path):
    """Each script imports torch, numpy and the port only; its ``--device``
    defaults to cuda, and without a card its ``main`` raises NoCudaDevice
    before it writes anything."""
    src = (SCRIPTS / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|deep_neuroevolution_tpu)\b", src, re.M)
    assert "deep_neuroevolution_tpu" not in src and "import jax" not in src
    assert re.search(r'"--device", default=None, help="cuda \(default\)', src)
    assert "except" not in src
    if torch.cuda.is_available():
        return
    out = tmp_path / "x_torch.json"
    mod = {v: m for v, m in zip(PORT.values(), (curve_t, nses_t, asm_t))}[name]
    with pytest.raises(NoCudaDevice):
        mod.main(["--out", str(out), "--resume_dir", str(tmp_path / "ckpt")])
    assert not out.exists() and not (tmp_path / "ckpt").exists()


def test_scripts_load_without_jax_modules():
    """Importing the three scripts in a fresh interpreter loads no module of
    jax or of the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"for n in {sorted(PORT.values())!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(n, {str(SCRIPTS)!r} + '/' + n + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'deep_neuroevolution_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


# ------------------------------------------ (b) the trainers the scripts build


@pytest.mark.parametrize("which", ["curve", "es", "nses"])
def test_trainer_matches_the_jax_scripts(which, monkeypatch, jax_scripts):
    """The trainer each script builds at its defaults (population 128,
    cutoff 1000, calc_obstat_prob 0.01) equals the JAX script's: every
    config field the packages share, the model's widths and D = 159,505,
    Adam's step, the 5M-float table bit for bit, the env (Humanoid-v5, or
    the trap world's XML and the final-position BC)."""
    jtr = _jax_trainer(monkeypatch, jax_scripts, which)
    ttr = _port_trainer(which)
    try:
        jcfg, tcfg = dataclasses.asdict(jtr.config), dataclasses.asdict(ttr.config)
        shared = set(jcfg) & set(tcfg)
        assert {"noise_stdev", "l2coeff", "population_size", "calc_obstat_prob", "episode_cutoff_mode",
                "num_eval_episodes", "return_proc_mode"} <= shared
        if which == "nses":
            assert {"k", "meta_population_size", "selection_method", "bc_mode", "algo_type", "num_rollouts"} <= shared
            # no NS trainer reads it: the JAX NSESConfig inherits ES's 8, the port's says 0
            assert (jcfg.pop("num_eval_episodes"), tcfg.pop("num_eval_episodes")) == (8, 0)
            shared.discard("num_eval_episodes")
        for k in sorted(shared):
            assert tcfg[k] == jcfg[k], k
        assert type(ttr).__name__ == type(jtr).__name__
        jm, tm = jtr.model, ttr.model
        for k in ("obs_dim", "ac_dim", "hidden_dims", "nonlin_type", "ac_noise_std", "ac_low", "ac_high"):
            assert tuple(np.ravel(getattr(tm, k))) == tuple(np.ravel(getattr(jm, k))), k
        assert tm.num_params == jm.num_params == D and tm.ac_noise_std == 0.01
        assert type(ttr.optimizer).__name__ == type(jtr.optimizer).__name__ == "Adam"
        assert ttr.optimizer.stepsize == jtr.optimizer.stepsize == 0.01
        assert ttr.noise.size == 5_000_000
        np.testing.assert_array_equal(ttr.noise.noise.numpy(), np.asarray(jtr.noise.noise))
        assert ttr.cutoff._asdict() == jtr.cutoff._asdict()
        assert ttr.env.batch_size == jtr.env.batch_size and ttr.env.obs_shape == jtr.env.obs_shape == (348,)
        assert ttr.env.env_id == jtr.env.env_id == "Humanoid-v5"
        tworld, jworld = (Path(e._envs[0].unwrapped.fullpath).read_text() for e in (ttr.env, jtr.env))
        assert tworld == jworld and ("trap_left" in tworld) == (which != "curve")
        if which != "curve":
            assert ttr.env.bc_mode == jtr.env.bc_mode == "final_pos" and ttr.env.bc_dim == 2
    finally:
        jtr.env.close()
        ttr.close()


# -------------------------------- (c) one generation from the JAX draws


def test_run_seed_generation_matches_jax(monkeypatch, jax_scripts, noiseless):
    """One generation of ``run_seed`` (population 8 on 4 slots: 2 rounds of
    2 pairs; cutoff 15, calc_obstat_prob 0.5, 4 eval episodes) in both
    packages, the JAX draws fed to the port: the recorded curve, eval curve,
    episode length and obs count, the timesteps, and θ'."""
    seen = _capture(monkeypatch, jes.ESTrainer)
    jout = jax_scripts["humanoid_curve"].run_seed(0, 1, POP, SLOTS, H15, 0.5)
    (rec,) = seen
    jtr, jst = rec["tr"], rec["out"]
    key, keval = jax.random.split(rec["key"])
    rounds = []
    for _ in range(2):
        key, k = jax.random.split(key)
        rounds.append(k)
    built, real = [], curve_t.make_trainer

    def make_trainer(*a, **kw):
        tr = real(*a, **kw)
        tr.theta = weights.from_jax(rec["theta"], device="cpu")
        built.append((tr, _feed_jax_batches(tr, rec["theta"], jtr.noise.noise, rounds, 2)))
        tr._draw_eval_seed = lambda: _jax_seed(keval)
        return tr

    monkeypatch.setattr(curve_t, "make_trainer", make_trainer)
    tout = curve_t.run_seed(0, 1, POP, SLOTS, H15, 0.5, device="cpu")
    (ttr, draws), = built
    assert tout["ep_len"] == jout["ep_len"] and tout["timesteps"] == jout["timesteps"]
    assert tout["ob_counts"] == jout["ob_counts"] and tout["ob_counts"][0] > 1e-2  # rollouts were sampled
    assert tout["obstat_fraction"] == jout["obstat_fraction"]
    _allclose(tout["curve"], jout["curve"], "curve")
    _allclose(tout["eval_curve"], jout["eval_curve"], "eval curve")
    _allclose(ttr.ob_stat.sum.numpy(), jtr.state.ob_stat.sum, "ob_stat.sum", OB15)
    _allclose(ttr.ob_stat.sumsq.numpy(), jtr.state.ob_stat.sumsq, "ob_stat.sumsq", OB15)
    assert set(tout) == set(jout) | {"s_per_gen"} and len(tout["s_per_gen"]) == 1
    ret = ttr.last_stats.returns
    np.testing.assert_array_equal(ttr.last_stats.lengths, jst.lengths)
    _allclose(ret, jst.returns, "returns")
    idxs = torch.cat([d[0] for d in draws]).numpy()
    _check_update(rec["theta"], ttr.theta.numpy(), jtr.state.theta, jtr.noise.noise, idxs, ret, np.zeros_like(ret),
                  "centered_rank")


def test_run_arm_es_generation_matches_jax(monkeypatch, jax_scripts, noiseless):
    """One generation of ``run_arm('es')`` on the trap world (population 8 on
    8 slots: one round of 4 pairs), cut alike in both to ES_ARM_STEPS: the
    history's mean return and length, its BC cloud (x min, mean, max; max
    |y|), and θ'."""
    seen = _capture(monkeypatch, jes.ESTrainer, cut=lambda tr: _cut_jax(tr, ES_ARM_STEPS))
    jhist = jax_scripts["run_humanoid_nses"].run_arm("es", 1, POP, NS_SLOTS, 4.0, 0)["history"]
    (rec,) = seen
    jtr, jst = rec["tr"], rec["out"]
    key, keval = jax.random.split(rec["key"])
    key, kround = jax.random.split(key)
    built, real = [], nses_t.make_trainer

    def make_trainer(*a, **kw):
        tr = real(*a, **kw)
        _cut_port(tr, ES_ARM_STEPS)
        tr.theta = weights.from_jax(rec["theta"], device="cpu")
        built.append((tr, _feed_jax_batches(tr, rec["theta"], jtr.noise.noise, [kround], 4)))
        tr._draw_eval_seed = lambda: _jax_seed(keval)
        return tr

    monkeypatch.setattr(nses_t, "make_trainer", make_trainer)
    out = nses_t.run_arm("es", 1, POP, NS_SLOTS, 4.0, 0, device="cpu")
    (ttr, draws), = built
    thist = out["history"]
    assert thist["mean_len"] == jhist["mean_len"] and out["trap_distance"] == 4.0
    _allclose(thist["mean_ret"], jhist["mean_ret"], "mean_ret")
    np.testing.assert_allclose(thist["bc_x"], jhist["bc_x"], rtol=0, atol=BC15)
    np.testing.assert_allclose(thist["bc_y"], jhist["bc_y"], rtol=0, atol=BC15)
    np.testing.assert_allclose(ttr.last_stats.bc.reshape(-1, 2), np.asarray(jtr._last_bcs).reshape(-1, 2), rtol=0,
                               atol=BC15)
    assert float(ttr.ob_stat.count) == float(jtr.state.ob_stat.count)
    ret = ttr.last_stats.returns
    _check_update(rec["theta"], ttr.theta.numpy(), jtr.state.theta, jtr.noise.noise, draws[0][0].numpy(), ret,
                  np.zeros_like(ret), "centered_rank")


def test_run_arm_nses_iteration_matches_jax(monkeypatch, jax_scripts, noiseless):
    """One iteration of ``run_arm('nses')`` (M = 3, k = 10, novelty_prob,
    centered_sign_rank; population 8 on 8 slots, cut alike), the JAX
    parents, archive, draws and θ ± σε batch fed in: the history's mean
    return and length, the rollouts' novelty, θ', and the archive's new
    point (the history's BC) against the JAX package's mean BC of the
    port's updated parent; the archive summary's points; the next parent."""
    seen = _capture(monkeypatch, jnses.NSESTrainer, cut=_cut_jax)
    jout = jax_scripts["run_humanoid_nses"].run_arm("nses", 1, POP, NS_SLOTS, 4.0, 0)
    (rec,) = seen
    jtr, jres = rec["tr"], rec["out"]
    key, keys = rec["key"], []
    for _ in range(6):  # the round, the new mean BC, three selection BCs, the choice
        key, k = jax.random.split(key)
        keys.append(k)
    built, real = [], nses_t.make_trainer

    def make_trainer(*a, **kw):
        tr = real(*a, **kw)
        _cut_port(tr)
        tr.parents = [tnses.Parent(weights.from_jax(th, device="cpu"), tr.optimizer.init(D, CPU),
                                   tobstat.init(tr.env.obs_shape, eps=1e-2, device=CPU)) for th in rec["thetas"]]
        tr.archive = tnov.Archive(torch.from_numpy(np.array(rec["archive"].points)),
                                  torch.tensor(int(rec["archive"].count), dtype=torch.int32))
        tr.curr_parent = 0
        built.append((tr, _feed_jax_batches(tr, rec["thetas"][0], jtr.noise.noise, keys[:1], 4)))
        seeds = [_jax_seed(k) for k in keys[1:]]
        tr._draw_seed = lambda: seeds.pop(0)
        return tr

    monkeypatch.setattr(nses_t, "make_trainer", make_trainer)
    tout = nses_t.run_arm("nses", 1, POP, NS_SLOTS, 4.0, 0, device="cpu")
    (ttr, ((idxs, _),)), = built
    tst, jhist, thist = ttr.last_stats, jout["history"], tout["history"]
    assert thist["mean_len"] == jhist["mean_len"]
    np.testing.assert_array_equal(tst.lengths, jres["lengths"])
    _allclose(thist["mean_ret"], jhist["mean_ret"], "mean_ret")
    np.testing.assert_allclose(tst.novelty, jres["novelty"], rtol=0, atol=BC15)
    ttheta = ttr.parents[0].theta.numpy()
    _check_update(rec["thetas"][0], ttheta, jtr.parents[0].theta, jtr.noise.noise, idxs.numpy(), tst.returns,
                  tst.novelty, "centered_sign_rank")
    tstat = ttr.parents[0].ob_stat
    assert float(tstat.count) == float(jtr.parents[0].ob_stat.count)

    # the new point: the JAX package's mean BC of the port's updated parent
    jenv = jmj.MujocoHostEnv(jtr.env.env_id, batch_size=NS_SLOTS, num_threads=2, xml_file=ttr.env.xml_file)
    jtr.env = jenv
    try:
        jstat = jobstat.RunningStat(*(jnp.asarray(v.numpy()) for v in tstat))
        jnew = np.asarray(jtr._host_mean_bc(jnp.asarray(ttheta), keys[1], JaxCtx(
            jnp.asarray(jobstat.mean(jstat)), jnp.asarray(jobstat.std(jstat)), jnp.asarray(0.0))))
    finally:
        jenv.close()
    np.testing.assert_allclose(tst.new_bc, jnew, rtol=0, atol=BC15)
    assert thist["bc_x"] == [[float(tst.new_bc[0])] * 3] and thist["bc_y"] == [[abs(float(tst.new_bc[1]))]]
    pts = np.asarray(tout["archive_points"])
    assert pts.shape == (4, 2) == np.asarray(jout["archive_points"]).shape
    np.testing.assert_array_equal(pts[:3], np.asarray(jout["archive_points"])[:3])
    np.testing.assert_array_equal(pts[3], tst.new_bc)
    pts32 = pts.astype(np.float32)  # the archive's dtype, which the summary is computed in
    assert tout["archive_x_max"] == float(pts32[:, 0].max())
    assert tout["archive_spread"] == float(pts32.std(axis=0).mean())
    probs = tst.selection_probs
    assert ttr.curr_parent == int(np.random.default_rng(_jax_seed(keys[5])).choice(3, p=probs))


# ------------------------------------------- (d) straight against resumed


def _ckpt_thetas(path):
    st = tckpt.load_pickle(str(path))
    if "nses" in st:
        return [np.asarray(p[0]) for p in st["nses"]["parents"]], st["nses"]["archive"]
    return [np.asarray(st["es"]["theta"])], None


@pytest.mark.parametrize("which", ["curve", "es", "nses"])
def test_resumed_run_equals_the_straight_one(which, tmp_path):
    """Three generations straight through against two and a resumed third,
    each in its own resume directory (population 8, cutoff 30, action noise
    on, the scripts' calc_obstat_prob): every recorded number and the
    snapshot's θ (every parent's, and the archive, for NS-ES) bit for bit."""
    a, b = tmp_path / "straight", tmp_path / "resumed"
    if which == "curve":
        def run(gens, d):
            return curve_t.run_seed(0, gens, POP, SLOTS, 30, 0.5, resume_dir=str(d), device="cpu")
        ckpt = "seed0.ckpt"
    else:
        def run(gens, d):
            return nses_t.run_arm(which, gens, POP, NS_SLOTS, 4.0, 0, resume_dir=str(d), device="cpu")
        ckpt = f"{which}.ckpt"
    straight = run(3, a)
    run(2, b)
    resumed = run(3, b)
    straight.pop("s_per_gen", None), resumed.pop("s_per_gen", None)
    if which != "curve":
        straight["history"].pop("s_per_gen"), resumed["history"].pop("s_per_gen")
    assert resumed == straight
    (ta, arch_a), (tb, arch_b) = _ckpt_thetas(a / ckpt), _ckpt_thetas(b / ckpt)
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x, y)
    if which == "nses":
        np.testing.assert_array_equal(np.asarray(arch_a[0]), np.asarray(arch_b[0]))
        assert int(arch_a[1]) == int(arch_b[1]) == 6  # 3 parents + 3 iterations
    if which == "curve":
        assert len(straight["curve"]) == 3 and straight["ob_counts"][-1] > 0


# ------------------------------------------------- (e) the artifacts' keys


def _keys_match(port: dict, jax_art: dict, extra=frozenset({"s_per_gen"})) -> None:
    """The JAX artifact's keys plus ``device``; below them each dict's keys
    plus ``s_per_gen`` where the port records it, and ``config`` (the
    flags) plus ``seed_list`` (a flag newer than the committed artifact) and
    ``device``."""
    assert set(port) == set(jax_art) | {"device"}
    for k, v in jax_art.items():
        if isinstance(v, dict):
            assert isinstance(port[k], dict)
            if k == "config":
                assert set(v) <= set(port[k]) <= set(v) | {"seed_list", "device"}
            elif k == "seeds":  # the seeds themselves differ between the runs
                for s in port[k].values():
                    _nested(s, next(iter(v.values())), extra)
            else:
                _nested(port[k], v, extra)


def _nested(port: dict, jax_art: dict, extra) -> None:
    assert set(port) == set(jax_art) | (extra & set(port)), (sorted(port), sorted(jax_art))
    for k, v in jax_art.items():
        if isinstance(v, dict):
            _nested(port[k], v, extra)


def test_curve_artifact_keeps_the_jax_keys(tmp_path):
    art = curve_t.main(["--device", "cpu", "--seed_list", "3", "--gens", "1", "--pop", str(POP), "--batch_size",
                        str(SLOTS), "--tslimit", "20", "--out", str(tmp_path / "c_torch.json")])
    assert json.loads((tmp_path / "c_torch.json").read_text()) == json.loads(json.dumps(art))
    _keys_match(art, json.loads((ROOT / "results" / "humanoid_curve.json").read_text()))
    assert list(art["seeds"]) == ["3"] and art["device"]["card"] == "cpu" and art["config"]["device"] == "cpu"


def test_nses_artifact_keeps_the_jax_keys(tmp_path):
    art = nses_t.main(["--device", "cpu", "--gens", "1", "--pop", str(POP), "--batch_size", str(NS_SLOTS),
                       "--resume_dir", str(tmp_path / "ckpt"), "--out", str(tmp_path / "n_torch.json")])
    _keys_match(art, json.loads((ROOT / "results" / "humanoid_nses.json").read_text()))
    assert len(art["nses"]["archive_points"]) == 4 and sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "es.ckpt", "es.json", "nses.ckpt", "nses.json"]


# --------------------------------------------------------- (f) the assembler


def _synthetic(n: int, seed: int, drift: bool) -> dict:
    """A per-generation JSON as the curve scripts write: a rising curve,
    falling back at the end where ``drift``; a NaN eval here and there."""
    rs = np.random.RandomState(seed)
    c = 130 + 4.0 * np.arange(n) + rs.randn(n) * 5
    if drift:
        c[-25:] *= 0.4
    ev = (c + rs.randn(n) * 20).tolist()
    ev[1] = float("nan")
    return {"curve": c.tolist(), "eval_curve": ev, "ep_len": (25 + rs.rand(n) * 40).tolist(),
            "ob_counts": np.cumsum(rs.rand(n) * 300).tolist(), "timesteps": 1000 * n}


def test_drift_matches_jax(jax_scripts):
    """``_drift`` equals the JAX script's on the committed pop-512 curve, on
    synthetic curves with and without a fall, on a flat zero curve and below
    two windows."""
    jd = jax_scripts["assemble_humanoid_r05"]._drift
    committed = json.loads((ROOT / "results" / "humanoid_curve_pop512_300.json").read_text())["seeds"]["0"]["curve"]
    curves = [committed, _synthetic(45, 1, True)["curve"], _synthetic(60, 2, False)["curve"], [0.0] * 40,
              committed[:39], committed[:40]]
    for c in curves:
        for w in (20, 5):
            assert asm_t._drift(c, w) == jd(c, w)
    assert asm_t._drift(committed[:39]) is None and asm_t._drift([0.0] * 40)["final_over_peak"] is None


def test_assembler_output_matches_jax(tmp_path, monkeypatch, jax_scripts):
    """The JAX assembler's ``main`` with its ``REPO`` at a temporary copy
    (the committed results/humanoid_curve_pop512_300.json, synthetic seeds
    1 and 2 and a synthetic pop-1000 run) against the port's ``main`` on
    the same files: both outputs equal but for ``workload`` and ``device``.
    The port refuses to write a JAX artifact of the repo's results/."""
    res = tmp_path / "results"
    (res / "humanoid_pop512_ckpt").mkdir(parents=True)
    (res / "humanoid_pop1000_ckpt").mkdir()
    shutil.copy(ROOT / "results" / "humanoid_curve_pop512_300.json", res)
    for s, (n, drift) in {"1": (45, True), "2": (10, False)}.items():
        (res / "humanoid_pop512_ckpt" / f"seed{s}.json").write_text(json.dumps(_synthetic(n, int(s), drift)))
    (res / "humanoid_pop1000_ckpt" / "seed0.json").write_text(json.dumps(_synthetic(50, 7, False)))
    monkeypatch.setattr(jax_scripts["assemble_humanoid_r05"], "REPO", str(tmp_path))
    jax_scripts["assemble_humanoid_r05"].main()
    port = tmp_path / "port"
    argv = ["--curve", str(res / "humanoid_curve_pop512_300.json"), "--resume_dir", str(res / "humanoid_pop512_ckpt"),
            "--out", str(port / "seeds_torch.json"), "--long_run", str(res / "humanoid_pop1000_ckpt" / "seed0.json"),
            "--long_out", str(port / "pop1000_torch.json"), "--device", "cpu"]
    asm_t.main(argv)
    for jname, tname in (("humanoid_curve_pop512_3seeds.json", "seeds_torch.json"),
                         ("humanoid_curve_pop1000.json", "pop1000_torch.json")):
        want = json.loads((res / jname).read_text())
        got = json.loads((port / tname).read_text())
        assert got.pop("device")["card"] == "cpu"
        want.pop("workload"), got.pop("workload")
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), jname
    seeds = json.loads((port / "seeds_torch.json").read_text())
    assert sorted(seeds["seeds"]) == ["0", "1", "2"] and seeds["no_drift_all_seeds"] is False
    for bad in ("humanoid_curve_pop512_3seeds.json", "humanoid_curve_pop1000.json"):
        before = (ROOT / "results" / bad).read_bytes() if (ROOT / "results" / bad).exists() else None
        with pytest.raises(ValueError, match="_torch.json"):
            asm_t.main([*argv[:4], "--out", str(ROOT / "results" / bad), "--device", "cpu"])
        with pytest.raises(ValueError, match="_torch.json"):
            asm_t.main([*argv, "--long_out", str(ROOT / "results" / bad)])
        assert ((ROOT / "results" / bad).read_bytes() if (ROOT / "results" / bad).exists() else None) == before
