"""The population step of a host-engine Atari rollout, without the engine.

Each step follows the program's ``rollout_host_batch``
(deep_neuroevolution_torch/algos/rollout_host.py) for every pipeline group
in turn: wait for the group's actions (``.cpu()``), preprocess its new
frames and push them onto its 4-frame stack (``preprocess_obs``,
``stack_step``), queue its population forward (the model's
``make_batch_act``). The engine's step and the frames' upload are left
out: the frames come from a ring of ``frame_ring`` steps of uint8 frame
pairs already on the device, step k reading ring entry k mod R. They do not
depend on the actions, so no slot ends and no episode resets.

The members are prepared once per group (``act_fn.prepare``), as a rollout
does. Every action read back is kept; ``check`` compares each one with the
reference's scores of the stack it was computed from.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deep_neuroevolution_torch.algos.rollout_host import _slice_params
from deep_neuroevolution_torch.envs.preprocess import preprocess_obs, stack_reset, stack_step
from nevobench import compare, inputs, tracing
from nevobench.reference import common


class Run:
    """One cell's program, inputs and loop state on ``device``."""

    def __init__(self, cell, seed: int, device: torch.device, program: bool = True):
        """Make the inputs from ``seed``; with ``program``, set the program
        up on them and warm up every shape the loop uses."""
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.cfgmod, self.device = cfg, cell.config_module, device
        self.B, self.G, self.R = cfg["population_size"], tr["pipeline_groups"], tr["frame_ring"]
        if self.B % self.G:
            raise ValueError(f"{self.B} members do not split into {self.G} groups")
        self.mode, self.hw = tr["obs_mode"], cfg["in_hw"]
        Bg = self.B // self.G
        self.groups = [slice(g * Bg, (g + 1) * Bg) for g in range(self.G)]
        self.span = tracing.nullspan
        self.setup_phases = {}  # seconds of each part of set-up
        t = time.perf_counter()
        gen = inputs.generator(seed, device)
        self.inputs = self.cfgmod.make_inputs(cfg, tr, self.B, gen, device)
        self.ring = inputs.gray_frames(gen, (self.R, self.B, 2, *tr["frame_hw"]), tr["frame_cell"], device)
        self._phase("inputs", t)
        if program:
            self._start_program(tr)

    def _phase(self, name: str, t: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_phases[name] = time.perf_counter() - t

    def _start_program(self, tr: dict) -> None:
        t = time.perf_counter()
        cfg = self.cfg
        self.model = self.cfgmod.program(cfg)
        self.act_fn = self.model.make_batch_act()
        params = self.cfgmod.program_params(self.model, self.inputs)
        self.params = [self.act_fn.prepare(_slice_params(params, s)) for s in self.groups]
        del params
        self._phase("program", t)
        t = time.perf_counter()
        self.actions = np.empty((1024, self.B), np.int16)  # row k: step k's actions; grown by doubling
        self.stacks = [stack_reset(self._obs(0, g)) for g in range(self.G)]
        self.pending = [self.act_fn(self.params[g], self.stacks[g]) for g in range(self.G)]
        self.k = 0  # the step of the pending forwards
        self.reset_counters()
        for _ in range(tr["warmup_steps"]):
            self.step()
        self._phase("warm_up", t)
        self.reset_counters()

    def _obs(self, k: int, g: int) -> torch.Tensor:
        return preprocess_obs(self.ring[k % self.R][self.groups[g]], self.mode, self.hw, self.hw)

    def reset_counters(self) -> None:
        self.steps = 0  # steps taken since the reset
        self.host_s = 0.0  # host seconds queueing their work, waits left out

    @property
    def member_steps(self) -> int:
        return self.steps * self.B

    def step(self) -> None:
        """One step of every group: read its actions, queue the next."""
        span, k = self.span, self.k
        for g, sl in enumerate(self.groups):
            with span("bench.wait_actions"):
                acts = self.pending[g].cpu().numpy()
            if k == len(self.actions):
                self.actions = np.concatenate([self.actions, np.empty_like(self.actions)])
            self.actions[k, sl] = acts
            t = time.perf_counter()
            with span("bench.preprocess"):
                self.stacks[g] = stack_step(self.stacks[g], self._obs(k + 1, g))
            with span("bench.forward"):
                self.pending[g] = self.act_fn(self.params[g], self.stacks[g])
            self.host_s += time.perf_counter() - t
        self.k = k + 1
        self.steps += 1

    def drain(self) -> None:
        """Wait until the device has finished every queued step."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Read the last step's actions and free the program's state."""
        last = np.concatenate([p.cpu().numpy() for p in self.pending]).astype(np.int16)
        self.actions = np.concatenate([self.actions[: self.k], last[None]])
        del self.params, self.stacks, self.pending, self.model, self.act_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def positions(self, n: int):
        """The 4 ring entries of the stack of each of steps 0 … n − 1 (−1:
        the zero history of the first steps), and each step's index into
        the distinct ones."""
        keys, index = {}, []
        for k in range(n):
            key = tuple((j % self.R) if j >= 0 else -1 for j in range(k - 3, k + 1))
            index.append(keys.setdefault(key, len(keys)))
        return list(keys), np.asarray(index)

    def reference_scores(self, n: int, precision=None, block: int = 2) -> torch.Tensor:
        """The reference's scores ``[P, B, A]`` of every distinct stack of
        steps 0 … n − 1 (at ``precision``; None: the configuration's),
        ``block`` stacks at a time."""
        order, _ = self.positions(n)
        pre = torch.stack([common.preprocess_gray(f, self.hw) for f in self.ring])  # [R, B, h, w]
        kw = {} if precision is None else {"precision": precision}
        scores = self.cfgmod.reference(self.cfg, self.inputs, **kw)
        out = [scores(common.stacks_of(pre, order[p:p + block])).float().cpu() for p in range(0, len(order), block)]
        return torch.cat(out)

    def check(self, first: int) -> dict:
        """Every action read back against the reference, at the limit of
        the configuration's ``check.gap_limit``: see compare.py.
        ``first``: the step the counted window starts at."""
        n = len(self.actions)
        _, index = self.positions(n)
        return compare.action_gaps(self.reference_scores(n), index, self.actions, self.cfg["check"]["gap_limit"], first)
