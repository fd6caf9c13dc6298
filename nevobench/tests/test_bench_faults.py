"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven at the
CPU's size, once for each fault a population step can have.

* ``answer_altered``: every action of the first group is changed where it
  is produced (the next action of the set);
* ``half_batch``: the forward runs on the first half of each group's
  members and the rest take the first half's actions;
* ``state_unchanged``: the frame stack is never updated, so every step
  acts on the first step's frames.
"""

import pytest
import torch

from cells import WORKLOADS, small_cells  # noqa: F401  (a fixture)
from nevobench import run


def _answer_altered(act_fn, num_actions):
    def fn(params, obs):
        a = act_fn(params, obs)
        return (a + 1) % num_actions
    fn.prepare = act_fn.prepare
    return fn


def _half_batch(act_fn):
    def fn(params, obs):
        n = obs.shape[0] // 2
        parts, ctx = params
        half = ({k: v[:n] for k, v in parts.items()} if not any(k.startswith("__") for k in parts)
                else {k: {kk: vv[:n] for kk, vv in v.items()} for k, v in parts.items()})
        if ctx is not None:
            ctx = type(ctx)(*(tuple(leaf[:n] for leaf in field) for field in ctx))
        a = act_fn((half, ctx), obs[:n])
        return torch.cat([a, a])[: obs.shape[0]]
    fn.prepare = act_fn.prepare
    return fn


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch", "state_unchanged"])
def test_fault_is_not_correct(small_cells, monkeypatch, workload, fault):
    cell = small_cells(workload)
    loop = cell.loop
    real_start = loop.Run._start_program

    def start(self, tr):
        if fault == "state_unchanged":
            monkeypatch.setattr(loop, "stack_step", lambda stack, frame: stack)
        real_make = self.cfgmod.program

        def program(cfg):
            model = real_make(cfg)
            make = model.make_batch_act
            if fault == "answer_altered":
                wrapped = lambda: _answer_altered(make(), cfg["num_actions"])  # noqa: E731
            elif fault == "half_batch":
                wrapped = lambda: _half_batch(make())  # noqa: E731
            else:
                return model
            object.__setattr__(model, "make_batch_act", wrapped)
            return model

        monkeypatch.setattr(self.cfgmod, "program", program)
        real_start(self, tr)

    monkeypatch.setattr(loop.Run, "_start_program", start)
    result = run.run_cell(workload, 2**31 + 99, 0.2, False, "cpu")
    assert result["correct"] is False and result["failed"] > 0
    check = result["checks"]["action_gap_max"]
    assert check["value"] > check["limit"]
