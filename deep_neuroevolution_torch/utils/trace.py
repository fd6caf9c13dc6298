"""Named spans of the program's layers on ``torch.profiler``'s timeline.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records, and one shared no-op context otherwise: off, a span costs an
attribute read and makes no dispatcher call. A recorded span lies in the
profiler's one timeline, which aligns the device's kernels and copies to
the host clock, so a reader of the trace gives each device operation to
the innermost span open on the host at its launch. No span keeps a clock
of its own.

The names speak of the program's layers: ``preprocess.frames`` and
``preprocess.stack`` (envs/preprocess.py); ``model.convs``, ``model.fc``,
``model.fused`` and ``model.out`` (the population forward of the DQN
models); ``rollout.*`` (algos/rollout_host.py); ``es.*``, ``ga.*`` and
``nses.*`` (the trainers).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()

if hasattr(_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a profiler records (the flag its ``__enter__`` sets)."""
        return _profiler._is_profiler_enabled
else:  # a torch without the flag: the dispatcher's own, slower check
    recording = torch.autograd._profiler_enabled


def span(name: str):
    """A context that marks ``name`` on the profiler's timeline while one
    records, else nothing."""
    return torch.profiler.record_function(name) if recording() else _OFF
