"""Hyperparameter schedules (the GA's mutation power).

The counterpart of the JAX package's ops/schedules.py, after
gpu_implementation/neuroevolution/helper.py:46-88: Constant, Linear and
Exponential schedules keyed on a named progress ``field`` (e.g. frames
elapsed), built by ``make_schedule`` from a bare number or a
``{"type": ..., ...}`` dict of the experiment JSON.

Schedules run on the host. ``value`` returns a numpy float32 computed in
float32 as the JAX package computes it, so the mutation powers written into
the genomes are the same numbers in both packages.
"""

from __future__ import annotations

import numbers

import numpy as np

_F32 = np.float32


class ConstantSchedule:
    def __init__(self, value):
        self._value = value

    def value(self, **kwargs) -> np.float32:
        return _F32(self._value)


class LinearSchedule:
    """initial_p → final_p linearly over ``schedule`` units of ``field``
    (helper.py:54-64), clamped at final_p."""

    def __init__(self, schedule, final_p, initial_p, field):
        self.schedule = schedule
        self.field = field
        self.final_p = final_p
        self.initial_p = initial_p

    def value(self, **kwargs) -> np.float32:
        if self.field not in kwargs:
            raise KeyError(f"schedule field {self.field!r} not in {list(kwargs)}")
        fraction = np.minimum(_F32(kwargs[self.field]) / _F32(self.schedule), _F32(1.0))
        return _F32(self.initial_p) + fraction * _F32(self.final_p - self.initial_p)


class ExponentialSchedule:
    """Geometric interpolation: exp of a linear schedule in log space
    (helper.py:67-81)."""

    def __init__(self, initial_p, final_p, schedule, field):
        self.initial_p = initial_p
        self.final_p = final_p
        self.schedule = schedule
        self.field = field
        self.linear = LinearSchedule(
            initial_p=float(np.log(_F32(initial_p))),
            final_p=float(np.log(_F32(final_p))),
            schedule=schedule,
            field=field,
        )

    def value(self, **kwargs) -> np.float32:
        return np.exp(self.linear.value(**kwargs))


def make_schedule(args):
    """Number → ConstantSchedule; dict → the schedule its ``type`` names
    (helper.py:84-88)."""
    if isinstance(args, numbers.Number):
        return ConstantSchedule(args)
    types = {
        "ConstantSchedule": ConstantSchedule,
        "LinearSchedule": LinearSchedule,
        "ExponentialSchedule": ExponentialSchedule,
    }
    return types[args["type"]](**{k: v for k, v in args.items() if k != "type"})
