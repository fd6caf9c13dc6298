"""Load VINE snapshot .dat files (utils/vine.py layout).

The port's copy of the JAX package's inspector/load_data.py, numpy only
(visual_inspector/figure_base/load_data.py semantics: the parent row via
``np.loadtxt``, the offspring rows as space-separated columns
``[bc (bc_dim), fitness, length, noise_idx, policy_seed, sign]``)."""

from __future__ import annotations

import glob
import os
import re
from typing import List, NamedTuple

import numpy as np


class ParentPoint(NamedTuple):
    bc: np.ndarray  # [bc_dim]
    fitness: float
    length: float
    extras: np.ndarray  # trailing columns (seed, noise_stdev)


class OffspringCloud(NamedTuple):
    bc: np.ndarray  # [n, bc_dim]
    fitness: np.ndarray  # [n]
    length: np.ndarray  # [n]
    noise_idx: np.ndarray  # [n]
    policy_seed: np.ndarray  # [n]
    sign: np.ndarray  # [n]


def _gen_dir(path: str, gen: int) -> str:
    return os.path.join(path, "snapshots", f"snapshot_gen_{gen:04d}")


def list_generations(path: str) -> List[int]:
    gens = []
    for d in glob.glob(os.path.join(path, "snapshots", "snapshot_gen_*")):
        m = re.search(r"snapshot_gen_(\d+)$", d)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


def load_parent(path: str, gen: int, bc_dim: int = 2) -> ParentPoint:
    data = np.loadtxt(os.path.join(_gen_dir(path, gen), f"snapshot_parent_{gen:04d}.dat"))
    return ParentPoint(data[:bc_dim], float(data[bc_dim]), float(data[bc_dim + 1]), data[bc_dim + 2 :])


def load_offspring(path: str, gen: int, bc_dim: int = 2) -> OffspringCloud:
    data = np.loadtxt(os.path.join(_gen_dir(path, gen), f"snapshot_offspring_{gen:04d}.dat"), ndmin=2)
    return OffspringCloud(
        data[:, :bc_dim],
        data[:, bc_dim],
        data[:, bc_dim + 1],
        data[:, bc_dim + 2].astype(np.int64),
        data[:, bc_dim + 3].astype(np.int64),
        data[:, bc_dim + 4],
    )
