"""VINE snapshot dumps: per-generation behavior-cloud files for the visual
inspector.

The port's own copy of the JAX package's utils/vine.py (after
es_distributed/es_modified.py:140-199 and ga_modified.py:22-64). Per
generation, under ``snapshots/snapshot_gen_XXXX/``:

* ``snapshot_offspring_XXXX.dat``: one space-separated row per rollout,
  [bc (bc_dim floats, the final BC), fitness, length, noise_idx,
  policy_seed, sign] (es_modified.py:179-199);
* ``snapshot_parent_XXXX.dat``: one row for the eval rollout closest to the
  mean eval return, [bc, fitness, length, seed, noise_stdev]
  (es_modified.py:156-177);
* ``snapshot_parent_XXXX.h5``: the parent policy, a policy file of
  utils/checkpoint.py that both packages read (a pickle under the
  reference's name), and ``snapshot_parent_XXXX_rb.p``, the pickled
  reference batch (es_modified.py:149-153).

For the same inputs the ``.dat`` files are the JAX package's byte for byte
(``np.savetxt`` with ``%.10g``), so either package's inspector reads
either's. ``policy_seeds`` may also be ``[n, 2]``, one seed per rollout
(the port's host engine gives a pair's two members their own engine
episode seeds unless ``mirror_crn`` is on).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from .checkpoint import save_policy_snapshot, to_numpy


def _gen_dir(base: str, iteration: int) -> str:
    path = os.path.join(base, "snapshots", f"snapshot_gen_{int(iteration):04d}")
    os.makedirs(path, exist_ok=True)
    return path


def master_extract_cloud(
    base_dir: str,
    iteration: int,
    bcs_n2,  # [n, 2, bc_dim] the (θ+σε, θ−σε) members' final BCs
    returns_n2,  # [n, 2]
    lengths_n2,  # [n, 2]
    noise_idxs,  # [n]
    policy_seeds,  # [n], or [n, 2] one per rollout
) -> str:
    """Offspring cloud rows, antithetic pairs flattened with sign ±1
    (es_modified.py:179-199 row layout)."""
    bcs_n2, returns_n2, lengths_n2, noise_idxs, policy_seeds = (
        to_numpy(x) for x in (bcs_n2, returns_n2, lengths_n2, noise_idxs, policy_seeds))
    if policy_seeds.ndim == 1:
        policy_seeds = np.stack([policy_seeds, policy_seeds], axis=1)
    path = _gen_dir(base_dir, iteration)
    fname = os.path.join(path, f"snapshot_offspring_{int(iteration):04d}.dat")
    rows = []
    for i in range(bcs_n2.shape[0]):
        for col, sign in ((0, 1.0), (1, -1.0)):
            rows.append(np.hstack([bcs_n2[i, col].astype(np.float64), returns_n2[i, col], lengths_n2[i, col],
                                   noise_idxs[i], policy_seeds[i, col], sign]))
    np.savetxt(fname, np.asarray(rows), fmt="%.10g", delimiter=" ")
    return fname


def master_extract_parent(
    base_dir: str,
    iteration: int,
    eval_bcs,  # [e, bc_dim]
    eval_rets,  # [e]
    eval_lens,  # [e]
    noise_stdev: float,
    model=None,
    theta=None,
    ref_batch=None,
    seed: int = 0,
) -> Optional[str]:
    """The parent point, the eval rollout closest to the mean eval return
    (es_modified.py:163-167), plus the parent's policy file and reference
    batch. Returns the ``.dat`` path, or None without eval rollouts."""
    path = _gen_dir(base_dir, iteration)
    if model is not None and theta is not None:
        save_policy_snapshot(os.path.join(path, f"snapshot_parent_{int(iteration):04d}.h5"), model, theta,
                             ref_batch=ref_batch)
    if ref_batch is not None:
        with open(os.path.join(path, f"snapshot_parent_{int(iteration):04d}_rb.p"), "wb") as f:
            pickle.dump(to_numpy(ref_batch), f)
    eval_rets = to_numpy(eval_rets)
    if eval_rets.size == 0:
        return None
    eval_bcs, eval_lens = to_numpy(eval_bcs), to_numpy(eval_lens)
    target = int(np.mean(eval_rets))
    idx = int(np.abs(eval_rets - target).argmin())
    row = np.hstack([eval_bcs[idx].astype(np.float64), eval_rets[idx], eval_lens[idx], seed, noise_stdev])
    fname = os.path.join(path, f"snapshot_parent_{int(iteration):04d}.dat")
    np.savetxt(fname, row[None, :], fmt="%.10g", delimiter=" ")
    return fname
