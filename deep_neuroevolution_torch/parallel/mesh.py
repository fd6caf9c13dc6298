"""The ``pop`` axis of a pod: its ranks, the blocks of rows they own, and
the collectives over them.

The counterpart of the JAX package's parallel/mesh.py. There, the
population is sharded over a 1-D ``pop`` mesh of devices (``make_pop_mesh``,
``pop_sharded``) and θ and the noise table are replicated
(``replicated``). In the port the ``pop`` axis is the process group of
``torch.distributed`` (one rank per card; parallel/distributed.py): θ, the
table and the trainer's generator are replicated by construction (every
rank builds them from the same seed and applies the same update), and a
rank owns the rows of its blocks.

A ``PopGroup`` holds the ranks that this process runs (``pids``): its own
rank in a real world, or all ``size`` ranks one after the other when it
emulates a world (``emulate_procs``). Each collective takes one value per
rank in ``pids`` and returns the same on every rank: a process group runs
the collective of parallel/distributed.py (a world of one too), an emulated
world or a process without a group combines the values in rank order. Two
operands sum to the same float in either order, so at two ranks the
emulation equals the real world bit for bit.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import distributed

class PopGroup:
    """A world of ``size`` ranks, ``pids`` of which run in this process.

    ``calls`` counts the collectives a process group ran. ``seconds``, their
    wall time with the device work queued before each one excluded, is kept
    only when ``timed`` is set (a measurement harness sets it on the class):
    it syncs the card before and after every collective, which a training
    run does not pay for."""

    timed = False

    def __init__(self, size: int, rank: int, device: torch.device, emulated: bool = False, joined: bool = False):
        self.size, self.rank, self.device, self.emulated = int(size), int(rank), torch.device(device), emulated
        self.joined = joined and not emulated  # a process group exists: collectives run, at one rank too
        self.pids: Sequence[int] = tuple(range(self.size)) if emulated else (self.rank,)
        self.seconds = 0.0
        self.calls = 0

    @property
    def writes(self) -> bool:
        """Rank 0 (or the emulation) writes logs and snapshots."""
        return self.emulated or self.rank == 0

    def block(self, n: int, p: int):
        """Rank ``p``'s contiguous rows ``[lo, hi)`` of ``n``: ⌈n / size⌉ a
        rank, the last ranks fewer, possibly none."""
        per = -(-n // self.size)
        return min(p * per, n), min((p + 1) * per, n)

    # ----------------------------------------------------------- collectives

    def _collective(self, fn):
        if not self.joined:
            return fn()
        self.calls += 1
        if not self.timed:
            return fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t0
        return out

    def gather(self, parts: List):
        """Each rank's rows (equal shapes; tensors or numpy), concatenated
        in rank order; numpy in, numpy out."""
        assert len(parts) == len(self.pids)
        if not self.joined:
            return np.concatenate(parts) if isinstance(parts[0], np.ndarray) else torch.cat(parts)
        x = parts[0]
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x.view(np.uint8) if x.dtype == bool else x))
            out = self._collective(lambda: distributed.all_gather(t.to(self.device))).cpu().numpy()
            return out.view(bool) if x.dtype == bool else out
        return self._collective(lambda: distributed.all_gather(x))

    def gather_ragged(self, parts: List, counts: Sequence[int]):
        """As ``gather``, where rank p holds ``counts[p]`` rows (padded to
        the largest count for the collective)."""
        width = max(max(counts), 1)

        def pad(x, p):
            n = width - counts[p]
            if n == 0:
                return x
            if isinstance(x, np.ndarray):
                return np.concatenate([x, np.zeros((n,) + x.shape[1:], x.dtype)])
            return torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))])

        out = self.gather([pad(x, p) for x, p in zip(parts, self.pids)])
        keep = np.concatenate([np.arange(p * width, p * width + counts[p]) for p in range(self.size)])
        return out[keep] if isinstance(out, np.ndarray) else out[torch.as_tensor(keep, device=out.device)]

    def sum(self, parts: List):
        """The sum over ranks of each rank's value (a tensor, a number or
        None: nothing to sum), added in rank order."""
        assert len(parts) == len(self.pids)
        if parts[0] is None:
            return None
        if not self.joined:
            total = parts[0]
            for x in parts[1:]:
                total = total + x
            return total
        x = parts[0]
        if torch.is_tensor(x):
            return self._collective(lambda: distributed.all_reduce_sum(x))
        t = torch.tensor(float(x), dtype=torch.float64, device=self.device)
        return float(self._collective(lambda: distributed.all_reduce_sum(t)))

    def broadcast(self, obj):
        """Rank 0's ``obj`` (numpy or plain Python) on every rank; others pass
        anything."""
        return self._collective(lambda: distributed.broadcast_object(obj)) if self.joined else obj

    def gather_objects(self, parts: List) -> list:
        """Each rank's value, in rank order."""
        if not self.joined:
            return list(parts)
        return self._collective(lambda: distributed.all_gather_object(parts[0]))


def pop_group(device, emulate_procs: Optional[int] = None) -> PopGroup:
    """The pod of this process: the torch.distributed world (a world of one
    without one), or an emulated world of ``emulate_procs`` ranks, all run
    here. Emulating inside a real world of more than one rank is refused."""
    if emulate_procs is not None:
        if distributed.process_count() > 1:
            raise ValueError("emulate_procs runs a world in one process; this process is a rank of a world of "
                             f"{distributed.process_count()}")
        if int(emulate_procs) < 1:
            raise ValueError(f"emulate_procs must be at least 1, not {emulate_procs}")
        return PopGroup(int(emulate_procs), 0, device, emulated=True)
    return PopGroup(distributed.process_count(), distributed.process_index(), device,
                    joined=distributed.backend() is not None)


def interleave(x, size: int, rounds: int):
    """Rows gathered rank-major (each rank's ``rounds`` blocks in turn) →
    round-major: block (r, p) at position r·size + p, the order in which
    every rank drew them."""
    if size == 1 or rounds == 1:
        return x
    if isinstance(x, np.ndarray):
        return x.reshape((size, rounds, -1) + x.shape[1:]).swapaxes(0, 1).reshape(x.shape)
    return x.reshape((size, rounds, -1) + tuple(x.shape[1:])).transpose(0, 1).reshape(x.shape)
