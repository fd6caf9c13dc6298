"""The process group of a pod, and the collectives the pod trainers use.

The counterpart of the JAX package's parallel/distributed.py. The JAX
package joins a slice through ``jax.distributed.initialize``; the port is
one process per card, started by ``torchrun``
(``python -m torch.distributed.run --nproc_per_node N ...``), which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each process's environment. ``init_multihost`` joins
that world; without a torchrun environment (and no ``init_method``) it does
nothing and the process is a world of one, as every entry point runs
without torchrun.

Backends: NCCL when each rank has a card of its own, gloo on the CPU. Two
ranks that share one card cannot form an NCCL communicator ("Duplicate GPU
detected"), so they ask for gloo themselves (``backend="gloo"``); nothing
switches backends quietly.

Gloo on CUDA tensors: the collectives the pods use, ``all_gather`` and
``all_reduce`` of CUDA tensors and the object collectives, all run on the
gloo backend as they are (on an H100 with PyTorch 2.11; gloo itself goes
through host memory inside them), so none is copied to the host here.
Between cards on NCCL, ``all_gather`` and ``all_reduce_sum`` keep their
tensors on the card. The object collectives (``broadcast_object``,
``all_gather_object``) pickle through host memory on any backend; the
host pods send with them what rank 0's engine alone plays (the VBN
reference batch, ES's eval episodes, NS-ES's mean BCs;
parallel/host_pod.py), NS-ES's trajectory BCs (host arrays of ragged
length; parallel/nses_pod.py), and ``check_replicated`` its digests.

Only rank 0 writes: ``is_coordinator`` gates the tabular log, TensorBoard
events, trainer snapshots, policy files and VINE dumps, as the JAX
package's host 0 does (its main.py:49, 57, 90, 103).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a card of the rank's own, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_multihost(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> bool:
    """Joins the world of ``torchrun`` (the ``env://`` variables), or of an
    explicit ``init_method`` such as ``file:///tmp/store`` or
    ``tcp://localhost:29500`` with ``world_size`` and ``rank``. ``backend``
    defaults to NCCL when ``device`` (default: this rank's card) is a CUDA
    device and gloo otherwise. Returns True when it made the process group,
    False when one exists already or there is no world to join (no torchrun
    environment and no ``init_method``)."""
    if dist.is_initialized():
        return False
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    from ..device import resolve_device

    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, world_size=int(world_size if world_size is not None else 1),
                  rank=int(rank if rank is not None else 0))
    dist.init_process_group(backend, **kw)
    return True


def shutdown() -> None:
    """Leaves the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on rank 0, the only rank that writes logs and snapshots (the
    reference's single master, es.py:141-353)."""
    return process_index() == 0


def coordinator_only(fn):
    """Decorator: run only on rank 0."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if is_coordinator():
            return fn(*a, **kw)
        return None

    return wrapper


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.cat(out)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's ``t``."""
    x = t.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable; numpy, not device tensors) on every
    rank."""
    box = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def check_replicated(digest: str, what: str) -> None:
    """Raises on every rank unless every rank passed the same ``digest`` of
    its replicated ``what``."""
    got = all_gather_object(digest)
    if len(set(got)) != 1:
        raise RuntimeError(f"the ranks ended with different {what}: " + ", ".join(
            f"rank {r} {d[:16]}" for r, d in enumerate(got)))
