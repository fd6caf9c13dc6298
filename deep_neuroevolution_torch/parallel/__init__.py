"""Scale-out on torch.distributed: device pods and host-engine pods of ES,
GA, RS and NS-ES, one rank per card.

The counterpart of the JAX package's parallel/ package, which runs one SPMD
program over a ``pop`` mesh (``shard_map``, ``all_gather`` of the fitness
columns, ``psum`` of the gradient). The port runs one process per card,
started by ``torchrun`` (``python -m torch.distributed.run``), NCCL between
cards, gloo on the CPU and for two ranks that share one card
(distributed.py). The pod trainers subclass the single-device trainers and
override only the dispatch (trainers.py: device envs; host_pod.py: the
host engine).

The contract. The JAX package keeps its determinism by splitting keys, one
a device or process (trainers.py:65-72, host_pod.py:17-23); the port draws
from one ``torch.Generator``, and splits a round so:

* the trainer's generator is replicated: every rank seeds it alike;
* every rank makes a global round's draws alike: the noise indices,
  rollout seeds (the noops and engine episode seeds they seed), the
  offspring's parents and mutations. A global round is ``size`` blocks,
  each what the single trainer draws and evaluates as one round, drawn in
  rank order;
* rank p evaluates block p, a contiguous block of the round's rows;
* ``emulate_procs = P`` (the loader's ``host_pod: P``) runs the P ranks'
  blocks one after the other in one process.

So:

1. P real ranks equal the P-block emulation bit for bit: returns, lengths,
   BCs, noise indices, and θ after the update (two partial sums add alike
   in either order).
2. A pod equals the single trainer whose rounds are its blocks (a device
   pod's ``eval_batch`` counts pairs a rank, the single trainer's pairs a
   round): returns, lengths and BCs bit for bit; θ within float reordering
   on the device pods, which add per-rank partial gradients, and bit for
   bit on the host pods, where every rank computes the whole update from
   the gathered columns. It holds where the blocks are the single
   trainer's rounds: not for NS-ES at more than one rank (the single
   trainer evaluates an iteration as one round), nor for the GA's ladder
   on the host engine where its split is not the single trainer's rounds,
   nor on EpisodicLife engines whose histories differ.
3. Only rank 0 writes: the tabular log and TensorBoard events (``main
   train``), trainer snapshots and policy files (``main train``) and VINE
   dumps (the trainers' ``writes``). Every rank ends a run with the same θ.
"""

from .distributed import coordinator_only, init_multihost, is_coordinator, process_count  # noqa: F401
from .mesh import PopGroup, pop_group  # noqa: F401
