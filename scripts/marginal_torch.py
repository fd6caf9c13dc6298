"""The marginal timer of the port's measurement scripts, and the LargeDQN
pieces that the forward race and the stage profile share.

``marginal(step, device)`` is one ``step(t)``'s time (t = 0, 1, ...; each
returns a scalar) by the JAX scripts' marginal method: K = 2 and K = 10
steps run back to back, and one step costs (T₁₀ − T₂) / 8, so what a run
costs once cancels. Each T is the least over ``reps`` runs.

* On a card the K steps are captured in one CUDA graph, and each replay
  is timed with CUDA events. A step that draws from an explicit device
  generator names it in ``generators``: it is registered with each graph
  (``CUDAGraph.register_generator_state``), or the capture fails. A step
  that syncs with the host cannot be captured: the capture raises.
* On the CPU the steps run eagerly on the host clock: a check of the
  control flow, not a measurement.

Used by scripts/exp_large_fwd_torch.py and scripts/profile_atari_stages_torch.py.
"""

from __future__ import annotations

import time

import torch

from deep_neuroevolution_torch.models.core import batch_conv2d

REPS = 5  # timed runs of each K (runs on the host clock); the least counts


def steps(step, K: int, device: torch.device) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for t in range(K):
        acc = acc + step(t)
    return acc


def graph_ms(step, K: int, reps: int, device: torch.device, generators=()) -> float:
    """K steps captured in one CUDA graph: the least of ``reps`` replays'
    milliseconds by CUDA events."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm up outside the capture, as torch.cuda.graph asks
        steps(step, K, device)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        steps(step, K, device)
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    del graph
    return min(times)


def host_ms(step, K: int, reps: int, device: torch.device) -> float:
    steps(step, K, device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(steps(step, K, device))
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def marginal(step, device: torch.device, ks=(2, 10), reps: int = REPS, generators=()) -> float:
    """Milliseconds of one ``step(t)`` by the marginal method:
    (T_{ks[1]} − T_{ks[0]}) / (ks[1] − ks[0])."""
    if device.type == "cuda":
        ts = [graph_ms(step, K, reps, device, generators) for K in ks]
    else:
        ts = [host_ms(step, K, reps, device) for K in ks]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return (ts[1] - ts[0]) / (ks[1] - ks[0])


# ------------------------------------------------------ shared LargeDQN parts

def fc_bmm(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The counterpart of the JAX scripts' fc einsum, which XLA computed
    outside any Pallas kernel: one ``torch.bmm`` in the operands' dtype,
    widened to f32."""
    return torch.bmm(x[:, None, :], W)[:, 0].float()


CONV_LAYERS = (("conv1/w", 4), ("conv2/w", 2), ("conv3/w", 1))


def conv_chain_nhwc(parts, x: torch.Tensor) -> torch.Tensor:
    """The LargeDQN's conv stack on NHWC frames, a batched product over
    im2col patches per layer (``batch_conv2d``), each output relu'd and
    rounded to bf16; no biases, as in the JAX scripts."""
    h = x
    for nm, s in CONV_LAYERS:
        h = torch.relu(batch_conv2d(parts[nm], h, stride=s)).to(torch.bfloat16)
    return h
