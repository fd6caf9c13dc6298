"""nevobench: the benchmark of deep_neuroevolution_torch on one NVIDIA H100.

``run.py`` runs one cell once. The harness is driven by data: cells,
configurations, traffic mixes and metrics are files found by name
(registry.py). The yardstick lives here too: the input generator
(inputs.py), the plain reference (reference/), the comparison that decides
``correct`` (compare.py), the trace reduction (tracing.py), the table of
peaks (peaks.json) and the roofline arithmetic (roofline.py).
"""
