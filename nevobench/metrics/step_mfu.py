"""The whole step's share of the card's peak: the forward's FLOPs (the
configuration's count) for every member step of the measured window, over
the window's wall seconds, over the published dense peak at the precision
the route computes in (``route_precision``: float32 67 TFLOP/s, bfloat16
989). Read in a traced run, over its untraced window: the profiler's
slice runs several times slower on the host, which is not the step's
rate."""

UNIT = "%"


def read(rec):
    if rec.trace is None or rec.peaks is None or not rec.steps:
        return None
    cfg, mod = rec.cell.config, rec.cell.config_module
    flops = mod.forward_flops(cfg) * rec.member_steps
    return 100.0 * flops / rec.window_s / rec.peaks["flops_per_s"][cfg["route_precision"]]
