"""Host milliseconds a step spends queueing its work (preprocess, stack and
forward of every group), the waits for actions left out: the host clock
around the enqueue calls over the measured window of a traced run, outside
the profiler's slice."""

UNIT = "ms"


def read(rec):
    return 1e3 * rec.host_s / rec.steps if rec.steps else None
