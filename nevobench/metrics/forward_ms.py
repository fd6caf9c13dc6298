"""Device milliseconds a step of the operations launched under the span
``bench.forward``: the model's ``make_batch_act`` forward and argmax,
every group."""

UNIT = "ms"


def read(rec):
    if rec.trace is None:
        return None
    s = rec.trace.span_device_s.get("bench.forward", 0.0)
    return 1e3 * s / rec.trace.steps if s > 0 else None
