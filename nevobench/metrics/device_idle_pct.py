"""Percent of the traced window in which no operation runs on the device:
1 − the union of the device's operations inside ``bench.window`` over the
window's length, both from the same trace."""

UNIT = "%"


def read(rec):
    t = rec.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
