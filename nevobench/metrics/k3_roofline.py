"""K3's share of its roofline (csrc/large_dqn_fused.cu), in the traced
window: see roofline.py."""

from nevobench.roofline import share

UNIT = "%"


def read(rec):
    return share(rec, "K3")
