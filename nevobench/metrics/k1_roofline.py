"""K1's share of its roofline (csrc/population_linear.cu, both passes), in
the traced window: see roofline.py."""

from nevobench.roofline import share

UNIT = "%"


def read(rec):
    return share(rec, "K1")
