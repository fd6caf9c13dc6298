"""Seconds from process start to the first timed step: imports, the
kernel library's build or load, the inputs, the program's set-up and the
warm-up of the cell's own shapes."""

UNIT = "s"


def read(rec):
    return rec.setup_s
