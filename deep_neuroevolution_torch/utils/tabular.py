"""Tabular logger — ASCII table on stdout, log.txt, JSONL metrics and
TensorBoard events.

The port's own copy of the JAX package's utils/tabular.py (after
gpu_implementation/tabular_logger.py:19-237), cut to what the port calls:
start/stop, record_tabular, dump_tabular, log, and ``quiet`` (dumps
clear the row unprinted while it is open). The metric names are the
reference's. With a log directory, each ``dump_tabular`` also appends one
scalar event (step = the dump's ordinal) to an ``events.out.tfevents.*``
file there (utils/tb_events.py), as the JAX package's :26-41 does. Not
ported: log levels.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
import time
from typing import Any, Dict, Optional

from .tb_events import EventsWriter


class TabularLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.echo = True  # print each dump's table on stdout (``quiet`` clears it)
        self._kvs: Dict[str, Any] = {}
        self._text = None
        self._jsonl = None
        self._tb = None
        self._step = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._text = open(os.path.join(log_dir, "log.txt"), "a")
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            self._tb = EventsWriter(log_dir)

    def record_tabular(self, key: str, val: Any) -> None:
        self._kvs[key] = val

    def dump_tabular(self) -> None:
        if not self._kvs:
            return
        key_width = max(len(k) for k in self._kvs)
        val_strs = {}
        for k, v in self._kvs.items():
            if hasattr(v, "item"):
                v = v.item()
            val_strs[k] = f"{v:<8.3g}" if isinstance(v, float) else str(v)
        val_width = max(len(s) for s in val_strs.values())
        dashes = "-" * (key_width + val_width + 7)
        lines = [dashes]
        for k, s in val_strs.items():
            lines.append(f"| {k.ljust(key_width)} | {s.ljust(val_width)} |")
        lines.append(dashes)
        out = "\n".join(lines)
        if self.echo:
            print(out)
            sys.stdout.flush()
        if self._text:
            self._text.write(out + "\n")
            self._text.flush()
        if self._jsonl:
            rec = {k: (v.item() if hasattr(v, "item") else v) for k, v in self._kvs.items()}
            rec["_time"] = time.time()
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            self._step += 1
            self._tb.write_scalars(self._step, self._kvs)
        self._kvs.clear()

    def log(self, *args) -> None:
        now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        msg = f"[{now}] " + " ".join(map(str, args))
        print(msg)
        sys.stdout.flush()
        if self._text:
            self._text.write(msg + "\n")
            self._text.flush()

    def close(self) -> None:
        if self._text:
            self._text.close()
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


# module-level API, as the reference's tabular_logger exposes it
_logger = TabularLogger()


def start(log_dir: str) -> None:
    global _logger
    _logger.close()
    _logger = TabularLogger(log_dir)


def stop() -> None:
    global _logger
    _logger.close()
    _logger = TabularLogger()


@contextlib.contextmanager
def quiet():
    """While open, a dump writes its row to the log directory's files, if
    any, and prints nothing (the campaign scripts, whose generations would
    otherwise print a table each)."""
    saved = _logger.echo
    _logger.echo = False
    try:
        yield
    finally:
        _logger.echo = saved


def record_tabular(key, val) -> None:
    _logger.record_tabular(key, val)


def dump_tabular() -> None:
    _logger.dump_tabular()


def log(*args) -> None:
    _logger.log(*args)
