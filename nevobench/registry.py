"""Find the parts of a cell by name, from files alone.

A cell is ``workloads/<name>.json``: it names its configuration, its
traffic, the cards it runs on (``chips``) and the metrics it reports. A
configuration is ``configs/<name>.json`` (its sizes, source and cuts) with
``configs/<name>.py`` beside it (member init, the program's model, the
reference's call, the FLOP and byte counts). A traffic mix is
``traffic/<name>.json``, whose ``loop`` names the step loop
``loops/<loop>.py`` that reads it: the loop's ``Run`` sets the program up,
steps it, and checks what it answered (``Run.check``). A metric is
``metrics/<name>.py`` with a ``UNIT`` and a ``read(record)`` that returns a
number or None. Adding any of them is adding files; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} file named {name!r} ({path} is missing)")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as the module ``nevobench.<kind>.<name>`` (a
    name may hold dots), loaded once per process."""
    mod_name = f"nevobench.{kind}.{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str) -> list:
    """Every name of ``kind`` that has a ``<name><suffix>`` file."""
    return sorted(p.name[: -len(suffix)] for p in (HERE / kind).glob(f"*{suffix}") if not p.name.startswith("_"))


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    config_module: ModuleType
    loop: ModuleType
    end_to_end: Dict[str, ModuleType]
    per_layer: Dict[str, ModuleType]

    @property
    def chips(self) -> int:
        """Cards the cell runs on (its workload file's ``chips``)."""
        return int(self.workload["chips"])


def cell(name: str) -> Cell:
    w = load_json("workloads", name)
    return Cell(
        name=name,
        workload=w,
        config=load_json("configs", w["config"]),
        traffic=load_json("traffic", w["traffic"]),
        config_module=load_module("configs", w["config"]),
        loop=load_module("loops", load_json("traffic", w["traffic"])["loop"]),
        end_to_end={m: load_module("metrics", m) for m in w["end_to_end"]},
        per_layer={m: load_module("metrics", m) for m in w["per_layer"]},
    )


def peaks(device_name: str) -> dict:
    """The published peaks of the card named ``device_name`` (peaks.json)."""
    with open(HERE / "peaks.json") as f:
        table = json.load(f)
    for entry in table["cards"]:
        if entry["name"] == device_name:
            return entry
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")
