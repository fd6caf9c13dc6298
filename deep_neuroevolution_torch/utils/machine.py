"""What a measurement ran on: the card and the host.

A campaign's artifact (scripts/*_torch.py) records it beside its seconds,
because the host-bound generations read tens of percent apart between
machines and between calls on one machine.
"""

from __future__ import annotations

import os
import platform
import subprocess

import torch


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its first line), or
    'cpu'."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo, else ``platform``'s."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def loadavg() -> str:
    """/proc/loadavg as it reads, or '' where there is none."""
    try:
        with open("/proc/loadavg") as f:
            return f.read().strip()
    except OSError:
        return ""


def describe(device: torch.device) -> dict:
    """The ``device`` entry of a campaign artifact: the card, its torch and
    CUDA versions, and the host's CPU model, core count and load."""
    out = dict(card=card(device), torch=torch.__version__, cuda=torch.version.cuda,
               host_cpu=cpu_model(), host_cores=os.cpu_count(), host_loadavg=loadavg())
    if device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(device)
    return out
