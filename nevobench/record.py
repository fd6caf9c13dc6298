"""What one run measured, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Optional

from nevobench.tracing import TraceSummary


@dataclasses.dataclass
class Record:
    cell: object  # registry.Cell
    setup_s: float  # process start to the first timed step
    window_s: float  # the measured window, the device synced at its end
    steps: int  # loop steps in the window
    member_steps: int  # members × steps in the window
    host_s: float  # host seconds queueing the window's work, waits left out
    peak_bytes: int  # device memory allocated at the peak, set-up and window
    peaks: Optional[dict]  # the card's published peaks (peaks.json); None off the card
    trace: Optional[TraceSummary] = None  # the traced window of a --trace 1 run

    @property
    def group(self) -> int:
        """Members of one pipeline group: the batch of each forward."""
        return self.cell.config["population_size"] // self.cell.traffic.get("pipeline_groups", 1)
