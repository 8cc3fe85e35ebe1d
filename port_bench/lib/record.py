"""What one run measured, as the metric readers see it.

A reader (``e2e/<name>.py`` or ``metrics/<name>.py``) gets a ``Run`` and
returns a number, or ``None`` where the run holds nothing for it to read;
the harness then leaves that metric out of the result line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..counts.peaks import BF16_DENSE_FLOPS


@dataclasses.dataclass
class Run:
    kind: str                       # the mix's driver: "query", "register"
    setup_s: float
    start: float                    # the window on the host clock
    end: float
    units: int                      # images or classes completed
    batches: List[Tuple[float, float]]  # query: (hand-over, on the host)
    flops_per_unit: int
    timeline: Optional[object] = None   # trace.Timeline of a traced run
    nms_bounds: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    # ------------------------------------------------ traced readings
    def device_window_s(self) -> Optional[float]:
        if self.timeline is None or self.timeline.kernel_count == 0:
            return None
        return self.timeline.window_ns / 1e9

    def layer_ms_per_unit(self, *layers: str) -> Optional[float]:
        """Device ms of the kernels launched inside the ``pb.<layer>``
        ranges, over the units completed in the traced window."""
        if self.device_window_s() is None or not self.units:
            return None
        ns = sum(self.timeline.layer_ns.get(name, 0) for name in layers)
        if ns == 0:
            return None
        return ns / 1e6 / self.units

    def mfu_pct(self) -> Optional[float]:
        """Model FLOPs completed over the traced window, as a share of the
        dense bf16 peak."""
        win = self.device_window_s()
        if win is None or not self.units:
            return None
        done = self.flops_per_unit * self.units
        return 100.0 * done / win / BF16_DENSE_FLOPS

    def idle_pct(self) -> Optional[float]:
        win = self.device_window_s()
        if win is None:
            return None
        return 100.0 * (1.0 - self.timeline.busy_ns / self.timeline.window_ns)

    def capture_s(self) -> Optional[float]:
        """Device seconds of the instrumentation's own kernels."""
        if self.timeline is None:
            return None
        return self.timeline.layer_ns.get("capture", 0) / 1e9

    def nms_roofline_pct(self) -> Optional[float]:
        if self.device_window_s() is None or not self.nms_bounds:
            return None
        kernel_ns = self.timeline.nms_ns()
        if kernel_ns == 0:
            return None
        return 100.0 * sum(b for b, _ in self.nms_bounds) * 1e6 / kernel_ns


def metric(value: float, unit: str) -> Dict:
    return {"value": value, "unit": unit}
