"""Training metrics and loss-stream monitoring (port of
sylph_tpu/utils/events.py).

``MetricsWriter`` appends one ``metrics.json`` line per iteration, writes the
same scalars as TensorBoard events (``utils/tb_writer.py``) and prints every
``PRINT_EVERY`` iterations with the card's peak memory
(``torch.cuda.max_memory_allocated``, the reference's ``max_mem``).
``AbnormalLossChecker`` flags non-finite losses and spikes against a window.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Dict, Optional

import torch

from .tb_writer import TBEventWriter

PRINT_EVERY = 20


class MetricsWriter:
    def __init__(self, output_dir: Optional[str] = None):
        self._f = None
        self._tb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(os.path.join(output_dir, "metrics.json"), "a")
            self._tb = TBEventWriter(os.path.join(output_dir, "tb"))
        self._last = time.perf_counter()

    def write(self, step: int, metrics: Dict[str, float],
              lr: Optional[float] = None) -> None:
        row = {"iteration": step,
               **{k: float(v) for k, v in metrics.items()}}
        if lr is not None:
            row["lr"] = float(lr)
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        if self._tb:
            self._tb.add_scalars(step, {k: v for k, v in row.items()
                                        if k != "iteration"})
        if step % PRINT_EVERY == 0:
            now = time.perf_counter()
            rate = PRINT_EVERY / max(now - self._last, 1e-9)
            self._last = now
            losses = "  ".join(f"{k}: {float(v):.4f}"
                               for k, v in metrics.items())
            lr_s = f"  lr: {lr:.2e}" if lr is not None else ""
            peak = peak_memory_gb()
            mem_s = f"  max_mem: {peak:.2f} GB" if peak is not None else ""
            print(f"iter {step}  {losses}{lr_s}{mem_s}  ({rate:.2f} it/s)")

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()


def peak_memory_gb() -> Optional[float]:
    """Peak memory the caching allocator handed out on the current card, in
    GB; None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated() / 1e9


class AbnormalLossChecker:
    """Flags NaN/inf or a loss exploding against its recent window
    (reference ABNORMAL_CHECKER, meta_fcos_runner.py:332-341)."""

    def __init__(self, window: int = 20, ratio: float = 20.0):
        self.window = window
        self.ratio = ratio
        self._hist: Dict[str, deque] = {}

    def check(self, metrics: Dict[str, float]) -> Dict[str, str]:
        problems = {}
        for k, v in metrics.items():
            v = float(v)
            if not math.isfinite(v):
                problems[k] = f"non-finite loss {v}"
                continue
            h = self._hist.setdefault(k, deque(maxlen=self.window))
            if len(h) == self.window:
                mean = sum(h) / len(h)
                if mean > 0 and v > self.ratio * mean:
                    problems[k] = (f"loss spiked to {v:.4f} "
                                   f"({self.ratio}x window mean {mean:.4f})")
            h.append(v)
        return problems
