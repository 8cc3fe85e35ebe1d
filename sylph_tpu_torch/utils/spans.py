"""The program's spans: named host intervals on the profiler's clock.

``span(name)`` opens ``torch.profiler.record_function("sylph." + name)``
while a profiler records, so each kernel in the device trace can be tied
to the span whose host op launched it; otherwise it returns one shared
null context, at the cost of one attribute read. ``span(name, stats,
key)`` also adds the span's host seconds to ``stats[key]`` (and then
times whether or not a profiler records), so a phase's timer and its span
share one pair of boundaries; the span object keeps them as ``seconds``.

Spans nest: a reader takes a span's self time by subtracting its child
spans (``decode`` holds ``nms``; ``roi_stage`` holds ``roi_align`` and
``box_head``). The copy to the card runs on a worker thread, whose spans
the profiler records only when given
``torch._C._profiler._ExperimentalConfig(profile_all_threads=True)``.
Spans of one batch or call are paired by their order on each thread:
the i-th ``h2d`` is the copy of the item the i-th ``wait`` takes
(``record_function``'s ``args`` string does not reach the profiler's
events, so it carries no ordinal).

There is no switch: a profiler being on is what turns spans on.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "sylph."
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stats", "key", "rf", "t0", "seconds")

    def __init__(self, name: str, stats: Optional[Dict], key: Optional[str]):
        self.name, self.stats, self.key = name, stats, key
        self.rf = None
        self.seconds = 0.0

    def __enter__(self) -> "_Span":
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self.t0
        if self.stats is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + self.seconds
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, stats: Optional[Dict] = None, key: Optional[str] = None):
    """A context that records ``sylph.<name>`` while a profiler records,
    and adds its host seconds to ``stats[key]`` when ``stats`` is given."""
    if stats is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, stats, key)
