"""The program's own spans in a traced window, reduced to what per-layer
readings of them need.

The port opens ``sylph.<name>`` ranges (``sylph_tpu_torch/utils/spans.py``)
where its work happens: ``h2d`` on the worker thread that copies inputs to
the card, ``wait``, ``infer``, ``fetch``, ``register`` on the main thread,
and the layers below them (``backbone``, ``fpn``, ``fcos_head``,
``decode`` ⊃ ``nms``, ``rpn``, ``roi_stage`` ⊃ ``roi_align`` and
``box_head``, ``code_generator`` ⊃ ``roi_align``). The worker's spans are
in the trace only when the profiler records every thread
(``_ExperimentalConfig(profile_all_threads=True)``).

``Spans(events)`` from ``profiler.kineto_results.events()`` of a window
held in ``pb.window`` (``lib/trace.py``): ``kernel_ns(name, minus)``, the
device ns of the kernels whose host op started inside a ``name`` span on
the same thread and inside none of ``minus`` (a span's self time under its
children); ``host_ns[name]`` and ``count[name]``, over spans that start in
the window on any thread; ``idle_split(order)``, the window's idle ns
(no kernel, copy or set on the card) by the first span of ``order`` open
on any thread, ``"none"`` for the rest. ``readings`` gives the per-layer
numbers, per image or class completed; ``None`` where a span is absent.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .trace import DEVICE_ACTIVITIES, NMS_KERNELS, activity

PREFIX = "sylph."
Intervals = List[Tuple[int, int]]


def union(iv: Iterable[Tuple[int, int]]) -> Intervals:
    out: Intervals = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """Of two unions."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < t:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """Of two unions."""
    out, j = [], 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t and s < t:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < t:
            out.append((s, t))
    return out


def length(iv: Intervals) -> int:
    return sum(t - s for s, t in iv)


class Spans:
    def __init__(self, events):
        spans = defaultdict(list)           # name -> [(start, end, thread)]
        frontend: Dict[int, Tuple[int, int]] = {}
        device = []
        window = None
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                s, t, th = e.start_ns(), e.end_ns(), e.start_thread_id()
                if e.linked_correlation_id() == 0:
                    frontend.setdefault(e.correlation_id(), (s, th))
                name = e.name()
                if name == "pb.window":
                    window = (s, t)
                elif name.startswith(PREFIX):
                    spans[name[len(PREFIX):]].append((s, t, th))
            elif activity(e) in DEVICE_ACTIVITIES:
                device.append((e.start_ns(), e.end_ns(), e.name(),
                               e.linked_correlation_id(), activity(e)))
        if window is None:
            raise RuntimeError("the trace holds no pb.window range")
        self.window_ns = window[1] - window[0]
        self.host_ns: Dict[str, int] = defaultdict(int)
        self.count: Dict[str, int] = defaultdict(int)
        for name, found in spans.items():
            for s, t, _ in found:
                if window[0] <= s < window[1]:
                    self.host_ns[name] += t - s
                    self.count[name] += 1
        self.open = {n: union((max(s, window[0]), min(t, window[1]))
                              for s, t, _ in f if s < window[1]
                              and t > window[0])
                     for n, f in spans.items()}
        on = defaultdict(lambda: defaultdict(list))  # thread -> name -> spans
        for name, found in spans.items():
            for s, t, th in found:
                on[th][name].append((s, t))
        for names in on.values():
            for v in names.values():
                v.sort()
        starts = {th: {n: [s for s, _ in v] for n, v in names.items()}
                  for th, names in on.items()}
        busy = []
        self.kernels: List[Tuple[int, str, frozenset]] = []
        for s, t, name, corr, act in device:
            if t <= window[0] or s >= window[1]:
                continue
            busy.append((max(s, window[0]), min(t, window[1])))
            if act != "kernel":
                continue
            launch = frontend.get(corr)
            inside = set()
            if launch is not None:
                for n, v in on.get(launch[1], {}).items():
                    i = bisect.bisect_right(starts[launch[1]][n],
                                            launch[0]) - 1
                    if i >= 0 and v[i][1] >= launch[0]:
                        inside.add(n)
            self.kernels.append((t - s, name, frozenset(inside)))
        self.idle = subtract([window], union(busy))

    def kernel_ns(self, name: str, minus: Sequence[str] = ()) -> int:
        return sum(ns for ns, _, inside in self.kernels
                   if name in inside and not inside.intersection(minus))

    def idle_split(self, order: Sequence[str]) -> Dict[str, int]:
        rest, out = self.idle, {}
        for name in order:
            held = self.open.get(name, [])
            out[name] = length(intersect(rest, held))
            rest = subtract(rest, held)
        out["none"] = length(rest)
        return out

    def idle_under_ns(self, name: str) -> int:
        return length(intersect(self.idle, self.open.get(name, [])))

    def nms_share_inside(self) -> Optional[float]:
        """Share of the NMS kernels' device ns launched inside ``nms``."""
        nms = [(ns, inside) for ns, k, inside in self.kernels
               if any(p in k for p in NMS_KERNELS)]
        total = sum(ns for ns, _ in nms)
        return (sum(ns for ns, inside in nms if "nms" in inside) / total
                if total else None)

    def readings(self, kind: str, units: int) -> Dict[str, Optional[float]]:
        """The per-layer numbers of a ``query`` or ``register`` window
        that completed ``units`` images or classes."""
        def per_unit(ns):
            return ns / 1e6 / units if ns and units else None

        def idle_pct(name):
            if not self.open.get(name):
                return None
            return 100.0 * self.idle_under_ns(name) / self.window_ns

        if kind == "register":
            return {"input_idle_pct.register": idle_pct("h2d"),
                    "roi_align_ms.register": per_unit(
                        self.kernel_ns("roi_align"))}
        wait = (self.host_ns["wait"] / self.count["wait"] / 1e6
                if self.count.get("wait") else None)
        return {"input_idle_pct.query": idle_pct("h2d"),
                "query_wait_ms": wait,
                "decode_ms": per_unit(self.kernel_ns("decode", ("nms",))),
                "roi_align_ms.query": per_unit(self.kernel_ns("roi_align")),
                "box_head_ms": per_unit(self.kernel_ns("box_head"))}
