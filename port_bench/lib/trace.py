"""The traced run: ranges around the program's layers, the NMS launches'
counts, and the profiler's device timeline reduced to what the per-layer
readers read.

Ranges are ``torch.profiler.record_function`` scopes named ``pb.<layer>``
around the detector's attributes that the configuration file lists under
``ranges``: a submodule (its name pinned by the weight conversion, such as
``backbone``, ``fpn``, ``fcos_head``, ``box_head``, ``code_generator``) gets
a forward pre-hook and hook that open and close its range; a method (the
two-stage ``roi_candidates``) gets a wrapper on the instance. The window
itself is ``pb.window``. ``NMSCapture`` wraps
``ops/nms_kernel.py::nms_cuda`` from outside and, as each launch returns,
reduces its inputs and picks to what the bound needs: the shape and the
walk's IoU tests, counted on the card inside a ``pb.capture`` range with no
read back to the host (its kernels are the instrumentation's cost, and
belong to no layer). A kernel belongs to a range when the host op that
launched it started inside the range. Nothing here is installed in an
untraced run.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..counts.nms_bound import walk_tests

CAPTURE = "capture"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NMS_KERNELS = ("rank_kernel", "radix_", "scan_kernel")


class Ranges:
    """``pb.<name>`` ranges around the detector's ``names`` (submodules or
    methods) while installed."""

    def __init__(self, model, names: Sequence[str]):
        self.model, self.names = model, tuple(names)
        self.handles = []
        self.stack: List = []
        self.methods: Dict[str, object] = {}  # instance entries replaced

    def install(self) -> "Ranges":
        for name in self.names:
            attr = getattr(self.model, name)
            if isinstance(attr, torch.nn.Module):
                def pre(_m, _a, name=name):
                    rf = torch.profiler.record_function(f"pb.{name}")
                    rf.__enter__()
                    self.stack.append(rf)

                def post(_m, _a, _o):
                    self.stack.pop().__exit__(None, None, None)
                self.handles += [attr.register_forward_pre_hook(pre),
                                 attr.register_forward_hook(post)]
                continue
            self.methods[name] = self.model.__dict__.get(name)

            def method(*a, _bound=attr, _name=name, **k):
                with torch.profiler.record_function(f"pb.{_name}"):
                    return _bound(*a, **k)
            setattr(self.model, name, method)
        return self

    def uninstall(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
        for name, prior in self.methods.items():
            delattr(self.model, name)
            if prior is not None:
                setattr(self.model, name, prior)
        self.methods = {}


class NMSCapture:
    """Each ``nms_cuda`` launch's (B, K, M, IoU tests as a 0-dim tensor on
    the card) while installed; the inputs themselves are not kept."""

    def __init__(self):
        self.launches: List[Tuple] = []
        self._orig = None

    def install(self) -> "NMSCapture":
        from sylph_tpu_torch.ops import nms_kernel

        self._orig = orig = nms_kernel.nms_cuda

        def captured(x1, y1, x2, y2, scores, valid, iou_threshold,
                     max_outputs):
            idx, ok = orig(x1, y1, x2, y2, scores, valid, iou_threshold,
                           max_outputs)
            with torch.profiler.record_function(f"pb.{CAPTURE}"):
                tests = walk_tests(scores, valid, idx, ok)
            self.launches.append((*scores.shape, idx.shape[1], tests))
            return idx, ok
        nms_kernel.nms_cuda = captured
        return self

    def uninstall(self) -> None:
        if self._orig is not None:
            from sylph_tpu_torch.ops import nms_kernel
            nms_kernel.nms_cuda = self._orig
            self._orig = None


def activity(e) -> str:
    """A device event's kind: ``kernel``, ``gpu_memcpy``, ``gpu_memset`` or
    ``gpu_user_annotation`` (from ``activity_type()`` where this torch has
    it, else from the name)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at())
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if name.startswith("pb.") or getattr(e, "is_user_annotation",
                                          lambda: False)():
        return "gpu_user_annotation"
    return "kernel"


class Timeline:
    """The device timeline of one traced window.

    ``layer_ns[name]``: device ns of the kernels launched inside ``pb.name``
    ranges (``layer_ns["capture"]``: the instrumentation's, counted in no
    other layer and in no kernel's time); ``kernel_ns[name]``: device ns by
    kernel name; ``busy_ns``: the union of kernel, copy and set intervals
    inside the window;
    ``window_ns``: the ``pb.window`` range's length; ``idle_by_host``: idle
    ns inside the window by the host op that was running as each gap began
    (the innermost on the main thread, ``"python"`` where none was)."""

    def __init__(self, events):
        frontend: Dict[int, Tuple[int, int]] = {}
        host: List[Tuple[int, int, str]] = []
        ranges = defaultdict(list)
        device: List[Tuple[int, int, str, int, str]] = []
        window = None
        main = None
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                s, t = e.start_ns(), e.end_ns()
                if e.linked_correlation_id() == 0:
                    # the op first: the profiler's own events that follow
                    # (buffer requests, module loads) may reuse its id
                    frontend.setdefault(e.correlation_id(),
                                        (s, e.start_thread_id()))
                name = e.name()
                if name == "pb.window":
                    window = (s, t)
                    main = e.start_thread_id()
                elif name.startswith("pb."):
                    ranges[name[3:]].append((s, t))
                host.append((s, t, name, e.start_thread_id()))
            elif activity(e) in DEVICE_ACTIVITIES:
                device.append((e.start_ns(), e.end_ns(), e.name(),
                               e.linked_correlation_id(), activity(e)))
        if window is None:
            raise RuntimeError("the trace holds no pb.window range")
        self.window_ns = window[1] - window[0]
        self.layer_ns: Dict[str, int] = defaultdict(int)
        self.kernel_ns: Dict[str, int] = defaultdict(int)
        self.kernel_count = 0
        spans = {n: sorted(r) for n, r in ranges.items()}
        starts = {n: [s for s, _ in r] for n, r in spans.items()}
        intervals = []
        for s, t, name, corr, act in device:
            if t <= window[0] or s >= window[1]:
                continue
            intervals.append((max(s, window[0]), min(t, window[1])))
            if act != "kernel":
                continue
            self.kernel_count += 1
            launch = frontend.get(corr)
            inside = set()
            for n, r in spans.items():
                i = (bisect.bisect_right(starts[n], launch[0]) - 1
                     if launch is not None else -1)
                if i >= 0 and r[i][1] >= launch[0]:
                    inside.add(n)
            if CAPTURE in inside:  # the instrumentation's own kernels
                self.layer_ns[CAPTURE] += t - s
                continue
            self.kernel_ns[name] += t - s
            for n in inside:
                self.layer_ns[n] += t - s
        intervals.sort()
        self.busy_ns, cur = 0, None
        gaps = [] if intervals else [window]
        for s, t in intervals:
            if cur is None or s > cur[1]:
                if cur is not None:
                    self.busy_ns += cur[1] - cur[0]
                    gaps.append((cur[1], s))
                elif s > window[0]:
                    gaps.append((window[0], s))
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        if cur is not None:
            self.busy_ns += cur[1] - cur[0]
            if cur[1] < window[1]:
                gaps.append((cur[1], window[1]))
        main_host = sorted((s, t, n) for s, t, n, th in host
                           if th == main and n != "pb.window")
        self.idle_by_host = self._name_gaps(gaps, main_host)

    @staticmethod
    def _name_gaps(gaps, host) -> Dict[str, int]:
        """Sweep the gaps in time order with a stack of the host events
        that contain each gap's start (host events on one thread nest)."""
        out: Dict[str, int] = defaultdict(int)
        stack: List[Tuple[int, int, str]] = []
        j = 0
        for g0, g1 in sorted(gaps):
            while j < len(host) and host[j][0] <= g0:
                while stack and stack[-1][1] < host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < g0:
                stack.pop()
            out[stack[-1][2] if stack else "python"] += g1 - g0
        return out

    def top_kernels(self, n: int = 10) -> List[List]:
        return [[k[:160], v / 1e9] for k, v in sorted(
            self.kernel_ns.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> List[List]:
        return [[k[:160], v / 1e9] for k, v in sorted(
            self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]]

    def nms_ns(self) -> int:
        return sum(v for k, v in self.kernel_ns.items()
                   if any(p in k for p in NMS_KERNELS))


class Tracer:
    """Installs the ranges and the NMS capture, profiles the window, and
    parses the timeline on ``stop``."""

    def __init__(self, model, ranges: Sequence[str], device: torch.device):
        self.ranges = Ranges(model, ranges)
        self.nms = NMSCapture() if device.type == "cuda" else None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.timeline: Optional[Timeline] = None

    def install(self) -> "Tracer":
        self.ranges.install()
        if self.nms is not None:
            self.nms.install()
        return self

    def start(self) -> None:
        if self.nms is not None:
            self.nms.launches.clear()
        self.prof.start()

    def stop(self) -> Timeline:
        self.prof.stop()
        self.ranges.uninstall()
        if self.nms is not None:
            self.nms.uninstall()
        self.timeline = Timeline(self.prof.profiler.kineto_results.events())
        return self.timeline
