"""The program's spans as the harness reads them (``lib/spans.py``), on
synthetic profiler events: the timeline the benchmark's metrics read is
the same with and without the spans and the worker thread's events; kernel
time, self time, counts and idle time under a span, hand-counted; no
reading where the program opened no span. And ``span_readings.py`` on a
toy cell."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

from port_bench.lib.spans import Spans, intersect, subtract, union
from port_bench.lib.trace import Timeline

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, WORKER = 1, 2


class Ev:
    def __init__(self, name, s, t, thread=MAIN, corr=0, linked=0,
                 device=False, kind="cpu_op"):
        self._v = (name, s, t, thread, corr, linked, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        return CUDA if self._v[6] else CPU

    def activity_type(self):
        return self._v[7]


def kernel(name, s, t, corr):
    return Ev(name, s, t, 0, 0, corr, True, "kernel")


# A window of 1000 ns. Main thread: wait 0-100, infer 100-300 (backbone
# range 110-250 inside, one op at 150 launching a kernel at 200-260),
# decode 400-600 with nms 450-550 inside (an op at 420: kernel 430-470;
# an op at 460: the NMS kernel 480-520), fetch 600-900 (a D2H copy 850-
# 880), wait 900-960. Worker: h2d 50-350, its runtime copy 60-340 and the
# card's copy 300-340. Busy: 200-260, 300-340, 430-470, 480-520, 850-880.
BASE = [
    Ev("pb.window", 0, 1000),
    Ev("pb.backbone", 110, 250),
    Ev("aten::conv", 150, 160, corr=1),
    kernel("conv_kernel", 200, 260, 1),
    Ev("aten::topk", 420, 425, corr=2),
    kernel("topk_kernel", 430, 470, 2),
    Ev("nms_cuda", 460, 465, corr=3),
    kernel("rank_kernel", 480, 520, 3),
    Ev("aten::copy_", 840, 890, corr=4),
    Ev("cudaMemcpyAsync", 845, 885, corr=5),
    Ev("Memcpy DtoH", 850, 880, 0, 0, 5, True, "gpu_memcpy"),
    Ev("Memcpy HtoD", 300, 340, 0, 0, 7, True, "gpu_memcpy"),
]
SPANS = [
    Ev("sylph.wait", 0, 100), Ev("sylph.infer", 100, 300),
    Ev("sylph.decode", 400, 600), Ev("sylph.nms", 450, 550),
    Ev("sylph.fetch", 600, 900), Ev("sylph.wait", 900, 960),
]
WORKER_COPY = [Ev("aten::copy_", 55, 345, WORKER, corr=6),
               Ev("cudaMemcpyAsync", 60, 340, WORKER, corr=7)]
WORKER_SPAN = [Ev("sylph.h2d", 50, 350, WORKER)]


def test_timeline_unchanged_by_spans_and_worker_events():
    plain = Timeline(BASE)
    full = Timeline(BASE + SPANS + WORKER_COPY + WORKER_SPAN)
    for t in (plain, full):
        assert t.window_ns == 1000 and t.kernel_count == 3
        assert t.busy_ns == 60 + 40 + 40 + 40 + 30
        assert dict(t.layer_ns) == {"backbone": 60}
        assert dict(t.kernel_ns) == {"conv_kernel": 60, "topk_kernel": 40,
                                     "rank_kernel": 40}
        assert sum(t.idle_by_host.values()) == 1000 - t.busy_ns
    # the gaps are named on the main thread alone; a span takes "python"'s
    assert dict(plain.idle_by_host) == {"python": 670,
                                        "cudaMemcpyAsync": 120}
    assert full.idle_by_host["sylph.wait"] == 200
    assert full.idle_by_host["cudaMemcpyAsync"] == 120
    assert not set(full.idle_by_host) - set(plain.idle_by_host) - {
        e.name() for e in SPANS}


def test_span_arithmetic_by_hand():
    s = Spans(BASE + SPANS + WORKER_COPY + WORKER_SPAN)
    assert s.window_ns == 1000
    assert s.kernel_ns("infer") == 60 and s.kernel_ns("nms") == 40
    assert s.kernel_ns("decode") == 80
    assert s.kernel_ns("decode", ("nms",)) == 40
    assert s.kernel_ns("fetch") == 0  # copies are not kernels
    assert dict(s.count) == {"wait": 2, "infer": 1, "decode": 1, "nms": 1,
                             "fetch": 1, "h2d": 1}
    assert s.host_ns["wait"] == 160 and s.host_ns["h2d"] == 300
    # idle: 0-200, 260-300, 340-430, 470-480, 520-850, 880-1000
    assert s.idle_under_ns("h2d") == 150 + 40 + 10
    assert s.idle_split(("h2d", "fetch")) == {"h2d": 200,
                                              "fetch": 250 + 20,
                                              "none": 790 - 470}
    assert s.nms_share_inside() == 1.0
    r = s.readings("query", 4)
    assert r["input_idle_pct.query"] == pytest.approx(20.0)
    assert r["query_wait_ms"] == pytest.approx(80 / 1e6)
    assert r["decode_ms"] == pytest.approx(40 / 1e6 / 4)
    assert r["roi_align_ms.query"] is None and r["box_head_ms"] is None
    reg = s.readings("register", 4)
    assert reg["roi_align_ms.register"] is None
    assert reg["input_idle_pct.register"] == pytest.approx(20.0)


@pytest.mark.parametrize("events", [BASE, BASE + WORKER_COPY])
def test_no_spans_no_readings(events):
    s = Spans(events)
    assert not s.open and s.idle_under_ns("h2d") == 0
    assert all(v is None for v in s.readings("query", 4).values())
    assert all(v is None for v in s.readings("register", 4).values())


@pytest.mark.parametrize("a,b", [
    ([(0, 10), (20, 30)], [(5, 25)]),
    ([(0, 100)], [(10, 20), (30, 40), (90, 120)]),
    ([(0, 5), (6, 9)], []),
])
def test_interval_arithmetic(a, b):
    pts = range(-5, 130)

    def cover(iv):
        return {x for x in pts if any(s <= x < t for s, t in iv)}

    assert cover(intersect(a, b)) == cover(a) & cover(b)
    assert cover(subtract(a, b)) == cover(a) - cover(b)
    assert cover(union(a + b)) == cover(a) | cover(b)


@pytest.mark.parametrize("cell", ["fcos_query_b8_c80",
                                  "fcos_register_s10_cb8"])
def test_span_readings_on_a_toy_cell(toy_bench, cell):
    p = subprocess.run(
        [sys.executable, "port_bench/span_readings.py", "--workload", cell,
         "--seed", "3000000019", "--seconds", "2", "--device", "cpu",
         "--benchmark", str(toy_bench)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["units"] > 0 and line["device"] == "cpu"
    count = line["span_count"]
    if cell.startswith("fcos_query"):
        assert line["readings"]["query_wait_ms"] > 0
        assert count["infer"] == count["fetch"] == count["decode"]
        assert count["wait"] >= count["infer"] > 0
    else:
        assert count["register"] == count["code_generator"] > 0
    assert abs(count["h2d"] - count.get("infer", count.get("register"))) <= 3
