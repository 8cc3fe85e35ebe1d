"""The program's own spans in one traced window of a cell.

    python3 port_bench/span_readings.py --workload NAME --seed N
        --seconds S [--device cuda|cpu] [--benchmark BENCHMARK.json]

Sets the cell up as a ``--trace 1`` run does (``lib/cell.py``, the
``pb.<layer>`` ranges and the NMS capture included), but records the
window with a profiler that records every thread, so the worker thread's
``sylph.h2d`` copies are in the trace beside the main thread's spans.
Prints one JSON line: the per-layer readings of the program's spans
(``lib/spans.py``), the benchmark's own per-layer metrics of the cell read
from the same trace, the window's idle ns by the span open over it, each
span's kernel ms per unit, host ms and count, the share of the NMS
kernels' time launched inside ``sylph.nms``, and the units completed per
second of the window.
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

IDLE_ORDER = ("h2d", "fetch", "evaluator", "wait", "infer", "register")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--benchmark", default=str(ROOT / "BENCHMARK.json"))
    args = p.parse_args(argv)

    import torch

    from port_bench.lib import spec
    from port_bench.lib.cell import Cell
    from port_bench.lib.record import Run
    from port_bench.lib.spans import Spans
    from port_bench.run import _device

    bench = spec.Bench(args.benchmark)
    entry = bench.workload(args.workload)
    dev = _device(args.device, entry["chips"])
    limits = bench.limits(entry["name"])
    cell = Cell(bench.config(entry["config"]),
                bench.traffic(entry["traffic"]), limits, args.seed, dev, True)
    cell.tracer.prof = torch.profiler.profile(
        activities=cell.tracer.prof.activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    cell.warm_up()
    res = cell.measure(min(args.seconds,
                           limits.get("trace_seconds", args.seconds)))
    found = Spans(cell.tracer.prof.profiler.kineto_results.events())
    units = res["units"]
    record = Run(kind=cell.kind, setup_s=0.0, start=res["start"],
                 end=res["end"], units=units, batches=res.get("batches", []),
                 flops_per_unit=cell.driver.flops_per_unit,
                 timeline=res["timeline"], nms_bounds=cell.nms_bounds())
    names = sorted(found.open)
    line = {
        "workload": entry["name"], "seed": args.seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "torch": torch.__version__, "units": units,
        "units_per_s": units / record.window_s,
        "window_s": found.window_ns / 1e9,
        "busy_s": res["timeline"].busy_ns / 1e9,
        "readings": found.readings(cell.kind, units),
        "harness": {m["name"]: spec.reader(True, m["name"])(record)
                    for m in bench.metrics(entry["name"], True)},
        "idle_s": {k: v / 1e9 for k, v in
                   found.idle_split(IDLE_ORDER).items()},
        "span_kernel_ms_per_unit": {
            n: found.kernel_ns(n) / 1e6 / max(units, 1) for n in names},
        "span_host_ms": {n: found.host_ns[n] / 1e6 for n in names},
        "span_count": {n: found.count[n] for n in names},
        "nms_share_inside": found.nms_share_inside(),
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
