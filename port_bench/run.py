"""Run one cell of the benchmark of ``sylph_tpu_torch`` once.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1
        [--device cuda|cpu] [--benchmark BENCHMARK.json]

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the run builds the configuration's
detector through the port with weights drawn from ``--seed`` on the card,
makes the mix's inputs from the seed, warms up the cell's own shapes, then
drives the program's own entry for ``--seconds`` (``lib/cell.py``,
``lib/drive.py``). With ``--trace 1`` the window runs under the profiler
with ranges around the layers (``lib/trace.py``) and the per-layer metrics
are reported; with ``--trace 0`` the end-to-end ones. After the window, a
sample of what it produced is held against the plain reference
(``lib/check.py``); each number compared is printed beside its limit, last
on standard error and under ``check`` in the result line, which is the last
line of standard output.

It exits non-zero and prints no result when the card or cards the cell asks
for are missing (``--device cpu`` runs the tests' toy configurations; its
numbers are the host's), and when ``jax``, ``jaxlib``, ``flax`` or
``sylph_tpu`` is loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sylph_tpu")


class Refused(Exception):
    """A run that cannot give a result on this machine."""


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _device(name: str, chips: int):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} cards, "
                          f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise Refused(f"device {name!r}")
    return dev


def run(args) -> dict:
    import torch

    from port_bench.lib import check, spec
    from port_bench.lib.cell import Cell
    from port_bench.lib.record import Run, metric

    bench = spec.Bench(args.benchmark)
    entry = bench.workload(args.workload)
    dev = _device(args.device, entry["chips"])
    limits = bench.limits(entry["name"])
    cell = Cell(bench.config(entry["config"]), bench.traffic(entry["traffic"]),
                limits, args.seed, dev, bool(args.trace))
    cell.warm_up()
    setup_s = time.perf_counter() - T0

    seconds = args.seconds
    if args.trace:
        seconds = min(seconds, limits.get("trace_seconds", seconds))
    res = cell.measure(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    timeline = res["timeline"]
    record = Run(kind=cell.kind, setup_s=setup_s, start=res["start"],
                 end=res["end"], units=res["units"],
                 batches=res.get("batches", []),
                 flops_per_unit=cell.driver.flops_per_unit, timeline=timeline,
                 nms_bounds=cell.nms_bounds())
    cell.free_program()
    verdict = check.judge(cell.check(res), limits["limits"])

    metrics = {}
    for m in bench.metrics(entry["name"], bool(args.trace)):
        value = spec.reader(bool(args.trace), m["name"])(record)
        if value is not None:
            metrics[m["name"]] = metric(value, m["unit"])
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": entry["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": verdict["correct"], "attempted": record.units,
            "failed": 0, "metrics": metrics, "device": device}
    if timeline is not None:
        device["busy_s"] = timeline.busy_ns / 1e9
        device["window_s"] = timeline.window_ns / 1e9
        line["breakdown"] = {"device_ops": timeline.top_kernels(),
                             "idle_gaps": timeline.top_idle()}
        line["capture_s"] = record.capture_s()
    line["check"] = verdict["table"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--benchmark", default=str(ROOT / "BENCHMARK.json"))
    args = p.parse_args(argv)
    try:
        line = run(args)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"refused: {', '.join(bad)} loaded in the process",
              file=sys.stderr)
        return 3
    for name, row in line["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
