"""Readings the output check's limits are set from, several seeds in one
process.

    python3 port_bench/control.py --workload NAME --seeds S1 S2 ...
        [--program] [--device cuda|cpu] [--benchmark BENCHMARK.json]

For each seed the cell is set up as a run sets it up. With ``--program``
the program serves as in a run (warm-up, then the batches or calls its
check samples) and its compared numbers are read: the lower readings.
Without it, the control: the reference on float8-rounded operands in the
program's place (``Cell.control``): the upper readings. One JSON line a
seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--benchmark", default=str(ROOT / "BENCHMARK.json"))
    args = p.parse_args(argv)

    import torch

    from port_bench.lib import spec
    from port_bench.lib.cell import Cell
    from port_bench.run import _device

    bench = spec.Bench(args.benchmark)
    entry = bench.workload(args.workload)
    dev = _device(args.device, entry["chips"])
    limits = bench.limits(entry["name"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = Cell(bench.config(entry["config"]),
                    bench.traffic(entry["traffic"]), limits, seed, dev, False)
        if args.program:
            cell.warm_up()
            res = cell.driver.sample_window()
            cell.free_program()
            values = cell.check(res)
        else:
            values = cell.control()
        row = {"workload": entry["name"], "seed": seed,
               "mode": "program" if args.program else "control_fp8",
               "values": values, "seconds": time.perf_counter() - t0,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
        print(json.dumps(row), flush=True)
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
