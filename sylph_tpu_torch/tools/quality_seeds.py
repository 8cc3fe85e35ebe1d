"""Run one quality-loop family at several ``SEED``s and print the spread of
its metrics: the training-seed spread that tells a fault from a second
sample when a family misses its band.

    python3 -m sylph_tpu_torch.tools.quality_seeds --seeds 1 2 -- \
        --family tfa_rcnn --data-root /tmp/learnable_coco \
        --output-dir output/seeds_tfa_rcnn [--device cuda]

Everything after ``--`` is ``tools/quality_loop.py``'s flags. The seeds run
one after the other in this process, each into ``<output-dir>/seed<N>``
with ``SEED`` set in every stage's config: the initial weights, the order
of the batches and episodes and the sampling draws change with it, the
synthetic set does not. Each run writes and prints what ``quality_loop``
does; the last line is one JSON object with each seed's metrics and, per
metric, the mean and the standard deviation over the seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import Dict, List

from . import quality_loop


def spread(runs: Dict[int, Dict]) -> Dict:
    """{seed: summary} -> {key: {metric: {"mean", "std"}}} over the seeds
    (population std; the REPEAT_TEST std columns are left out)."""
    out: Dict = {}
    first = next(iter(runs.values()))
    for key, metrics in first.items():
        for name in metrics:
            if name.endswith("_std"):
                continue
            values = [runs[s][key][name] for s in runs]
            out.setdefault(key, {})[name] = {
                "mean": statistics.fmean(values),
                "std": statistics.pstdev(values)}
    return out


def main(argv: List[str] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("loop", nargs=argparse.REMAINDER,
                   help="-- then tools/quality_loop.py's flags")
    ns = p.parse_args(argv)
    loop = ns.loop[1:] if ns.loop[:1] == ["--"] else ns.loop
    runs = {}
    for seed in ns.seeds:
        args = quality_loop.parse_args(loop)
        root = args.output_dir or f"output/quality_loop_{args.family}"
        args.output_dir = os.path.join(root, f"seed{seed}")
        args.seed = seed
        results = quality_loop.run(args)
        runs[seed] = quality_loop.summarize(args.family, results)
    line = {"quality_seeds": args.family, "seeds": ns.seeds, "runs": runs,
            "spread": spread(runs)}
    print(json.dumps(line, default=float), flush=True)
    return line


if __name__ == "__main__":
    main()
