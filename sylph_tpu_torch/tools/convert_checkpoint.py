"""Convert a detectron2 / reference checkpoint to a flat ``.npz`` of flax
params (the port's counterpart of ``tools/convert_checkpoint.py``).

    python3 -m sylph_tpu_torch.tools.convert_checkpoint --src model.pth \
        --out converted.npz [--num-tower-convs 4] [--allow-unmapped]

The ``.npz`` keys are the flax paths joined by ``/``, the JAX CLI's file,
which MODEL.WEIGHTS loads in both packages. Every run prints the
per-module-family matched / unmatched audit and exits non-zero if a
source key that carries weights went unmapped: that weight would stay at
its random init in the target model. ``--allow-unmapped`` turns the exit
into a warning, for a deliberately partial conversion. Host only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils.convert_d2 import (convert_detectron2_checkpoint,
                                load_torch_state_dict)
from ..utils.convert_weights import flatten_params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True, help=".pth or .pkl checkpoint")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--num-tower-convs", type=int, default=4)
    p.add_argument("--allow-unmapped", action="store_true",
                   help="warn instead of failing on unmapped source keys")
    args = p.parse_args(argv)

    sd = load_torch_state_dict(args.src)
    report = {}
    params = convert_detectron2_checkpoint(
        sd, num_tower_convs=args.num_tower_convs, report=report)
    flat = flatten_params(params)
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} arrays "
          f"({sum(v.size for v in flat.values())/1e6:.2f}M params) "
          f"to {args.out}")

    print("target subtrees:", sorted({k.split("/")[0] for k in flat}))
    for fam, stats in report["by_family"].items():
        if stats["matched"] or stats["unmatched"]:
            print(f"  {fam:16s} matched {stats['matched']:4d}  "
                  f"unmatched {len(stats['unmatched'])}")
    if report["ignored"]:
        print(f"  ignored (non-weight) keys: {len(report['ignored'])}")
    if report["unmatched"]:
        print(f"UNMAPPED source keys ({len(report['unmatched'])}) — these "
              "weights would stay at RANDOM INIT:")
        for k in report["unmatched"][:40]:
            print("  ", k)
        if not args.allow_unmapped:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
