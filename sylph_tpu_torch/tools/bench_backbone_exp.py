"""The query path under one weight-residency variant (the port's
counterpart of ``tools/bench_backbone_exp.py``).

    python3 -m sylph_tpu_torch.tools.bench_backbone_exp
        [--variant baseline|bf16_params] [--batch 16] [--iters 30]
        [--device cuda]

  --variant baseline      float32 parameters (cast to bf16 at each use)
  --variant bf16_params   every floating parameter and buffer held in
                          bfloat16: half the weight reads

Times the full conditioned query path (backbone, towers, conditional head,
decode and NMS) at 768x1280: 5 warm-up calls, then the mean of
``--iters`` between two synchronisations. Prints one JSON line.
``--variant lhs`` (XLA's latency-hiding scheduler flags) raises: it is a
workaround for the TPU's compiler and needs no port.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import torch

from ..runner import resolve_device
from .bench_common import (CANVAS, N_CLASSES, QueryPath, device_name,
                           flagship_model, mean_call_s, query_images,
                           random_bank, store_params)

VARIANTS = ("baseline", "bf16_params", "lhs")
LHS_RULE = ("--variant lhs sets XLA's latency-hiding scheduler flags, a "
            "workaround for the TPU that needs no port (ROADMAP ground "
            "rules); the port has no XLA")


def run(device="cuda", variant: str = "baseline", batch: int = 16,
        iters: int = 30, depth: int = 50, canvas: Sequence[int] = CANVAS,
        n_classes: int = N_CLASSES) -> Dict:
    if variant == "lhs":
        raise NotImplementedError(LHS_RULE)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    dev = resolve_device(device)
    model = flagship_model(dev, depth=depth)
    if variant == "bf16_params":
        store_params(model)
    images = query_images(batch, canvas, dev)
    path = QueryPath(model, random_bank(n_classes, dev), canvas, batch)
    sec = mean_call_s(path, (images,), dev, iters)
    return {"variant": variant, "batch": batch,
            "img_per_sec": round(batch / sec, 2),
            "ms_per_batch": round(sec * 1000, 2),
            "xla_flags": None,  # the JAX driver's XLA flags; no XLA here
            "device": device_name(dev)}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", default="baseline", choices=VARIANTS)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    line = run(args.device, args.variant, args.batch, args.iters)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
