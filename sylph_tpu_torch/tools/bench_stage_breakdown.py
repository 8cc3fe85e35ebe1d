"""Per-stage breakdown of the conditioned query path (the port's
counterpart of ``tools/bench_stage_breakdown.py``).

    python3 -m sylph_tpu_torch.tools.bench_stage_breakdown [--batch 16]
        [--iters 20] [--f32] [--device cuda]

Three nested stages, each timed as the best of ``--iters`` synchronised
calls after one warm call: ``extract_features`` (backbone + FPN),
``forward_instances`` (+ the towers and the conditional head), and the
whole query path (+ decode and NMS). The deltas are the stage costs. Batch
16 at 768x1280, a bank of ``RandomState(7).rand(20, 256)`` kernels with
zero biases, bf16 activations; the parameters are held in bfloat16 unless
``--f32`` keeps them in float32. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import torch

from ..runner import resolve_device
from .bench_common import (CANVAS, N_CLASSES, QueryPath, best_call_ms,
                           device_name, flagship_model, query_images,
                           random_bank, store_params)


def run(device="cuda", batch: int = 16, iters: int = 20, f32: bool = False,
        depth: int = 50, canvas: Sequence[int] = CANVAS,
        n_classes: int = N_CLASSES) -> Dict:
    dev = resolve_device(device)
    model = flagship_model(dev, depth=depth, code_generator_name="none")
    if not f32:
        store_params(model, torch.bfloat16)
    images = query_images(batch, canvas, dev)
    path = QueryPath(model, random_bank(n_classes, dev), canvas, batch)

    with torch.inference_mode():
        bb = best_call_ms(model.extract_features, (images,), dev, iters)
        hd = best_call_ms(path.dense, (images,), dev, iters)
        fl = best_call_ms(path, (images,), dev, iters)
    return {
        "residency": "f32" if f32 else "bf16",
        "batch": batch, "canvas": list(canvas),
        "backbone_fpn_ms": round(bb, 1),
        "towers_cond_head_ms": round(hd - bb, 1),
        "decode_nms_ms": round(fl - hd, 1),
        "total_ms": round(fl, 1),
        "img_per_sec": round(batch / (fl / 1000), 1),
        "device": device_name(dev),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--f32", action="store_true",
                   help="keep float32 parameters (the baseline comparison)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    line = run(args.device, args.batch, args.iters, args.f32)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
