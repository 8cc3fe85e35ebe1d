"""What bfloat16 weights cost numerically (the port's counterpart of
``tools/bf16_fidelity_probe.py``).

    python3 -m sylph_tpu_torch.tools.bf16_fidelity_probe [--device cuda]

Runs the conditioned query path (backbone, towers, conditional head,
decode and NMS) twice with the same model and inputs, bf16 activations
both times: once with its float32 weights, once with every floating
parameter and buffer rounded to bfloat16 (and held in float32). Batch 4 at
768x1280, a bank of ``RandomState(7).rand(20, 256)`` kernels with zero
biases. Prints one JSON line: the max and RMS of the logit, probability,
box-regression (pixels) and decoded-score deltas, and the float32 logits'
range.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import numpy as np
import torch

from ..runner import resolve_device
from .bench_common import (CANVAS, N_CLASSES, QueryPath, device_name,
                           flagship_model, query_images, random_bank)


def _stats(a: torch.Tensor, b: torch.Tensor) -> Dict:
    d = (a.float() - b.float()).abs()
    return {"max": round(float(d.max()), 4),
            "rms": round(float(torch.sqrt((d.double() ** 2).mean())), 5)}


def run(device="cuda", batch: int = 4, depth: int = 50,
        canvas: Sequence[int] = CANVAS, n_classes: int = N_CLASSES) -> Dict:
    dev = resolve_device(device)
    model = flagship_model(dev, depth=depth)
    images = query_images(batch, canvas, dev)
    path = QueryPath(model, random_bank(n_classes, dev), canvas, batch)

    def query():
        with torch.inference_mode():
            out = path.dense(images)
            return out.logits, out.reg, path.decode(out)

    lg32, rg32, det32 = query()
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            if t.is_floating_point():
                t.copy_(t.bfloat16().float())
    lg16, rg16, det16 = query()
    return {
        "logit_delta": _stats(lg32, lg16),
        "prob_delta": _stats(torch.sigmoid(lg32), torch.sigmoid(lg16)),
        "reg_delta_px": _stats(rg32, rg16),
        "decoded_score_delta": _stats(det32.scores, det16.scores),
        "logit_range": [round(float(lg32.min()), 2),
                        round(float(lg32.max()), 2)],
        "device": device_name(dev),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    line = run(args.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
