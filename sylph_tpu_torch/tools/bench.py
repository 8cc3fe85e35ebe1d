"""Benchmark: Meta-FCOS R-50 few-shot inference throughput on one card
(the port's counterpart of the root ``bench.py``).

    python3 -m sylph_tpu_torch.tools.bench [--device cuda]

Prints one JSON line, ``{"metric", "value", "unit", "vs_baseline",
"extra"}``, with bench.py's keys: images per second for the flagship query
path (the CodeGenerator-conditioned R-50 FCOS, decode and NMS, a 20-class
bank) at batch 48 on the 768x1280 canvas, and code generation in ms a class
(10 shots at 384x384), one class a call and ``CLASS_BATCH`` 8 a call.
``vs_baseline`` is against bench.py's target of 100 img/s. ``extra`` adds
the ms a batch, the peak memory, the query path's GFLOP an image (its
convolutions and the conditional classifier, counted from their shapes)
and the share of the card's dense bf16 peak that rate reaches (None off
the card).

The model's weights come from the flax initializers' distributions
(``init_train_weights``) drawn from seed 0. The bank is made, as bench.py
makes it, from seeded random support crops through ``forward_class_code``
and ``normalize_code``: never zeros, which would pass every location
through the score threshold. On a card the parameters are then held in
bfloat16, as the JAX package serves (``TPU.EVAL_BF16_RESIDENT``); on the
CPU they stay float32. The images are uploaded once, outside the timed
calls; each timing is 5 warm-up calls, then the mean of 30 (10 for the
class-batched codes) between two synchronisations.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import numpy as np
import torch

from ..runner import resolve_device
from ..utils.events import peak_memory_gb
from .bench_common import (BF16_DENSE_FLOPS, CANVAS, N_CLASSES, QueryPath,
                           bank_inputs, device_name, flagship_model,
                           make_bank, mean_call_s, query_flops_per_image,
                           query_images, store_params)

METRIC = "meta_fcos_r50_query_images_per_sec_per_chip"
TARGET_IMG_S = 100.0  # bench.py's target
BATCH = 48
SHOTS = 10
SUPPORT_CANVAS = (384, 384)
CLASS_BATCH = 8


def build_query_path(device, depth: int = 50,
                     canvas: Sequence[int] = CANVAS, batch: int = BATCH,
                     n_classes: int = N_CLASSES, bank_size: int = 192,
                     dtype: torch.dtype = torch.bfloat16):
    """bench.py's set-up: the seeded model, the normalized bank from its
    random support crops, the parameters held in bfloat16 on a card, the
    query path. -> (model, bank, QueryPath)."""
    dev = resolve_device(device)
    model = flagship_model(dev, depth=depth, dtype=dtype)
    sup, boxes = bank_inputs(n_classes, bank_size)
    bank = make_bank(model, torch.from_numpy(sup).to(dev),
                     torch.from_numpy(boxes).to(dev))
    if dev.type == "cuda":
        store_params(model, torch.bfloat16)
    return model, bank, QueryPath(model, bank, canvas, batch)


def code_inputs(shots: int, canvas: Sequence[int], device, classes: int = 1,
                seed: int = 1):
    """``classes`` x ``shots`` support images from ``RandomState(seed)``
    (bench.py's (classes, shots, H, W, 3) draw, flattened), each with
    bench.py's one box, all valid."""
    n = classes * shots
    x = np.random.RandomState(seed).rand(n, *canvas, 3).astype(np.float32)
    boxes = torch.tensor([[30.0, 40.0, 350.0, 360.0]],
                         device=device).expand(n, 4).contiguous()
    return (torch.from_numpy(x).to(device), boxes,
            torch.ones((n,), dtype=torch.bool, device=device))


def run(device="cuda", depth: int = 50, canvas: Sequence[int] = CANVAS,
        batch: int = BATCH, n_classes: int = N_CLASSES, shots: int = SHOTS,
        support_canvas: Sequence[int] = SUPPORT_CANVAS,
        class_batch: int = CLASS_BATCH, iters: int = 30, warmup: int = 5,
        batched_iters: int = 10, bank_size: int = 192) -> Dict:
    """bench.py's measurement at the given sizes. -> its JSON line."""
    dev = resolve_device(device)
    model, bank, path = build_query_path(dev, depth, canvas, batch,
                                         n_classes, bank_size)
    images = query_images(batch, canvas, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sec = mean_call_s(path, (images,), dev, iters, warmup)
    peak = peak_memory_gb() if dev.type == "cuda" else None
    images_per_sec = batch / sec

    @torch.inference_mode()
    def codes(sup, boxes, valid):
        return model.forward_class_code(sup, boxes, valid, shots, False)

    code_sec = mean_call_s(codes, code_inputs(shots, support_canvas, dev),
                           dev, iters, warmup)
    batched = code_inputs(shots, support_canvas, dev, classes=class_batch,
                          seed=2)
    code_sec_b = mean_call_s(codes, batched, dev, batched_iters,
                             warmup) / class_batch
    flops = query_flops_per_image(path, canvas)
    return {
        "metric": METRIC,
        "value": round(images_per_sec, 2),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / TARGET_IMG_S, 3),
        "extra": {
            "canvas": list(canvas), "batch": batch,
            "codegen_ms_per_class": round(code_sec_b * 1000, 2),
            "codegen_ms_per_class_single_dispatch":
                round(code_sec * 1000, 2),
            "device": device_name(dev),
            "ms_per_batch": sec * 1e3,
            "peak_memory_gb": peak,
            "gflop_per_image": flops["total"] / 1e9,
            "gflop_per_image_backbone_fpn": flops["backbone_fpn"] / 1e9,
            "gflop_per_image_head": flops["head"] / 1e9,
            "bf16_dense_peak_share": (
                images_per_sec * flops["total"] / BF16_DENSE_FLOPS
                if dev.type == "cuda" else None),
        },
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
