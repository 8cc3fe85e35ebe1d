"""LVIS-scale class-registration benchmark (the port's counterpart of
sylph_tpu/tools/bench_registration.py).

Times registering N classes (default 1203, the LVIS universe) at EVAL_SHOT
support images each through the real phase-1 path
(``evaluation.meta_eval.generate_class_codes``), host->device copies of the
uint8 support batches and device->host fetches of the code rows included:
what ``do_test`` phase 1 or ``SylphPredictor.register_dataset`` pays per
class. It times TPU.CLASS_BATCH classes per model call and, with
``--single``, one class per call (on at most 64 classes: the slow path).

    python -m sylph_tpu_torch.tools.bench_registration [--classes 1203]
        [--shot 10] [--class-batch 8] [--single] [--device cuda]
        [KEY VALUE ...]

The model is the default Meta-FCOS config (R-50, bf16, 384x384 support
canvas) with random weights from its seed; trailing KEY VALUE pairs change
the config. One batched call runs before the timed window, and the window
ends after ``torch.cuda.synchronize()``. Prints one JSON line with
``ms_per_class`` (and ``ms_per_class_single``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..evaluation.meta_eval import generate_class_codes
from ..runner import MetaFCOSRunner


def synthetic_support_loader(n_classes: int, shot: int, canvas,
                             seed: int = 0, distinct: int = 32):
    """Items shaped as ``data.loader.build_support_set_loader`` yields them
    (uint8 canvases, one box per shot), byte-equal to the JAX package's
    for the same arguments.

    Pixels come from a ring of ``distinct`` random canvases made up front:
    drawing 4.4 MB of fresh uint8 per class would time the host's random
    number generator, where serving reads decoded images. Boxes differ per
    class."""
    rng = np.random.RandomState(seed)
    h, w = canvas
    ring = [rng.randint(0, 256, (shot, h, w, 3), dtype=np.uint8)
            for _ in range(min(distinct, n_classes))]
    for ci in range(n_classes):
        x0 = rng.randint(0, w // 2, (shot, 1))
        y0 = rng.randint(0, h // 2, (shot, 1))
        boxes = np.concatenate(
            [x0, y0, x0 + rng.randint(16, w // 2, (shot, 1)),
             y0 + rng.randint(16, h // 2, (shot, 1))], 1
        ).astype(np.float32)                      # (shot, 4)
        yield {
            "support_images": ring[ci % len(ring)],
            "support_boxes": boxes,
            "support_box_valid": np.ones((shot,), bool),
            "class_id": ci,
            "class_name": f"class_{ci:04d}",
        }


def _timed_codes(model, n: int, shot: int, canvas, class_batch: int,
                 device: torch.device) -> float:
    """Seconds to register ``n`` synthetic classes, the card finished."""
    t0 = time.perf_counter()
    codes = generate_class_codes(
        model, synthetic_support_loader(n, shot, canvas),
        class_batch=class_batch, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if len(codes) != n:
        raise AssertionError(f"registered {len(codes)} of {n} classes")
    return wall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", type=int, default=1203)
    ap.add_argument("--shot", type=int, default=10)
    ap.add_argument("--class-batch", type=int, default=None,
                    help="default: cfg.TPU.CLASS_BATCH")
    ap.add_argument("--single", action="store_true",
                    help="also time one class per call (on at most 64 "
                         "classes: it is the slow path)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args(argv)

    runner = MetaFCOSRunner(device=args.device)
    cfg = runner.get_default_cfg()
    cfg.MODEL.META_LEARN.EPISODIC_LEARNING = True
    cfg.MODEL.META_LEARN.EVAL_SHOT = args.shot
    cfg.MODEL.META_LEARN.SHOT = args.shot
    if args.opts:
        cfg.merge_from_list(args.opts)
    cb = args.class_batch or cfg.TPU.CLASS_BATCH
    model = runner.build_model(cfg)
    canvas = tuple(cfg.TPU.SUPPORT_CANVAS)
    dev = runner.device

    _timed_codes(model, cb, args.shot, canvas, cb, dev)  # warm-up call
    wall = _timed_codes(model, args.classes, args.shot, canvas, cb, dev)
    result = {"classes": args.classes, "shot": args.shot, "class_batch": cb,
              "canvas": list(canvas), "dtype": cfg.TPU.COMPUTE_DTYPE,
              "device": str(dev), "wall_s": wall,
              "ms_per_class": wall / args.classes * 1e3}
    if args.single:
        n_single = min(64, args.classes)
        _timed_codes(model, 1, args.shot, canvas, 1, dev)  # warm-up call
        result["classes_single"] = n_single
        result["ms_per_class_single"] = _timed_codes(
            model, n_single, args.shot, canvas, 1, dev) / n_single * 1e3
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
