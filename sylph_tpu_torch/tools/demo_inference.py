"""Self-contained serving demo: register a class from synthetic support
crops, then detect it — no datasets, no checkpoints (the port's counterpart
of sylph_tpu/tools/demo_inference.py).

  python -m sylph_tpu_torch.tools.demo_inference [--depth 50] [--canvas 512]
      [--shots 5] [--runner MetaFCOSROIEncoderRunner] [--device cuda]

Runs the whole serving path on the card (``--device cpu`` asks for the
CPU): backbone -> code generator -> a bank row written in place -> the
conditioned query head -> candidate selection -> the NMS kernel ->
detections, timing each stage. The weights are random, from the config's
seed, so the detections say nothing of quality.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..predictor import SylphPredictor
from ..runner import create_runner


def _timed(device: torch.device, fn):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--shots", type=int, default=5)
    p.add_argument("--runner", default="MetaFCOSRunner",
                   choices=("MetaFCOSRunner", "MetaFCOSROIEncoderRunner"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = create_runner(args.runner, device=args.device).get_default_cfg()
    cfg.MODEL.RESNETS.DEPTH = args.depth
    cfg.MODEL.META_LEARN.EPISODIC_LEARNING = True
    cfg.MODEL.META_LEARN.SHOT = args.shots
    cfg.TPU.EVAL_CANVAS = [args.canvas, args.canvas]
    cfg.TPU.SUPPORT_CANVAS = [256, 256]
    cfg.INPUT.MIN_SIZE_TEST = args.canvas - 64
    cfg.INPUT.MAX_SIZE_TEST = args.canvas

    t0 = time.perf_counter()
    pred = SylphPredictor(cfg=cfg, max_classes=64, runner_name=args.runner,
                          device=args.device)
    dev = pred.device
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}); runner {args.runner}")
    print(f"model built and initialized in {time.perf_counter() - t0:.1f} s "
          f"(random weights)")

    rng = np.random.RandomState(0)
    support, boxes = [], []
    for _ in range(args.shots):
        img = rng.randint(0, 80, (300, 400, 3), np.uint8)
        img[60:200, 100:320] = [200, 40, 40]  # the "object"
        support.append(img)
        boxes.append(np.array([100, 60, 320, 200], np.float32))

    _, dt = _timed(dev, lambda: pred.register_class("red-widget", support,
                                                    boxes))
    print(f"registered 'red-widget' from {args.shots} shots in {dt:.2f} s "
          "(the first call includes cuDNN's plan search)")

    query = rng.randint(0, 80, (360, 480, 3), np.uint8)
    query[100:260, 120:380] = [200, 40, 40]
    _, dt = _timed(dev, lambda: pred(query))
    print(f"first query {dt:.2f} s (builds the NMS kernel on a card)")
    out, dt = _timed(dev, lambda: pred(query))
    print(f"warm query {1e3 * dt:.1f} ms")
    n = len(out["boxes"])
    print(f"{n} detections; top-3:")
    for i in range(min(3, n)):
        print(f"  {out['class_names'][i]}  score={out['scores'][i]:.3f}  "
              f"box={np.round(out['boxes'][i], 1).tolist()}")

    # a second registration writes one more bank row and rebuilds nothing
    pred.register_class("another", support, boxes)
    _, dt = _timed(dev, lambda: pred(query))
    print(f"query after a 2nd registration: {1e3 * dt:.1f} ms")
    return out


if __name__ == "__main__":
    main()
