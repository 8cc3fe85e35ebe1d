"""Where one serving request's time goes on the card.

    python3 -m sylph_tpu_torch.tools.profile_serving [--out FILE]
        [--runner MetaFCOSROIEncoderRunner] [--deformable]

Builds the predictor of chip_smoke.py's serving phase (Meta-FCOS finetune
config, R-50 at the 1024x1344 eval canvas, a 1280-row bank with 3
registered classes of 10 shots, random weights from a fixed seed,
INFERENCE_TH_TEST 0.02), warms it up, then:

  * times each stage of a request with CUDA events (median of 10):
    host preprocessing, backbone + FPN, FCOS head with the conditional
    classifier, candidate selection (sigmoid, threshold, top-k), NMS,
    and the whole ``__call__`` on the host clock;
  * traces 5 requests with ``torch.profiler`` and reports the device's busy
    share, the kernels that take the most device time, and the NMS
    kernels' own time.

``--runner MetaFCOSROIEncoderRunner`` serves the COCO ROIEncoder finetune
config instead (codes as the ROIEncoder emits them); ``--deformable`` turns
on MODEL.FCOS.USE_DEFORMABLE (DCNv2 as the last conv of each tower).

Prints the card's ``name, power.limit`` beside the numbers; the full
per-kernel table goes to ``--out`` (default profile_serving.txt).
Needs a card: it raises without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from ..ops.decode import select_candidates
from ..ops.nms import batched_multiclass_nms
from ..predictor import SylphPredictor
from .profile_meta_test import ONE_STAGE


def _median_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build_predictor(runner: str = "MetaFCOSRunner",
                    deformable: bool = False) -> SylphPredictor:
    cls, config = ONE_STAGE[runner]
    cfg = cls.get_default_cfg()
    cfg.merge_from_file(config)
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.02  # random weights: scores < 0.04
    cfg.MODEL.FCOS.USE_DEFORMABLE = deformable
    pred = SylphPredictor(cfg=cfg, runner_name=runner, device="cuda")
    rng = np.random.RandomState(0)
    shots = cfg.MODEL.META_LEARN.EVAL_SHOT
    for name in ("class_a", "class_b", "class_c"):
        imgs = [rng.randint(0, 256, (480, 400, 3), dtype=np.uint8)
                for _ in range(shots)]
        boxes = [np.array([40, 30, 300, 420], np.float32)] * shots
        pred.register_class(name, imgs, boxes)
    return pred


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="profile_serving.txt")
    parser.add_argument("--runner", default="MetaFCOSRunner",
                        choices=("MetaFCOSRunner", "MetaFCOSROIEncoderRunner"))
    parser.add_argument("--deformable", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serving needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    pred = build_predictor(args.runner, args.deformable)
    image = np.random.RandomState(1).randint(0, 256, (800, 1216, 3),
                                             dtype=np.uint8)
    for _ in range(3):
        pred(image)
    torch.cuda.synchronize()

    canvas, size, _ = pred.prepare(image)
    model, code, dcfg = pred.model, pred.bank.as_code(), pred.decode_cfg
    with torch.inference_mode():
        feats = model.extract_features(canvas)
        out = model.fcos_head(feats, class_code=code)
        cand = select_candidates(out.logits, out.reg, out.ctrness, out.iou,
                                 pred.locations, pred.strides, dcfg,
                                 pred.level_splits, pred.bank.valid)
        stages = {
            "backbone+fpn": lambda: model.extract_features(canvas),
            "fcos_head (conditional, 1280 rows)":
                lambda: model.fcos_head(feats, class_code=code),
            "select_candidates (sigmoid, threshold, top-k)":
                lambda: select_candidates(
                    out.logits, out.reg, out.ctrness, out.iou,
                    pred.locations, pred.strides, dcfg, pred.level_splits,
                    pred.bank.valid),
            "nms (class offset, kernel, gathers)":
                lambda: batched_multiclass_nms(
                    cand.boxes, cand.scores, cand.classes, cand.valid,
                    dcfg.nms_thresh, dcfg.post_nms_topk),
        }
        stage_ms = {name: _median_ms(fn) for name, fn in stages.items()}
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.prepare(image)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    wall = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred(image)
        wall.append((time.perf_counter() - t0) * 1e3)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            pred(image)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    # Device time from the kernel events alone (an operator's own entry
    # would count its kernels a second time).
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (tot + e.time_range.elapsed_us() / 1e3,
                                  n + 1)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    busy_ms = sum(ms for ms, _ in per_kernel.values())

    print(f"[profile] card: {card}")
    print(f"[profile] request 800x1216 -> canvas "
          f"{tuple(pred.eval_canvas)}, bf16 activations")
    print(f"[profile] host preprocessing (resize, pad, upload): "
          f"{np.median(host):.2f} ms")
    for name, ms in stage_ms.items():
        print(f"[profile] stage {name}: {ms:.3f} ms")
    print(f"[profile] whole __call__ (host clock, median of 10): "
          f"{np.median(wall):.2f} ms")
    print(f"[profile] traced 5 requests: {traced_ms:.1f} ms wall, device "
          f"busy {busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / traced_ms):.1f}%")
    for name, (ms, n) in kernels[:12]:
        print(f"[profile]   {ms / 5:8.3f} ms/request  x{n // 5:<4d} "
              f"{name[:90]}")
    for name, (ms, n) in kernels:  # the NMS kernels, wherever they rank
        if "rank_kernel" in name or "scan_kernel" in name:
            print(f"[profile]   NMS {ms / 5:8.4f} ms/request  x{n // 5:<4d} "
                  f"{name[:90]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n")
        for name, (ms, n) in kernels:
            f.write(f"{ms / 5:10.4f} ms/request  x{n // 5:<5d} {name}\n")


if __name__ == "__main__":
    main()
