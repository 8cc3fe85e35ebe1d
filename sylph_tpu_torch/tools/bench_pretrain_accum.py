"""Sweep ``TPU.GRAD_ACCUM`` for the reference pretrain step (the port's
counterpart of ``tools/bench_pretrain_accum.py``).

    python3 -m sylph_tpu_torch.tools.bench_pretrain_accum [--batch 128]
        [--canvas 1024 1024] [--accum 64 32 16 8] [--remat] [--iters 6]
        [--device cuda]

For non-episodic training the micro-batch size is a reduction order only,
so each m trades throughput against activation memory. The driver builds
the real pretrain step (``train/steps.py::make_pretrain_train_step``, the
default config's loss) at batch 128 on the 1024x1024 canvas with
synthetic data on the device (about 20 valid boxes an image across
scales), and for each m that divides the batch prints one JSON row: the
first step's seconds, the best and median of ``--iters`` synchronised
steps, images per second, the first loss, and ``peak_allocated_gb``, the
most memory the caching allocator handed out over the row's steps
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``).
A row that runs out of memory records the error and the sweep goes on.
``--remat`` recomputes the backbone's activations in the backward pass
(``torch.utils.checkpoint``). The last line is ``{"sweep": rows}``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import get_default_cfg
from ..ops.locations import build_location_grid
from ..runner import _loss_cfg, resolve_device
from ..train.optimizer import build_optimizer
from ..train.steps import make_pretrain_train_step
from ..train.train_state import TrainState
from .bench_common import call_times_s, device_name, flagship_model, sync

MAX_GT = 100


def pretrain_batch(batch: int, canvas: Sequence[int], device
                   ) -> Dict[str, torch.Tensor]:
    """The JAX driver's synthetic batch, drawn from ``RandomState(0)`` in its
    order: uint8 images, boxes of 16-300 px, 5-39 valid a row."""
    rs = np.random.RandomState(0)
    b, m = batch, MAX_GT
    cx = rs.uniform(64, canvas[1] - 64, (b, m))
    cy = rs.uniform(64, canvas[0] - 64, (b, m))
    w = rs.uniform(16, 300, (b, m))
    h = rs.uniform(16, 300, (b, m))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     -1).astype(np.float32)
    out = {"images": rs.randint(0, 256, (b, *canvas, 3), dtype=np.uint8),
           "gt_boxes": boxes,
           "gt_labels": rs.randint(0, 60, (b, m), dtype=np.int64)
           .astype(np.int32),
           "gt_valid": np.arange(m)[None, :] < rs.randint(5, 40, (b, 1))}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def sweep(device="cuda", batch: int = 128, canvas: Sequence[int] = (1024,
                                                                    1024),
          accum: Sequence[int] = (64, 32, 16, 8), remat: bool = False,
          iters: int = 6, depth: int = 50) -> List[Dict]:
    dev = resolve_device(device)
    cfg = get_default_cfg()
    model = flagship_model(dev, depth=depth, code_generator_name="none",
                           remat_backbone=remat)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    grid = build_location_grid(tuple(canvas),
                               tuple(cfg.MODEL.FCOS.FPN_STRIDES),
                               list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))
    data = pretrain_batch(batch, canvas, dev)
    sync(dev)
    rows = []
    for m in accum:
        if batch % m:
            continue
        model.load_state_dict(start)
        tx, _ = build_optimizer(model, base_lr=0.01)
        state = TrainState(model, tx)
        step = make_pretrain_train_step(model, grid, _loss_cfg(cfg),
                                        grad_accum=m)
        row = {"grad_accum": m, "micro_batch": batch // m, "remat": remat}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        carry = {"state": state}

        def one_step():
            carry["state"], carry["metrics"] = step(carry["state"], data)
        try:
            row["first_step_s"] = round(
                call_times_s(one_step, (), dev, 1)[0], 1)
            times = call_times_s(one_step, (), dev, iters)
            metrics = carry["metrics"]
            row["sec_per_iter"] = round(min(times), 2)
            row["sec_per_iter_median"] = round(
                sorted(times)[len(times) // 2], 2)
            row["img_per_sec"] = round(batch / min(times), 1)
            row["loss_cls"] = round(float(metrics["loss_fcos_cls"]), 4)
        except torch.cuda.OutOfMemoryError as e:
            row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        finally:
            del state, carry, tx, step
            if dev.type == "cuda":
                row["peak_allocated_gb"] = (
                    torch.cuda.max_memory_allocated(dev) / 1e9)
                torch.cuda.empty_cache()
        row["device"] = device_name(dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--canvas", type=int, nargs=2, default=(1024, 1024))
    p.add_argument("--accum", type=int, nargs="+", default=(64, 32, 16, 8))
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone's activations in the "
                        "backward pass (TPU.REMAT_BACKBONE)")
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = sweep(args.device, args.batch, args.canvas, args.accum,
                 args.remat, args.iters)
    print(json.dumps({"sweep": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
