"""Episodic meta-training throughput (the port's counterpart of
``tools/bench_train.py``).

    python3 -m sylph_tpu_torch.tools.bench_train [--episodes 8] [--shot 5]
        [--query 1] [--canvas 512] [--iters 10] [--steps-per-call 1]
        [--device cuda]

Times the full episodic training step (``train/steps.py::
make_episodic_train_step``: the frozen backbone and FPN on the supports and
queries under ``stop_backbone_grad``, code generation, the conditioned
episodic losses, one SGD update) on one synthetic batch kept on the
device: one warm step, then ``--iters`` steps between two
synchronisations. The model is the flagship R-50 in bf16 from the flax
initializers' distributions, with the backbone, the episodic code path and
the bbox branch frozen as the JAX driver freezes them. Prints
``episodic_train_episodes_per_sec`` with the JAX driver's ``extra`` keys.
``--steps-per-call K`` (``TPU.STEPS_PER_CALL``) stacks the batch K times and
times ``--iters`` calls of K steps each; the rate is per step.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ..ops.fcos_losses import FCOSLossCfg
from ..ops.locations import build_location_grid
from ..runner import resolve_device
from ..train.optimizer import build_optimizer
from ..train.steps import (make_episodic_train_step, metric_rows,
                           stack_batches)
from ..train.train_state import TrainState
from .bench_common import (SIZES_OF_INTEREST, STRIDES, device_name,
                           flagship_model, mean_call_s)

def episodic_batch(episodes: int, shot: int, query: int, canvas: int,
                   device) -> Dict[str, torch.Tensor]:
    """The JAX driver's synthetic batch, drawn from ``RandomState(0)`` in its
    order, on ``device``."""
    e, q = episodes, query
    rng = np.random.RandomState(0)
    batch = {
        "support_images": rng.rand(e * shot, canvas, canvas, 3)
        .astype(np.float32),
        "support_boxes": np.tile(
            np.array([[20, 20, 300, 320.0]], np.float32), (e * shot, 1)),
        "support_box_valid": np.ones((e * shot,), bool),
        "query_images": rng.rand(e * q, canvas, canvas, 3)
        .astype(np.float32),
        "query_gt_boxes": np.tile(
            np.array([[[24, 24, 280, 300.0]]], np.float32), (e * q, 4, 1)),
        "query_gt_labels": np.tile(np.array([[3, 0, 0, 0]], np.int32),
                                   (e * q, 1)),
        "query_gt_valid": np.tile(np.array([[True, False, False, False]]),
                                  (e * q, 1)),
        "episode_class_ids": (np.arange(e) % 60).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(device="cuda", episodes: int = 8, shot: int = 5, query: int = 1,
        canvas: int = 512, iters: int = 10, steps_per_call: int = 1,
        depth: int = 50) -> Dict:
    k = max(1, steps_per_call)
    dev = resolve_device(device)
    model = flagship_model(dev, depth=depth, stop_backbone_grad=True)
    tx, _ = build_optimizer(
        model, base_lr=5e-4, warmup_iters=0, clip_grad_norm=1.0,
        freeze_cfg={"backbone": True, "episodic": True,
                    "bbox_branch": True})
    state = TrainState(model, tx)
    grid = build_location_grid((canvas, canvas), STRIDES,
                               list(SIZES_OF_INTEREST))
    step = make_episodic_train_step(model, grid, FCOSLossCfg(),
                                    num_shots=shot, steps_per_call=k)
    batch = episodic_batch(episodes, shot, query, canvas, dev)
    if k > 1:
        batch = stack_batches([batch] * k)
    carry = {"state": state}

    def one_call():
        carry["state"], carry["metrics"] = step(carry["state"], batch)
    dt = mean_call_s(one_call, (), dev, iters, warmup=1) / k
    last = metric_rows(carry["metrics"], k)[-1]
    e = episodes
    return {
        "metric": "episodic_train_episodes_per_sec",
        "value": round(e / dt, 2), "unit": "episodes/sec",
        "extra": {
            "sec_per_step": round(dt, 4),
            "images_per_step": e * (shot + query),
            "images_per_sec": round(e * (shot + query) / dt, 1),
            "canvas": canvas, "shot": shot,
            "steps_per_call": k,
            "devices": 1,
            "device": device_name(dev),
            "losses": last,
        },
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--episodes", type=int, default=8)
    p.add_argument("--shot", type=int, default=5)
    p.add_argument("--query", type=int, default=1)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K optimizer steps a call (TPU.STEPS_PER_CALL)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    line = run(args.device, args.episodes, args.shot, args.query,
               args.canvas, args.iters, args.steps_per_call)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
