"""Driver entry points (the port's counterpart of the root
``__graft_entry__.py``): the flagship forward, and a data-parallel dry run
of the whole episodic training step.

    python3 -m sylph_tpu_torch.entry      # entry() once, on the card

``entry()`` returns ``(fn, example_args)``: the query path of the flagship
Meta-FCOS R-50 (CodeGenerator, bf16 activations) over a 20-class code bank
that is all zeros, decoded to final detections at 512x512, batch 1. With a
zero bank every location and class scores sigmoid(0) times its
centerness, so decode hands NMS its full K = 4320 candidates.

``dryrun_multichip(n)`` runs the composed training configuration of
``__graft_entry__.dryrun_multichip`` (2 shots, 1 query, GRAD_ACCUM 2, EMA,
the backbone frozen) over ``n`` gloo ranks on the CPU, each a process of
its own, for two steps; every metric must be finite and the step count 2.
``TPU.STEPS_PER_CALL`` stays 1: the port runs one optimizer step a call.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .ops.decode import decode_proposals
from .ops.fcos_losses import FCOSLossCfg
from .ops.locations import build_location_grid
from .parallel.mesh import create_mesh, shard_batch
from .runner import resolve_device
from .tools.bench_common import (SIZES_OF_INTEREST, STRIDES, QueryPath,
                                 flagship_model)
from .train.optimizer import build_optimizer
from .train.steps import make_episodic_train_step
from .train.train_state import TrainState

ENTRY_CANVAS = (512, 512)
ENTRY_CLASSES = 20


def entry(device="cuda", dtype: torch.dtype = torch.bfloat16):
    """-> (fn, example_args): ``fn(model, images, code_conv, code_bias,
    image_sizes)`` runs ``forward_instances`` and ``decode_proposals``;
    ``example_args`` hold the seeded flagship model, one zero image, the
    zero 20-class bank and the image's size."""
    dev = resolve_device(device)
    model = flagship_model(dev, dtype=dtype)
    code_conv = torch.zeros((ENTRY_CLASSES, 256), device=dev)
    code_bias = torch.zeros((ENTRY_CLASSES,), device=dev)
    grid = QueryPath(model, {"cls_conv": code_conv, "cls_bias": code_bias},
                     ENTRY_CANVAS, 1)

    @torch.inference_mode()
    def forward(model, images, code_conv, code_bias, image_sizes):
        out = model.forward_instances(images, {"cls_conv": code_conv,
                                               "cls_bias": code_bias})
        return decode_proposals(out.logits, out.reg, out.ctrness, out.iou,
                                grid.locations, grid.strides, image_sizes,
                                grid.dcfg, grid.level_splits)

    images = torch.zeros((1, *ENTRY_CANVAS, 3), device=dev)
    sizes = torch.tensor([list(ENTRY_CANVAS)], dtype=torch.int32, device=dev)
    return forward, (model, images, code_conv, code_bias, sizes)


# ------------------------------------------------------------- dry run
DRYRUN_CANVAS = (128, 128)
DRYRUN_SHOT, DRYRUN_QUERY, DRYRUN_ACCUM, DRYRUN_STEPS = 2, 1, 2, 2


def dryrun_batch(n_ranks: int):
    """``__graft_entry__.dryrun_multichip``'s global batch for ``n_ranks``:
    GRAD_ACCUM episodes a rank, one box a support and two GT slots a
    query (one valid)."""
    e = n_ranks * DRYRUN_ACCUM
    shot, q = DRYRUN_SHOT, DRYRUN_QUERY
    rng = np.random.RandomState(0)
    batch = {
        "support_images": rng.rand(e * shot, *DRYRUN_CANVAS, 3),
        "support_boxes": np.tile(np.array([[10, 10, 90, 100.0]]),
                                 (e * shot, 1)),
        "support_box_valid": np.ones((e * shot,), bool),
        "query_images": rng.rand(e * q, *DRYRUN_CANVAS, 3),
        "query_gt_boxes": np.tile(np.array([[[12, 12, 80, 96.0]]]),
                                  (e * q, 2, 1)),
        "query_gt_labels": np.tile(np.array([[1, 0]]), (e * q, 1)),
        "query_gt_valid": np.tile(np.array([[True, False]]), (e * q, 1)),
        "episode_class_ids": np.arange(e) % 7,
    }

    def tensor(v):
        t = torch.from_numpy(np.asarray(v))
        if t.is_floating_point():
            return t.float()
        return t if t.dtype == torch.bool else t.int()
    return {k: tensor(v) for k, v in batch.items()}


def _dryrun_rank(rank: int, n_ranks: int, work: str) -> None:
    torch.set_num_threads(1)
    group = create_mesh("cpu", init_method="file://" + os.path.join(
        work, "rendezvous"), rank=rank, world_size=n_ranks)
    try:
        model = flagship_model("cpu", dtype=torch.float32)
        tx, _ = build_optimizer(
            model, base_lr=5e-4, warmup_iters=0, clip_grad_norm=1.0,
            freeze_cfg={"backbone": True, "episodic": True})
        state = TrainState(model, tx, use_ema=True)
        grid = build_location_grid(DRYRUN_CANVAS, STRIDES,
                                   list(SIZES_OF_INTEREST))
        step = make_episodic_train_step(model, grid, FCOSLossCfg(),
                                        num_shots=DRYRUN_SHOT,
                                        grad_accum=DRYRUN_ACCUM, group=group)
        batch = shard_batch(dryrun_batch(n_ranks), group)
        metrics = []
        for _ in range(DRYRUN_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        bad = {k: v for m in metrics for k, v in m.items()
               if not np.isfinite(v)}
        if bad or state.step != DRYRUN_STEPS:
            raise AssertionError(f"rank {rank}: step {state.step}, "
                                 f"non-finite {bad}")
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump({"step": state.step, "metrics": metrics}, f)
    finally:
        group.close()


def dryrun_multichip(n_devices: int) -> dict:
    """Two episodic training steps over ``n_devices`` gloo ranks on the
    CPU (one process each, spawned and joined here); a rank that fails
    fails the call. -> rank 0's {"step", "metrics"}."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sylph_dryrun_") as work:
        mp.start_processes(_dryrun_rank, args=(n_devices, work),
                           nprocs=n_devices, join=True,
                           start_method="spawn")
        with open(os.path.join(work, "rank0.json")) as f:
            result = json.load(f)
    print(f"dryrun_multichip({n_devices}) ok (shot={DRYRUN_SHOT}, "
          f"grad_accum={DRYRUN_ACCUM}, steps={DRYRUN_STEPS}):",
          {k: round(float(np.mean([m[k] for m in result["metrics"]])), 4)
           for k in result["metrics"][0]})
    return result


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() ran; detections:", tuple(out.boxes.shape))
