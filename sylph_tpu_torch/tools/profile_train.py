"""Where a training step's time goes on the card.

    python3 -m sylph_tpu_torch.tools.profile_train [--steps 2] [--out FILE]
    python3 -m sylph_tpu_torch.tools.profile_train \
        --runner MetaFasterRCNNRunner [--mode episodic|pretrain] [--steps 2]

Meta-FCOS (the default) runs chip_smoke.py's full-width meta-training
setting (``train_cfg``): the Meta-FCOS finetune config as
``auto_scale_world_size`` leaves it on one card (R-50, FPN 256, 4-conv
towers, bf16, 48 episodes x 5 shots at 384x384 and one 1024x1024 query
each, TPU.GRAD_ACCUM 16, clip 1.0, device RandAugment, backbone and bbox
branch frozen) on a synthetic COCO tree (48 train images of 480x640).
``--runner MetaFasterRCNNRunner`` runs the two-stage setting
(``rcnn_train_cfg``) on a synthetic LVIS tree of the same size: the
Meta-RCNN finetune config (48 episodes in one group, backbone frozen) or,
with ``--mode pretrain``, the pretrain config (batch 32 in micro-batches of
8, everything but FrozenBN trained). Both start from the flax initializers'
distributions; one warm-up step, then ``--steps`` steps traced with
``torch.profiler``. Reports:

  * each traced step's data wait and step wait on the host clock;
  * the device time of the kernels launched inside each named window: for
    Meta-FCOS device RandAugment, target assignment and the optimizer
    update; for the two-stage steps anchor matching and sampling
    (``rpn_losses``), RPN proposals (``rpn_proposals``, its NMS counted
    again on its own), ROI sampling, ROIAlign forward and backward, the box
    head's forward and the optimizer update. The rest of a step is the
    other forward and backward work. The NMS kernel itself is launched
    through ctypes, which the profiler attributes to no window: the NMS
    windows hold the torch work around it, and chip_smoke.py times the
    kernel per step. Then the device's busy and idle share over the traced
    steps;
  * the kernels that take the most device time.

Prints the card's ``name, power.limit`` beside the numbers; the full
per-kernel table goes to ``--out`` (default profile_train.txt). Needs a
card: it raises without CUDA.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time

import torch

from ..config import get_default_cfg
from ..data.catalog import register_all_coco, register_all_lvis
from ..data.synthetic import make_synthetic_coco, make_synthetic_lvis
from ..meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                       TFAFasterRCNNRunner)
from ..models import rcnn
from ..runner import MetaFCOSRunner
from ..train import steps as train_steps
from ..train.train_state import TrainState
from .profile_meta_test import DATA, RCNN_DATA
from .train_net import auto_scale_world_size

CONFIGS = {
    "episodic": "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml",
    "pretrain": "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-pretrain.yaml",
}
RCNN_CONFIGS = {
    "episodic": "sylph://LVISv1-Detection/Meta-RCNN/"
                "Meta-RCNN-FPN-finetune.yaml",
    "pretrain": "sylph://LVISv1-Detection/Meta-RCNN/"
                "Meta-RCNN-FPN-pretrain.yaml",
}
WINDOWS = ("randaugment", "assign", "optimizer")
RCNN_WINDOWS = ("rpn_losses", "rpn_proposals", "rpn_nms", "roi_sampling",
                "roi_align", "roi_align_backward", "box_head", "optimizer")


def train_cfg(mode: str, max_iter: int, out_dir: str = "",
              batch: int = 0):
    """The mode's reference config at full width, auto-scaled to one card,
    training on the synthetic tree for ``max_iter`` steps; ``batch``
    overrides SOLVER.IMS_PER_BATCH (before the auto-scaling)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIGS[mode])
    if batch:
        cfg.SOLVER.IMS_PER_BATCH = batch
    auto_scale_world_size(cfg, world=1)
    cfg.DATASETS.TRAIN = ["coco_meta_train_base" if mode == "episodic"
                          else "coco_pretrain_train_base"]
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.TEST.EVAL_PERIOD = 0
    cfg.OUTPUT_DIR = out_dir
    return cfg


def rcnn_train_cfg(mode: str, max_iter: int, tfa: bool = False):
    """The two-stage ``mode``'s reference config at full width,
    auto-scaled to one card, training on its LVIS datasets for
    ``max_iter`` steps. ``tfa``: the TFA-RCNN finetune on the pretrain
    config (``TFAFasterRCNNRunner``'s defaults, the cosine classifier, the
    backbone, the proposal generator and the box head's FC layers
    frozen)."""
    cfg = (TFAFasterRCNNRunner if tfa else MetaFasterRCNNRunner
           ).get_default_cfg()
    cfg.merge_from_file(RCNN_CONFIGS[mode])
    if tfa:
        cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = True
        cfg.MODEL.BACKBONE.FREEZE = True
        cfg.MODEL.PROPOSAL_GENERATOR.FREEZE = True
        cfg.MODEL.ROI_HEADS.FREEZE_FEAT = True
    auto_scale_world_size(cfg, world=1)
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.TEST.EVAL_PERIOD = 0
    cfg.OUTPUT_DIR = ""
    return cfg


def _window(name: str, fn):
    def traced(*args, **kwargs):
        with torch.profiler.record_function(f"window:{name}"):
            return fn(*args, **kwargs)
    return traced


class _ROIAlignTraced(torch.autograd.Function):
    """ROIAlign whose backward runs inside the ``roi_align_backward``
    window: the forward builds its own graph from detached features, the
    backward differentiates that graph."""

    @staticmethod
    def forward(ctx, fn, strides, boxes, valid, batch_idx, kw, *feats):
        with torch.enable_grad():
            leaves = [f.detach().requires_grad_() for f in feats]
            with torch.profiler.record_function("window:roi_align"):
                out = fn(leaves, strides, boxes, valid, batch_idx, **kw)
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function("window:roi_align_backward"):
            grads = torch.autograd.grad(ctx.out, ctx.leaves, grad)
        return (None,) * 6 + tuple(grads)


def _traced_rcnn_windows():
    """Name the two-stage step's parts in the trace; returns a restore
    function."""
    saved = dict(rpn_losses=rcnn.rpn_losses, rpn_proposals=rcnn.rpn_proposals,
                 rpn_nms=rcnn.batched_multiclass_nms,
                 roi_sampling=rcnn.sample_rois,
                 roi_align=rcnn.multilevel_roi_align)
    head, update = rcnn.ROIBoxHead.forward, TrainState.apply_updates
    rcnn.rpn_losses = _window("rpn_losses", saved["rpn_losses"])
    rcnn.rpn_proposals = _window("rpn_proposals", saved["rpn_proposals"])
    rcnn.batched_multiclass_nms = _window("rpn_nms", saved["rpn_nms"])
    rcnn.sample_rois = _window("roi_sampling", saved["roi_sampling"])

    def roi_align(features, strides, boxes, valid, batch_idx, **kw):
        feats = list(features)
        if not any(f.requires_grad for f in feats):
            with torch.profiler.record_function("window:roi_align"):
                return saved["roi_align"](feats, strides, boxes, valid,
                                          batch_idx, **kw)
        return _ROIAlignTraced.apply(saved["roi_align"], strides, boxes,
                                     valid, batch_idx, kw, *feats)

    rcnn.multilevel_roi_align = roi_align
    rcnn.ROIBoxHead.forward = _window("box_head", head)
    TrainState.apply_updates = _window("optimizer", update)

    def restore():
        rcnn.rpn_losses = saved["rpn_losses"]
        rcnn.rpn_proposals = saved["rpn_proposals"]
        rcnn.batched_multiclass_nms = saved["rpn_nms"]
        rcnn.sample_rois = saved["roi_sampling"]
        rcnn.multilevel_roi_align = saved["roi_align"]
        rcnn.ROIBoxHead.forward = head
        TrainState.apply_updates = update
    return restore


def _traced_windows():
    """Name the Meta-FCOS step's parts in the trace; returns a restore
    function."""
    saved = (train_steps._apply_device_aug, train_steps._assign,
             TrainState.apply_updates)
    train_steps._apply_device_aug = _window("randaugment", saved[0])
    train_steps._assign = _window("assign", saved[1])
    TrainState.apply_updates = _window("optimizer", saved[2])

    def restore():
        (train_steps._apply_device_aug, train_steps._assign,
         TrainState.apply_updates) = saved
    return restore


def _setup(args, work: str):
    """The runner, config and model of the run, its data written and
    registered under ``work``; -> (runner, cfg, model, loader factory,
    window names, restore-installing function)."""
    if args.runner == "MetaFCOSRunner":
        root = os.path.join(work, "coco")
        make_synthetic_coco(root, **DATA)
        register_all_coco(root)
        runner, cfg = MetaFCOSRunner(), train_cfg("episodic", 1)
        return (runner, cfg, runner._episodic_loader, WINDOWS,
                _traced_windows)
    if args.runner != "MetaFasterRCNNRunner":
        raise ValueError(f"--runner {args.runner}: MetaFCOSRunner or "
                         "MetaFasterRCNNRunner")
    lvis, images = os.path.join(work, "lvis"), os.path.join(work, "images")
    make_synthetic_lvis(lvis, images, **RCNN_DATA)
    register_all_lvis(lvis, images)
    runner, cfg = MetaFasterRCNNRunner(), rcnn_train_cfg(args.mode, 1)
    loader = (runner._episodic_loader if args.mode == "episodic"
              else runner._pretrain_loader)
    return runner, cfg, loader, RCNN_WINDOWS, _traced_rcnn_windows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runner", default="MetaFCOSRunner")
    parser.add_argument("--mode", default="episodic",
                        choices=("episodic", "pretrain"))
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--out", default="profile_train.txt")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    work = tempfile.mkdtemp(prefix="sylph_profile_train_")
    try:
        runner, cfg, loader, window_names, install = _setup(args, work)
        model = runner.build_model(cfg, init="train")
        _, state = runner.do_train(cfg, model)  # warm-up step
        cfg.SOLVER.MAX_ITER = 1 + args.steps
        restore = install()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runner._train_loop(cfg, state,
                                   runner.make_train_step(cfg, model),
                                   loader(cfg), lambda it: 0.0, None)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
        finally:
            restore()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels, windows = [], {}
    for e in prof.events():
        if e.name.startswith("window:"):
            if e.device_type != DeviceType.CUDA:
                windows.setdefault(e.name[7:], []).append(e)
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.elapsed_us(),
                            e.name))
    busy_ms = sum(us for _, us, _ in kernels) / 1e3

    print(f"[profile] card: {card}")
    mode = "episodic" if args.runner == "MetaFCOSRunner" else args.mode
    print(f"[profile] {args.runner} {mode}: batch "
          f"{cfg.SOLVER.IMS_PER_BATCH}, GRAD_ACCUM {cfg.TPU.GRAD_ACCUM}")
    for i, (data_s, step_s) in enumerate(runner.loop_times):
        print(f"[profile] traced step {i}: data wait {data_s * 1e3:.1f} ms, "
              f"step wait {step_s * 1e3:.1f} ms")
    for name in window_names:
        spans = windows.get(name, [])
        host = sum(e.time_range.elapsed_us() for e in spans) / 1e3
        dev = sum(e.device_time_total for e in spans) / 1e3
        print(f"[profile] window {name}: {len(spans)} calls, host "
              f"{host:.1f} ms, device {dev:.1f} ms (kernels launched inside)")
    print(f"[profile] traced {args.steps} steps: {traced_ms:.1f} ms wall, "
          f"device busy {busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / traced_ms):.1f}%")
    per_kernel = {}
    for _, us, name in kernels:
        tot, n = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (tot + us / 1e3, n + 1)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:15]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6d} {name[:90]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n")
        for name, (ms, n) in ranked:
            f.write(f"{ms:10.4f} ms  x{n:<6d} {name}\n")


if __name__ == "__main__":
    main()
