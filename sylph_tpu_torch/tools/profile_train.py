"""Where an episodic meta-training step's time goes on the card.

    python3 -m sylph_tpu_torch.tools.profile_train [--steps 2] [--out FILE]

Runs chip_smoke.py's full-width meta-training setting (``train_cfg``): the
Meta-FCOS finetune config as ``auto_scale_world_size`` leaves it on one card
(R-50, FPN 256, 4-conv towers, bf16, 48 episodes x 5 shots at 384x384 and
one 1024x1024 query each, TPU.GRAD_ACCUM 16, clip 1.0, device RandAugment,
backbone and bbox branch frozen) from the flax initializers' distributions
on a synthetic COCO tree (48 train images of 480x640). One warm-up step,
then ``--steps`` steps traced with ``torch.profiler``. Reports:

  * each traced step's data wait and step wait on the host clock;
  * the device time of the kernels that start inside the named windows
    (device RandAugment, target assignment, the optimizer update; the rest
    of a step is the forward and backward passes), and the device's busy
    and idle share over the traced steps;
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
from ..data.catalog import register_all_coco
from ..data.synthetic import make_synthetic_coco
from ..runner import MetaFCOSRunner
from ..train import steps as train_steps
from ..train.train_state import TrainState
from .profile_meta_test import DATA
from .train_net import auto_scale_world_size

CONFIGS = {
    "episodic": "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml",
    "pretrain": "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-pretrain.yaml",
}
WINDOWS = ("randaugment", "assign", "optimizer")


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


def _traced_windows():
    """Name the step's parts in the trace; returns a restore function."""
    saved = (train_steps._apply_device_aug, train_steps._assign,
             TrainState.apply_updates)

    def wrap(name, fn):
        def traced(*args, **kwargs):
            with torch.profiler.record_function(f"window:{name}"):
                return fn(*args, **kwargs)
        return traced

    train_steps._apply_device_aug = wrap("randaugment", saved[0])
    train_steps._assign = wrap("assign", saved[1])
    TrainState.apply_updates = wrap("optimizer", saved[2])

    def restore():
        (train_steps._apply_device_aug, train_steps._assign,
         TrainState.apply_updates) = saved
    return restore


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
        root = os.path.join(work, "coco")
        make_synthetic_coco(root, **DATA)
        register_all_coco(root)
        runner = MetaFCOSRunner()
        cfg = train_cfg("episodic", 1)
        model = runner.build_model(cfg, init="train")
        _, state = runner.do_train(cfg, model)  # warm-up step
        cfg.SOLVER.MAX_ITER = 1 + args.steps
        restore = _traced_windows()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runner._train_loop(cfg, state,
                                   runner.make_train_step(cfg, model),
                                   runner._episodic_loader(cfg),
                                   lambda it: 0.0, None)
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
                windows.setdefault(e.name[7:], []).append(
                    (e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.elapsed_us(),
                            e.name))
    busy_ms = sum(us for _, us, _ in kernels) / 1e3

    print(f"[profile] card: {card}")
    for i, (data_s, step_s) in enumerate(runner.loop_times):
        print(f"[profile] traced step {i}: data wait {data_s * 1e3:.1f} ms, "
              f"step wait {step_s * 1e3:.1f} ms")
    in_windows = 0.0
    for name in WINDOWS:
        spans = windows.get(name, [])
        host = sum(b - a for a, b in spans) / 1e3
        dev = sum(us for t, us, _ in kernels
                  if any(a <= t <= b for a, b in spans)) / 1e3
        in_windows += dev
        print(f"[profile] window {name}: {len(spans)} calls, host "
              f"{host:.1f} ms, device busy {dev:.1f} ms")
    print(f"[profile] forward + backward (device, outside the windows): "
          f"{busy_ms - in_windows:.1f} ms")
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
