"""Where a two-phase meta-test's time goes on the card.

    python3 -m sylph_tpu_torch.tools.profile_meta_test [--out FILE]

Runs chip_smoke.py's meta-test setting: the Meta-FCOS finetune config (R-50,
bf16, 1024x1344 eval canvas, 384x384 support canvas, 10 shots,
EVAL_BATCH 8, CLASS_BATCH 8, random weights from a fixed seed,
INFERENCE_TH_TEST 0.02) on a synthetic COCO tree (48 train and 20 + 2
empty val images of 480x640), ``MetaFCOSRunner.do_test`` on
coco_meta_val_novel and coco_meta_val_all (all-GT base codes on), one
warm-up run and then one traced with ``torch.profiler``. Reports:

  * each dataset's phase times on the host clock (the driver's ``stats``:
    loader waits, code generation, query inference, evaluator);
  * for each phase window (support codes, base codes, normalization,
    query set) the device time of the kernels that started inside it, and
    the device's idle share over the whole run;
  * the kernels that take the most device time;
  * base-code generation on coco_meta_val_all with its chunk loader
    streaming (as ``do_test`` runs it) and with every chunk loaded before
    the first model call, in turns (streamed, loaded, loaded, streamed),
    untraced: whether the loader's thread slows the launching thread.

Prints the card's ``name, power.limit`` beside the numbers; the full
per-kernel table goes to ``--out`` (default profile_meta_test.txt). Needs a
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
from ..evaluation import meta_eval
from ..runner import MetaFCOSRunner

CONFIG = "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml"
# the synthetic COCO tree of the meta-test setting
DATA = dict(n_train=48, n_val=20, img_hw=(480, 640), n_empty_val=2)
PHASES = ("generate_class_codes", "generate_base_class_codes",
          "normalize_class_codes", "run_query_inference")


def meta_test_cfg(out_dir: str):
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.02  # random weights: scores < 0.04
    cfg.TPU.EVAL_BATCH = 8
    cfg.TPU.CLASS_BATCH = 8
    cfg.TEST.REPEAT_TEST = 1
    cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES = True
    cfg.DATASETS.TEST = ["coco_meta_val_novel", "coco_meta_val_all"]
    cfg.OUTPUT_DIR = out_dir
    return cfg


def _traced_phases():
    """Wrap the driver's phase functions so that each call leaves a named
    range in the trace; returns the originals to restore."""
    originals = {name: getattr(meta_eval, name) for name in PHASES}

    def wrap(name, fn):
        def traced(*args, **kwargs):
            with torch.profiler.record_function(f"phase:{name}"):
                return fn(*args, **kwargs)
        return traced

    for name, fn in originals.items():
        setattr(meta_eval, name, wrap(name, fn))
    return originals


def _base_codegen_turns(driver):
    """(mode, base_codegen_s, base_wait_s) of four untraced runs, the base
    chunk loader streaming or drained before the first model call."""
    streamed = meta_eval.build_support_set_base_loader

    def loaded(*args, **kwargs):
        return iter(list(streamed(*args, **kwargs)))

    turns = []
    try:
        for mode in ("streamed", "loaded", "loaded", "streamed"):
            meta_eval.build_support_set_base_loader = (
                loaded if mode == "loaded" else streamed)
            driver.run_once(0)
            turns.append((mode, driver.stats["base_codegen_s"],
                          driver.stats["base_wait_s"]))
    finally:
        meta_eval.build_support_set_base_loader = streamed
    return turns


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="profile_meta_test.txt")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_meta_test needs an NVIDIA card")
    os.environ.pop("SYLPH_TEST_MODE", None)  # it would cut the query set
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    work = tempfile.mkdtemp(prefix="sylph_profile_meta_")
    try:
        root = os.path.join(work, "coco")
        make_synthetic_coco(root, **DATA)
        register_all_coco(root)
        cfg = meta_test_cfg(os.path.join(work, "out"))
        runner = MetaFCOSRunner()
        model = runner.build_model(cfg)
        runner.do_test(cfg, model)  # warm-up
        torch.cuda.synchronize()

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        originals = _traced_phases()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runner.do_test(cfg, model)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for name, fn in originals.items():
                setattr(meta_eval, name, fn)
        stats = {name: dict(d.stats) for name, d in runner.drivers.items()}
        base_turns = _base_codegen_turns(runner.drivers["coco_meta_val_all"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels, windows = [], {}
    for e in prof.events():
        if e.name.startswith("phase:"):
            # the host range; its GPU-side copy (an annotation spanning the
            # phase's kernels) is not device work
            if e.device_type != DeviceType.CUDA:
                windows.setdefault(e.name[6:], []).append(
                    (e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.elapsed_us(),
                            e.name))
    busy_ms = sum(us for _, us, _ in kernels) / 1e3

    print(f"[profile] card: {card}")
    for name, st in stats.items():
        print(f"[profile] {name}: " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in st.items()
            if k.endswith("_s")))
    for name in PHASES:
        spans = windows.get(name, [])
        host = sum(b - a for a, b in spans) / 1e3
        dev = sum(us for t, us, _ in kernels
                  if any(a <= t <= b for a, b in spans)) / 1e3
        if spans:
            print(f"[profile] phase {name}: {len(spans)} calls, host window "
                  f"{host:.1f} ms, device busy {dev:.1f} ms "
                  f"({100 * dev / max(host, 1e-9):.1f}% of the window)")
    print(f"[profile] traced do_test (both datasets): {traced_ms:.1f} ms "
          f"wall, device busy {busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / traced_ms):.1f}%")
    for mode, gen_s, wait_s in base_turns:
        print(f"[profile] base codes, chunk loader {mode}: code generation "
              f"{gen_s * 1e3:.1f} ms, loader wait {wait_s * 1e3:.1f} ms")
    per_kernel = {}
    for _, us, name in kernels:
        tot, n = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (tot + us / 1e3, n + 1)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:12]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    for name, (ms, n) in ranked:  # the NMS kernels, wherever they rank
        if "rank_kernel" in name or "scan_kernel" in name:
            print(f"[profile]   NMS {ms:8.4f} ms  x{n:<5d} {name[:90]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n")
        for name, (ms, n) in ranked:
            f.write(f"{ms:10.4f} ms  x{n:<6d} {name}\n")


if __name__ == "__main__":
    main()
