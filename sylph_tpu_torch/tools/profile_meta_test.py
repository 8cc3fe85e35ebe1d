"""Where a two-phase meta-test's time goes on the card.

    python3 -m sylph_tpu_torch.tools.profile_meta_test [--out FILE]
    python3 -m sylph_tpu_torch.tools.profile_meta_test \
        --runner MetaFasterRCNNRunner [--config-file CFG] [--out FILE]
    python3 -m sylph_tpu_torch.tools.profile_meta_test \
        --runner MetaFCOSROIEncoderRunner|TFAFewShotDetectionRunner

With the default ``--runner MetaFCOSRunner``: chip_smoke.py's meta-test
setting, the Meta-FCOS finetune config (R-50, bf16, 1024x1344 eval canvas,
384x384 support canvas, 10 shots, EVAL_BATCH 8, CLASS_BATCH 8, random
weights from a fixed seed, INFERENCE_TH_TEST 0.02) on a synthetic COCO tree
(48 train and 20 + 2 empty val images of 480x640), ``MetaFCOSRunner.do_test``
on coco_meta_val_novel and coco_meta_val_all (all-GT base codes on), one
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

``--runner MetaFCOSROIEncoderRunner`` runs the same setting on the COCO
ROIEncoder finetune config (no normalization phase: its codes are final);
``--runner TFAFewShotDetectionRunner`` the plain evaluation of the COCO TFA
finetune config on coco_meta_val_all (no phases, no base codes).

With ``--runner MetaFasterRCNNRunner``: chip_smoke.py's two-stage setting
(``rcnn_meta_test_cfg``: Meta-RCNN-FPN-finetune.yaml, or ``--config-file``,
at full width, bf16, on lvis_meta_val_novelr of a synthetic LVIS tree of
48 train and 24 val images of 480x640), a warm-up ``do_test`` and a traced
one, and for the query set the device and host time of each stage: backbone
+ FPN, RPN head, proposals (decode, top-k), RPN NMS, ROIAlign, box head, the
rest of the ROI stage (softmax, decode, the candidate grid), ROI NMS; the
idle share; the top kernels; the peak memory of the traced run and of one
image's ROIAlign. The stages come from a second traced run with the card
synchronized at each stage's ends, so that a stage's device time is that
of the kernels starting inside it (the NMS kernels launch through ctypes,
which the profiler's launch correlation does not see); the idle share and
the top kernels come from the first, unsynchronized one.

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

from ..data.catalog import register_all_coco
from ..data.synthetic import make_synthetic_coco
from ..evaluation import meta_eval
from ..runner import (MetaFCOSROIEncoderRunner, MetaFCOSRunner,
                      TFAFewShotDetectionRunner)

CONFIG = "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml"
# the one-stage runners and their shipped configs
ONE_STAGE = {
    "MetaFCOSRunner": (MetaFCOSRunner, CONFIG),
    "MetaFCOSROIEncoderRunner": (
        MetaFCOSROIEncoderRunner,
        "sylph://COCO-Detection/Meta-FCOS-ROIEncoder/Meta-FCOS-finetune.yaml"),
    "TFAFewShotDetectionRunner": (
        TFAFewShotDetectionRunner,
        "sylph://COCO-Detection/TFA/tfa-finetune.yaml"),
}
# the synthetic COCO tree of the meta-test setting
DATA = dict(n_train=48, n_val=20, img_hw=(480, 640), n_empty_val=2)
PHASES = ("generate_class_codes", "generate_base_class_codes",
          "normalize_class_codes", "run_query_inference")


# the two-stage setting: a synthetic LVIS tree (2 frequent + 2 rare classes)
# whose images live in a COCO-style image root of their own
RCNN_CONFIG = "sylph://LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-finetune.yaml"
RCNN_DATA = dict(n_train=48, n_val=24, img_hw=(480, 640))


def rcnn_meta_test_cfg(out_dir: str, config: str = RCNN_CONFIG):
    """The two-stage meta-test at full width: ``config`` (R-50, FPN P2-P6,
    RPN top-k 1000/1000, 2xFC-1024, codes of 1024, SCORE_THRESH_TEST 1e-4,
    300 detections), bf16, the 1024x1344 eval canvas, EVAL_BATCH 8,
    CLASS_BATCH 8, EVAL_SHOT 10 at 384x384, REPEAT_TEST cut from 5 to 1,
    on lvis_meta_val_novelr."""
    from ..meta_faster_rcnn_runner import MetaFasterRCNNRunner
    cfg = MetaFasterRCNNRunner.get_default_cfg()
    cfg.merge_from_file(config)
    cfg.TPU.EVAL_BATCH = 8
    cfg.TPU.CLASS_BATCH = 8
    cfg.TEST.REPEAT_TEST = 1
    cfg.DATASETS.TEST = ["lvis_meta_val_novelr"]
    cfg.OUTPUT_DIR = out_dir
    return cfg


def meta_test_cfg(out_dir: str, runner: str = "MetaFCOSRunner"):
    """The one-stage meta-test at full width for ``runner``'s shipped config:
    EVAL_BATCH 8, CLASS_BATCH 8, REPEAT_TEST 1, all-GT base codes, on
    coco_meta_val_novel and coco_meta_val_all (the TFA config: its plain
    evaluation on coco_meta_val_all)."""
    cls, config = ONE_STAGE[runner]
    cfg = cls.get_default_cfg()
    cfg.merge_from_file(config)
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.02  # random weights: scores < 0.04
    cfg.TPU.EVAL_BATCH = 8
    cfg.TPU.CLASS_BATCH = 8
    cfg.TEST.REPEAT_TEST = 1
    cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES = True
    cfg.DATASETS.TEST = (["coco_meta_val_novel", "coco_meta_val_all"]
                         if cfg.MODEL.META_LEARN.EPISODIC_LEARNING
                         else ["coco_meta_val_all"])
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


def _stage_ranges(model):
    """Wrap the two-stage model's stages in named ranges with the card
    synchronized on both sides of each, so that every kernel a stage
    launched starts inside its range; returns a function that undoes it."""
    from ..models import rcnn

    def ranged(name, fn):
        def traced(*args, **kwargs):
            torch.cuda.synchronize()
            with torch.profiler.record_function(f"stage:{name}"):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return traced

    module_fns = {"rpn_proposals": "proposals",
                  "batched_multiclass_nms": "nms",
                  "multilevel_roi_align": "roi_align"}
    saved = {n: getattr(rcnn, n) for n in module_fns}
    for n, stage in module_fns.items():
        setattr(rcnn, n, ranged(stage, saved[n]))
    model.extract_features = ranged("backbone_fpn", model.extract_features)
    model.roi_candidates = ranged("roi_stage", model.roi_candidates)
    model.rpn_head.forward = ranged("rpn_head", model.rpn_head.forward)
    model.box_head.forward = ranged("box_head", model.box_head.forward)

    def undo():
        for n, fn in saved.items():
            setattr(rcnn, n, fn)
        for obj, attr in ((model, "extract_features"),
                          (model, "roi_candidates"),
                          (model.rpn_head, "forward"),
                          (model.box_head, "forward")):
            delattr(obj, attr)

    return undo


def _traced_do_test(runner, cfg, model, stages: bool):
    """One ``do_test`` under ``torch.profiler``, with the phase ranges and,
    with ``stages``, the synchronized stage ranges: (profiler, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    originals = _traced_phases()
    undo = _stage_ranges(model) if stages else (lambda: None)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.do_test(cfg, model)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
        for name, fn in originals.items():
            setattr(meta_eval, name, fn)
    return prof, wall_ms


def _split_events(prof):
    """-> (kernels as (start us, us, name), {range name: [(start, end)]}).
    A range's GPU-side copy (an annotation spanning its kernels) is not
    device work; its host side gives the window."""
    from torch.autograd import DeviceType

    kernels, ranges = [], {}
    for e in prof.events():
        if e.name.startswith(("phase:", "stage:")):
            if e.device_type != DeviceType.CUDA:  # the host range
                ranges.setdefault(e.name, []).append(
                    (e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.elapsed_us(),
                            e.name))
    return kernels, ranges


def profile_rcnn(args, card: str) -> None:
    """The two-stage meta-test's stages on the card."""
    from ..data.catalog import register_all_lvis
    from ..data.synthetic import make_synthetic_lvis
    from ..meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                           eval_anchor_grid)
    from ..models import rcnn

    work = tempfile.mkdtemp(prefix="sylph_profile_rcnn_")
    try:
        lvis = os.path.join(work, "lvis")
        images = os.path.join(work, "images")
        make_synthetic_lvis(lvis, images, **RCNN_DATA)
        register_all_lvis(lvis, images)
        cfg = rcnn_meta_test_cfg(os.path.join(work, "out"),
                                 args.config_file or RCNN_CONFIG)
        runner = MetaFasterRCNNRunner()
        model = runner.build_model(cfg)
        runner.do_test(cfg, model)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof, traced_ms = _traced_do_test(runner, cfg, model, stages=False)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = {name: dict(d.stats) for name, d in runner.drivers.items()}
        staged, staged_ms = _traced_do_test(runner, cfg, model, stages=True)

        # one image's ROIAlign, alone: its time and the memory it adds
        grid = eval_anchor_grid(cfg)
        img = torch.zeros((1, *cfg.TPU.EVAL_CANVAS, 3), device="cuda")
        size = torch.as_tensor([cfg.TPU.EVAL_CANVAS], device="cuda")
        with torch.inference_mode():
            feats, logits, deltas = model.forward_rpn(img)
            props, _, valid = rcnn.rpn_proposals(
                logits, deltas, torch.as_tensor(grid.anchors, device="cuda"),
                grid.level_splits, size)
            batch_idx = torch.zeros(props.shape[1], dtype=torch.long,
                                    device="cuda")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rcnn.multilevel_roi_align(feats[:4], model.ROI_STRIDES, props[0],
                                      valid[0], batch_idx, output_size=7)
            end.record()
            end.synchronize()
            roi_ms = start.elapsed_time(end)
            roi_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels, ranges = _split_events(prof)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    s_kernels, s_ranges = _split_events(staged)
    query = s_ranges.get("phase:run_query_inference", [])

    def inside(span, spans):
        return any(a <= span[0] and span[1] <= b for a, b in spans)

    def total(spans):
        """(device ms of the kernels starting in spans, host ms)."""
        dev = sum(us for t, us, _ in s_kernels
                  if any(a <= t <= b for a, b in spans))
        return dev / 1e3, sum(b - a for a, b in spans) / 1e3

    q = {n[6:]: [sp for sp in spans if inside(sp, query)]
         for n, spans in s_ranges.items() if n.startswith("stage:")}
    props_spans = q.get("proposals", [])
    rpn_nms = [sp for sp in q.get("nms", []) if inside(sp, props_spans)]
    roi_nms = [sp for sp in q.get("nms", []) if not inside(sp, props_spans)]
    prop, rnms = total(props_spans), total(rpn_nms)
    roi, align, head = (total(q.get(n, [])) for n in ("roi_stage",
                                                      "roi_align",
                                                      "box_head"))
    rows = [("backbone + FPN", total(q.get("backbone_fpn", []))),
            ("RPN head", total(q.get("rpn_head", []))),
            ("proposals (top-k, decode)",
             (prop[0] - rnms[0], prop[1] - rnms[1])),
            ("RPN NMS", rnms), ("ROIAlign", align), ("box head", head),
            ("ROI softmax, decode, grid",
             (roi[0] - align[0] - head[0], roi[1] - align[1] - head[1])),
            ("ROI NMS", total(roi_nms))]

    print(f"[profile] card: {card}")
    for name, st in stats.items():
        print(f"[profile] {name}: " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in st.items()
            if k.endswith("_s")))
    print(f"[profile] traced do_test: {traced_ms:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / traced_ms):.1f}%; peak memory "
          f"{peak_gb:.2f} GB")
    dev_q = sum(r[1][0] for r in rows)
    print(f"[profile] query set by stage, the card synchronized at each "
          f"stage's ends (do_test {staged_ms:.1f} ms): device ms (share of "
          f"the stages' device time) / host ms")
    for name, (dev, host) in rows:
        print(f"[profile]   {name:28s} {dev:9.2f} ms "
              f"({100 * dev / max(dev_q, 1e-9):5.1f}%) / {host:9.2f} ms")
    print(f"[profile] one image's ROIAlign ({props.shape[1]} proposals, "
          f"P2-P5): {roi_ms:.2f} ms, +{roi_gb:.2f} GB peak")
    _report_kernels([(us, name) for _, us, name in kernels], card, args.out)


def _report_kernels(kernels, card: str, out: str) -> None:
    per_kernel = {}
    for us, name in kernels:
        tot, n = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (tot + us / 1e3, n + 1)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:12]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    for name, (ms, n) in ranked:  # the NMS kernels, wherever they rank
        if "namespace)::" in name and any(
                k in name for k in ("rank_kernel", "scan_kernel", "radix_")):
            print(f"[profile]   NMS {ms:8.4f} ms  x{n:<5d} {name[:90]}")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(f"{card}\n")
        for name, (ms, n) in ranked:
            f.write(f"{ms:10.4f} ms  x{n:<6d} {name}\n")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="profile_meta_test.txt")
    parser.add_argument("--runner", default="MetaFCOSRunner",
                        choices=(*ONE_STAGE, "MetaFasterRCNNRunner"))
    parser.add_argument("--config-file", default="",
                        help="the two-stage config (default "
                             "Meta-RCNN-FPN-finetune.yaml)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_meta_test needs an NVIDIA card")
    os.environ.pop("SYLPH_TEST_MODE", None)  # it would cut the query set
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.runner == "MetaFasterRCNNRunner":
        profile_rcnn(args, card)
        return

    work = tempfile.mkdtemp(prefix="sylph_profile_meta_")
    try:
        root = os.path.join(work, "coco")
        make_synthetic_coco(root, **DATA)
        register_all_coco(root)
        cfg = meta_test_cfg(os.path.join(work, "out"), args.runner)
        runner = ONE_STAGE[args.runner][0]()
        model = runner.build_model(cfg)
        runner.do_test(cfg, model)  # warm-up
        torch.cuda.synchronize()
        prof, traced_ms = _traced_do_test(runner, cfg, model, stages=False)
        stats = {name: dict(d.stats) for name, d in runner.drivers.items()}
        base_turns = (_base_codegen_turns(runner.drivers["coco_meta_val_all"])
                      if runner.drivers else [])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels, ranges = _split_events(prof)
    windows = {n[6:]: spans for n, spans in ranges.items()}
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
    print(f"[profile] traced do_test ({', '.join(cfg.DATASETS.TEST)}): "
          f"{traced_ms:.1f} ms "
          f"wall, device busy {busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / traced_ms):.1f}%")
    for mode, gen_s, wait_s in base_turns:
        print(f"[profile] base codes, chunk loader {mode}: code generation "
              f"{gen_s * 1e3:.1f} ms, loader wait {wait_s * 1e3:.1f} ms")
    _report_kernels([(us, name) for _, us, name in kernels], card, args.out)


if __name__ == "__main__":
    main()
