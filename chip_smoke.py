#!/usr/bin/env python3
"""Drive sylph_tpu_torch's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: require CUDA, print the card's name and power limit;
  2. build the NMS kernel from sylph_tpu_torch/csrc/nms.cu and its first
     design from csrc/nms_greedy.cu, the yardstick (nvcc, sm_90a, both
     started together);
  3. NMS kernel against its plain PyTorch twin on the card, random and
     tie-laden inputs, B in {1, 8, 48}, K = 5000, M in {100, 300}, then
     inputs aimed at the chunked scan at B = 1 (identical boxes, no
     overlap, dense clusters, score ties across every chunk boundary,
     -0.0/+0.0 ties): indices and flags must be identical, the first
     design's too; prints both kernels' times and the slowest case;
  4. serving at full width: the Meta-FCOS finetune config (R-50, FPN 256,
     4-conv towers, CodeGenerator, 1024x1344 eval canvas, 384x384 support
     canvas, 10 shots, a 1280-row code bank) with random weights from a
     fixed seed. Registers 3 classes and answers 5 requests of different
     sizes, one with INFERENCE_TH_TEST = 0 so NMS runs at the full
     K = 5000, then the same 5 with ``device_preprocess=True`` (the resize
     on the card). The kernels' launch counts are read around this block
     alone; afterwards each request's detections are held against the same
     dense outputs decoded with the twin, each device canvas against the
     same resize on the CPU (1e-3 on the 0-255 scale), and host and device
     preprocessing are timed side by side;
  5. card against CPU: the same predictor in float32 at a 256x256 canvas
     on cuda and on cpu; dense outputs to rtol 1e-3 / atol 5e-3, detections
     to boxes 0.05, scores 1e-3, equal classes;
  6. the two-phase meta-test at full width: the same config in bf16 with
     EVAL_BATCH 8 and CLASS_BATCH 8, on a synthetic COCO tree made by
     ``sylph_tpu_torch.data.synthetic`` (48 train and 20 + 2 empty val
     images of 480x640). ``MetaFCOSRunner.do_test`` runs once to warm up,
     then again with the counts read around it, on coco_meta_val_novel and
     coco_meta_val_all (the latter with all-GT base codes); REPEAT_TEST is
     cut from 5 to 1 for time. Checks: one NMS launch per query batch,
     each batch's detections equal to the same dense outputs decoded with
     the twin (the padded tail batch included), one ``.npz`` per class,
     the directory reloaded through ``SylphPredictor(class_code_path=...)``
     reproducing the normalized bank to 1e-6, and a complete AP dict.

The last lines are the card's ``name, power.limit``, one JSON object
listing every kernel with its launches (in all and by path), error and
times (``earlier_ms``: the first design's time on the serving path's NMS
input; ``meta_test_ms``: the kernel on a B=8 meta-test batch), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sylph_tpu_torch import get_default_cfg
from sylph_tpu_torch.data.catalog import register_all_coco
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.evaluation import meta_eval
from sylph_tpu_torch.ops import nms_kernel
from sylph_tpu_torch.ops.decode import select_candidates
from sylph_tpu_torch.ops.image_ops import resize_shortest_edge_device
from sylph_tpu_torch.ops.nms import (batched_multiclass_nms,
                                     class_offset_boxes,
                                     nms_select_reference)
from sylph_tpu_torch.predictor import SylphPredictor
from sylph_tpu_torch.runner import MetaFCOSRunner
from sylph_tpu_torch.tools.profile_meta_test import DATA as META_TEST_DATA
from sylph_tpu_torch.tools.profile_meta_test import meta_test_cfg

CONFIG = "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml"
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# One IoU test: 2 max, 2 min, 3 sub, 2 clamp, 1 mul, 1 add, 1 max, 1 div,
# 1 compare.
NMS_OPS_PER_IOU_TEST = 14
ADVERSARIAL = ("identical_boxes", "no_overlap", "dense_clusters",
               "chunk_boundary_ties", "signed_zeros")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int, warmup: int = 2, rounds: int = 5,
            graph: bool = False) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls of ``fn`` between two CUDA events. Without ``graph`` the calls
    are issued from the host, so a call that is shorter on the card than
    on the host measures the host. With ``graph`` the ``reps`` calls are
    captured once in a CUDA graph that is replayed between the events:
    the kernels' time on the card, back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            run()
        run = g.replay
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


# ------------------------------------------------------------------- NMS
def nms_inputs(gen: torch.Generator, b: int, k: int, ties: bool):
    """Class-labelled candidate boxes shaped like decode's output."""
    ctr = torch.rand((b, k, 2), generator=gen) * 1300
    wh = 8 + torch.rand((b, k, 2), generator=gen) * 300
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    scores = torch.rand((b, k), generator=gen).sqrt()
    if ties:  # exact ties in pairs and a few shared boxes
        scores[:, 1::2] = scores[:, 0::2]
        boxes[:, 1::4] = boxes[:, 0::4]
    classes = torch.randint(0, 3, (b, k), generator=gen)
    valid = torch.rand((b, k), generator=gen) > 0.1
    if b > 1:
        valid[1] = False  # an all-invalid image
    return [t.cuda() for t in (boxes, scores, classes, valid)]


def adversarial_inputs(gen: torch.Generator, kind: str, k: int = 5000):
    """One image of one class, aimed at the kernel's chunked scan."""
    ctr = torch.rand((1, k, 2), generator=gen) * 1300
    wh = 8 + torch.rand((1, k, 2), generator=gen) * 300
    scores = torch.rand((1, k), generator=gen).sqrt()
    if kind == "identical_boxes":  # one pick, then nothing alive
        ctr[:] = 500.0
        wh[:] = 300.0
    elif kind == "no_overlap":  # disjoint grid cells: picks = first M
        side = int(np.ceil(np.sqrt(k)))
        cell = torch.stack(torch.meshgrid(torch.arange(side),
                                          torch.arange(side), indexing="ij"),
                           -1).reshape(-1, 2)[:k].float()
        ctr = (cell * 10 + 4)[None]
        wh = torch.full((1, k, 2), 8.0)
    elif kind == "dense_clusters":  # most suppressed: every chunk scanned
        centres = torch.rand((24, 2), generator=gen) * 1200
        pick = torch.randint(0, 24, (k,), generator=gen)
        ctr = (centres[pick] + torch.randn((k, 2), generator=gen) * 6)[None]
        wh = 60 + torch.rand((1, k, 2), generator=gen) * 40
    elif kind == "chunk_boundary_ties":  # 6 score values: long tie runs
        scores = torch.randint(1, 7, (1, k), generator=gen).float() / 6
    elif kind == "signed_zeros":
        scores = torch.tensor([-0.0, 0.0, -0.5, 0.5])[
            torch.randint(0, 4, (1, k), generator=gen)]
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    classes = torch.zeros((1, k), dtype=torch.long)
    valid = torch.ones((1, k), dtype=torch.bool)
    return [t.cuda() for t in (boxes, scores, classes, valid)]


def nms_planes(boxes, scores, classes, valid):
    shifted = class_offset_boxes(boxes, classes, valid)
    planes = shifted.permute(2, 0, 1).contiguous()
    return (shifted, planes[0], planes[1], planes[2], planes[3],
            scores.contiguous(), valid.to(torch.int32).contiguous())


def walk_tests(scores, valid, idx, ok) -> int:
    """IoU tests the walk in (score desc, index asc) order needs: each
    candidate it reaches against each kept one ranked before it."""
    tests = 0
    for r in range(scores.shape[0]):
        s = torch.where(valid[r], scores[r] + 0.0, -1e10)
        n = int((s > -5e9).sum())
        order = torch.sort(-s, stable=True).indices[:n]
        rank = torch.full_like(s, -1, dtype=torch.long)
        rank[order] = torch.arange(n, device=order.device)
        kept = rank[idx[r][ok[r]].long()]
        if kept.numel() == 0:  # nothing alive in this image
            continue
        reached = int(kept.max()) + 1 if int(ok[r].sum()) == idx.shape[1] \
            else n
        tests += int((reached - 1 - kept).sum())
    return tests


def nms_bound_ms(scores, valid, idx, ok):
    """Least time for the work this input needs: each input read once,
    each output written once; the IoU tests of the walk, and
    K log2 K compares to order the candidates."""
    (b, k), m = scores.shape, idx.shape[1]
    nbytes = b * k * (4 * 4 + 4 + 4) + b * m * (4 + 4)
    ops = (walk_tests(scores, valid, idx, ok) * NMS_OPS_PER_IOU_TEST
           + b * k * int(np.ceil(np.log2(max(k, 2)))))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_nms_case(inputs, m: int, what: str):
    """Kernel and first design against the twin, then both timed."""
    boxes, scores, classes, valid = inputs
    want = batched_multiclass_nms(boxes, scores, classes, valid, 0.6, m,
                                  impl="reference")
    got = batched_multiclass_nms(boxes, scores, classes, valid, 0.6, m)
    _, *planes = nms_planes(boxes, scores, classes, valid)
    g_idx, g_ok = nms_kernel.nms_cuda_greedy(*planes, 0.6, m)
    torch.cuda.synchronize()
    for name, g, w in zip(("boxes", "scores", "classes", "ok", "idx"), got,
                          want):
        if not torch.equal(g, w):
            raise AssertionError(f"NMS kernel != twin in {name}: {what}")
    if not (torch.equal(g_idx, want[4]) and torch.equal(g_ok.bool(),
                                                        want[3])):
        raise AssertionError(f"first design != twin: {what}")
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, 0.6, m), 20,
                 graph=True)
    greedy_ms = time_ms(lambda: nms_kernel.nms_cuda_greedy(*planes, 0.6, m),
                        20, graph=True)
    log(f"[nms] {what}: identical to the twin; kernel {ms:.4f} ms, first "
        f"design {greedy_ms:.4f} ms, {int(got[3].sum())} picks")
    return err, ms


def phase_nms_against_twin() -> float:
    gen = torch.Generator().manual_seed(1)
    max_err, slowest = 0.0, (0.0, "")
    for b in (1, 8, 48):
        for m in (100, 300):
            for ties in (False, True):
                what = f"B={b:2d} K=5000 M={m} ties={ties!s:5}"
                err, ms = check_nms_case(nms_inputs(gen, b, 5000, ties), m,
                                         what)
                max_err, slowest = max(max_err, err), max(slowest, (ms, what))
    for kind in ADVERSARIAL:
        for m in (100, 300):
            what = f"B= 1 K=5000 M={m} {kind}"
            err, ms = check_nms_case(adversarial_inputs(gen, kind), m, what)
            max_err, slowest = max(max_err, err), max(slowest, (ms, what))
    log(f"[nms] slowest case: {slowest[1]}, kernel {slowest[0]:.4f} ms")
    return max_err


# --------------------------------------------------------------- serving
def random_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)


def register(pred: SylphPredictor, rng, names, shots: int):
    ms = []
    for name in names:
        imgs, boxes = [], []
        for _ in range(shots):
            h, w = rng.randint(240, 640, size=2)
            imgs.append(random_image(rng, h, w))
            x0, y0 = rng.randint(0, w // 3), rng.randint(0, h // 3)
            boxes.append(np.array([x0, y0, rng.randint(x0 + 32, w),
                                   rng.randint(y0 + 32, h)], np.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.register_class(name, imgs, boxes)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def check_detections_equal(a, b, what: str) -> None:
    for field in ("boxes", "scores", "classes", "valid", "locations",
                  "fpn_levels"):
        if not torch.equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"{what}: {field} differs between the "
                                 "kernel and the twin")


def serving_cfg():
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    # Random weights keep the class scores below ~0.04: the candidate
    # threshold drops from 0.05 to 0.02 so that requests return detections.
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.02
    return cfg


def phase_serving(device: str = "cuda"):
    cfg = serving_cfg()
    pred = SylphPredictor(cfg=cfg, device=device)
    rng = np.random.RandomState(0)
    shots = cfg.MODEL.META_LEARN.EVAL_SHOT
    sizes = [(480, 640), (800, 1216), (720, 1280), (1024, 768), (600, 900)]
    images = [random_image(rng, h, w) for h, w in sizes]
    th = pred.decode_cfg.pre_nms_thresh
    # the last request runs with INFERENCE_TH_TEST = 0: NMS at full K
    requests = [(img, i == len(images) - 1, dev_pre)
                for dev_pre in (False, True) for i, img in enumerate(images)]

    def set_thresh(full_k):
        pred.decode_cfg = pred.decode_cfg._replace(
            pre_nms_thresh=0.0 if full_k else th)

    # ---- the main path: counts are read around this block alone
    nms_kernel.LAUNCHES = 0
    reg_ms = register(pred, rng, ["class_a", "class_b", "class_c"], shots)
    results, lat_ms = [], []
    for img, full_k, dev_pre in requests:
        set_thresh(full_k)
        t0 = time.perf_counter()
        results.append(pred(img, device_preprocess=dev_pre))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nms_kernel.LAUNCHES
    # ---- end of the main path

    log(f"[serve] registration ms per class ({shots} shots at "
        f"{tuple(cfg.TPU.SUPPORT_CANVAS)}): "
        + ", ".join(f"{t:.1f}" for t in reg_ms))
    for (img, full_k, dev_pre), t, res in zip(requests, lat_ms, results):
        n = len(res["scores"])
        if not (np.isfinite(res["boxes"]).all()
                and np.isfinite(res["scores"]).all()):
            raise AssertionError("non-finite detections")
        if res["boxes"].shape != (n, 4) or not set(res["class_names"]) <= {
                "class_a", "class_b", "class_c"}:
            raise AssertionError("malformed detections")
        if full_k and n != pred.decode_cfg.post_nms_topk:
            raise AssertionError("the INFERENCE_TH_TEST=0 request should "
                                 "fill every NMS slot")
        h, w = img.shape[:2]
        log(f"[serve] request {h}x{w} "
            f"({'device' if dev_pre else 'host'} preprocessing): "
            f"{t:.1f} ms, {n} detections")
    log(f"[serve] NMS launches on the main path: {launches}")

    # ---- comparisons (their launches do not count)
    timing = None
    for i, (img, full_k, dev_pre) in enumerate(requests):
        set_thresh(full_k)
        prep = pred.prepare_device if dev_pre else pred.prepare
        canvas, size, _ = prep(img)
        out = pred.dense(canvas)
        got = pred.decode(out, size, pred.bank.valid)
        want = pred.decode(out, size, pred.bank.valid, nms_impl="reference")
        check_detections_equal(got, want, f"request {i}")
        if full_k and not dev_pre:
            with torch.inference_mode():
                cand = select_candidates(
                    out.logits, out.reg, out.ctrness, out.iou,
                    pred.locations, pred.strides, pred.decode_cfg,
                    pred.level_splits, pred.bank.valid)
            # level l yields min(1000, K_l x bank rows) candidates, of
            # which min(1000, K_l x registered classes) are valid
            topk = pred.decode_cfg.pre_nms_topk
            want_k = sum(min(topk, c * pred.bank.capacity)
                         for c in pred.level_splits)
            live = sum(min(topk, c * pred.bank.num_classes)
                       for c in pred.level_splits)
            k = cand.valid.shape[1]
            if k != want_k or int(cand.valid.sum()) != live:
                raise AssertionError(f"expected {live} valid of {want_k} "
                                     f"candidates, got "
                                     f"{int(cand.valid.sum())} of {k}")
            log(f"[serve] INFERENCE_TH_TEST=0 request: NMS over K={k} "
                f"candidates, {live} of them valid")
            timing = time_nms_on(cand, pred.decode_cfg)
    log("[serve] every request's detections equal the twin-decoded ones")
    check_device_preprocess(pred, images)
    return launches, timing


def check_device_preprocess(pred: SylphPredictor, images) -> None:
    """Each canvas ``prepare_device`` makes on the card against the same
    resize on the CPU, then host ``prepare`` and ``prepare_device`` timed
    on the same frames."""
    cfg = pred.cfg
    for img in images:
        oh, ow = img.shape[:2]
        got, _, (_, _, rh, rw) = pred.prepare_device(img)
        want, want_hw = resize_shortest_edge_device(
            torch.as_tensor(np.ascontiguousarray(img[:, :, ::-1])), (oh, ow),
            out_hw=pred.eval_canvas, short=cfg.INPUT.MIN_SIZE_TEST,
            max_size=cfg.INPUT.MAX_SIZE_TEST)
        err = float((got[0].cpu() - want).abs().max())
        if [rh, rw] != want_hw.tolist() or err > 1e-3:
            raise AssertionError(f"device resize of {oh}x{ow}: content "
                                 f"{[rh, rw]} vs {want_hw.tolist()}, max "
                                 f"error {err}")
        host_ms = time_host(lambda: pred.prepare(img))
        dev_ms = time_host(lambda: pred.prepare_device(img))
        log(f"[preprocess] {oh}x{ow} -> {[rh, rw]}: canvas on cuda = cpu "
            f"within {err:.2e}; host prepare {host_ms:.2f} ms, device "
            f"prepare {dev_ms:.2f} ms (median of 7)")


def time_host(fn, reps: int = 7) -> float:
    """Median wall time of ``fn`` in ms, the card synchronized around each
    call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_nms_on(cand, dcfg):
    """Kernel, first-design and twin times on the main path's own NMS
    input; the two designs at M = 300 too."""
    m, thr = dcfg.post_nms_topk, dcfg.nms_thresh
    shifted, *planes = nms_planes(cand.boxes, cand.scores, cand.classes,
                                  cand.valid)
    b, k = cand.scores.shape
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, thr, m), 50,
                 graph=True)
    call_ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, thr, m), 50)
    earlier_ms = time_ms(lambda: nms_kernel.nms_cuda_greedy(*planes, thr, m),
                         50, graph=True)
    plain_ms = time_ms(lambda: nms_select_reference(
        shifted, cand.scores, cand.valid, thr, m), 5, warmup=1)
    idx, ok = nms_kernel.nms_cuda(*planes, thr, m)
    bound_ms, bound_by = nms_bound_ms(cand.scores, cand.valid, idx,
                                      ok.bool())
    log(f"[nms] main-path input B={b} K={k} M={m}: kernel {ms:.4f} ms "
        f"({call_ms:.4f} ms a call issued from the host), first design "
        f"{earlier_ms:.4f} ms, twin {plain_ms:.3f} ms, bound {bound_ms:.6f} "
        f"ms ({bound_by})")
    ms300 = time_ms(lambda: nms_kernel.nms_cuda(*planes, thr, 300), 50,
                    graph=True)
    earlier300 = time_ms(lambda: nms_kernel.nms_cuda_greedy(*planes, thr,
                                                            300), 50,
                         graph=True)
    log(f"[nms] main-path input at M=300: kernel {ms300:.4f} ms, first "
        f"design {earlier300:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, earlier_ms=earlier_ms)


# ----------------------------------------------------------- card vs CPU
def time_nms_meta(args, kwargs):
    """The kernel's CUDA-graph time and bound on one meta-test query batch,
    from the arguments its ``decode_proposals`` call was given."""
    logits, reg, ctr, iou, locs, strides, _, dcfg, splits = args
    with torch.inference_mode():
        cand = select_candidates(logits, reg, ctr, iou, locs, strides, dcfg,
                                 splits, kwargs.get("class_valid"))
    m, thr = dcfg.post_nms_topk, dcfg.nms_thresh
    _, *planes = nms_planes(cand.boxes, cand.scores, cand.classes,
                            cand.valid)
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, thr, m), 50,
                 graph=True)
    idx, ok = nms_kernel.nms_cuda(*planes, thr, m)
    bound_ms, bound_by = nms_bound_ms(cand.scores, cand.valid, idx,
                                      ok.bool())
    b, k = cand.scores.shape
    log(f"[nms] meta-test input B={b} K={k} M={m} "
        f"({int(cand.valid.sum())} valid): kernel {ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return ms, bound_ms, bound_by


# ------------------------------------------------------------- meta-test
def check_ap_dict(name: str, bbox: dict, class_names) -> None:
    want = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1", "AR@10",
            "AR@100"] + [f"AP-{c}" for c in class_names]
    if name.endswith("_all"):
        want += ["nAP", "bAP"]
    want += [f"{k}_std" for k in want]
    missing = [k for k in want if not isinstance(bbox.get(k), float)]
    if missing:
        raise AssertionError(f"{name}: AP dict lacks {missing}")


def phase_meta_test(work: str):
    """The two-phase meta-test at full width; returns its NMS launches and
    the kernel's time on one of its B=8 batches."""
    root = os.path.join(work, "coco")
    make_synthetic_coco(root, **META_TEST_DATA)
    register_all_coco(root)
    cfg = meta_test_cfg(os.path.join(work, "out"))
    runner = MetaFCOSRunner()
    model = runner.build_model(cfg)
    t0 = time.perf_counter()
    runner.do_test(cfg, model)  # warm-up: cuDNN plans, the g++ matcher
    log(f"[meta-test] warm-up do_test: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(cfg.OUTPUT_DIR)

    recorded = []
    decode = meta_eval.decode_proposals

    def recording(*args, **kwargs):
        det = decode(*args, **kwargs)
        recorded.append((args, kwargs, det))
        return det

    meta_eval.decode_proposals = recording
    try:
        # ---- the main path: counts are read around this block alone
        nms_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        results = runner.do_test(cfg, model)
        wall = time.perf_counter() - t0
        launches = nms_kernel.LAUNCHES
        # ---- end of the main path
    finally:
        meta_eval.decode_proposals = decode

    batches = 0
    for name, res in results.items():
        driver = runner.drivers[name]
        st = driver.stats
        meta = driver.dataset_dict["metadata"]
        n_query = len(driver.dataset_dict[-1])
        batches += -(-n_query // cfg.TPU.EVAL_BATCH)
        check_ap_dict(name, res["bbox"], meta["thing_classes"])
        supported = [meta["thing_classes"][c] for c in driver.dataset_dict
                     if isinstance(c, int) and c >= 0]
        code_dir = os.path.join(cfg.OUTPUT_DIR, "class_codes", name)
        files = sorted(os.listdir(code_dir))
        if files != sorted(f"{c}.npz" for c in supported):
            raise AssertionError(f"{name}: class code files {files}")
        log(f"[meta-test] {name}: {int(st['classes'])} classes, "
            f"{int(st['query_images'])} query images in "
            f"{int(st['query_batches'])} batches of {cfg.TPU.EVAL_BATCH}; "
            f"AP {res['bbox']['AP']:.4f}, AP50 {res['bbox']['AP50']:.4f}")
        log(f"[meta-test] {name} times (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in st.items()
            if k.endswith("_s")))
        log(f"[meta-test] {name}: code generation "
            f"{st['codegen_s'] / st['classes'] * 1e3:.2f} ms per class "
            f"({cfg.TPU.CLASS_BATCH} classes per call), query "
            f"{st['query_images'] / st['query_s']:.2f} img/s at B="
            f"{cfg.TPU.EVAL_BATCH}")
    log(f"[meta-test] do_test on both datasets: {wall:.2f} s on the host "
        f"clock; NMS launches {launches}")
    if launches != batches or len(recorded) != batches:
        raise AssertionError(f"expected {batches} NMS launches (one per "
                             f"query batch), got {launches} "
                             f"({len(recorded)} decode calls)")
    for i, (args, kwargs, det) in enumerate(recorded):
        want = decode(*args, **dict(kwargs, nms_impl="reference"))
        check_detections_equal(det, want, f"meta-test batch {i}")
    log(f"[meta-test] all {batches} query batches equal the twin-decoded "
        "ones, the padded tail batches included")

    novel = "coco_meta_val_novel"
    pred = SylphPredictor(cfg=cfg, model=model, class_code_path=os.path.join(
        cfg.OUTPUT_DIR, "class_codes", novel))
    bank = runner.drivers[novel].bank
    n = bank["cls_conv"].shape[0]
    for key, got in (("cls_conv", pred.bank.conv[:n]),
                     ("cls_bias", pred.bank.bias[:n])):
        np.testing.assert_allclose(got.cpu().numpy(), bank[key], rtol=0,
                                   atol=1e-6, err_msg=key)
    log(f"[meta-test] {novel}: the .npz directory reloads into the "
        f"predictor's bank equal to the driver's ({n} rows, 1e-6)")
    meta_ms, meta_bound, meta_by = time_nms_meta(*recorded[0][:2])
    return launches, dict(meta_test_ms=meta_ms, meta_test_bound_ms=meta_bound,
                          meta_test_bound_by=meta_by)


def phase_card_vs_cpu(devices=("cuda", "cpu")) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_CANVAS = [256, 256]
    cfg.TPU.SUPPORT_CANVAS = [128, 128]
    cfg.INPUT.MIN_SIZE_TEST = 256
    cfg.INPUT.MAX_SIZE_TEST = 256
    # random weights keep class scores below ~0.04; 0.03 leaves a few
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.03
    outs = {}
    for dev in devices:
        pred = SylphPredictor(cfg=cfg, device=dev, max_classes=8)
        rng = np.random.RandomState(5)
        register(pred, rng, ["class_a", "class_b"], 3)
        canvas, size, _ = pred.prepare(random_image(rng, 256, 256))
        out = pred.dense(canvas)
        outs[len(outs)] = (pred.bank.conv.cpu(), out,
                           pred.decode(out, size, pred.bank.valid).numpy())
    tol = dict(rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), **tol)
    for name in ("logits", "reg", "ctrness", "iou"):
        np.testing.assert_allclose(
            getattr(outs[0][1], name).cpu().numpy(),
            getattr(outs[1][1], name).cpu().numpy(), err_msg=name, **tol)
    dg, dc = outs[0][2], outs[1][2]
    kg, kc = dg.valid[0], dc.valid[0]
    if kg.sum() != kc.sum() or kc.sum() == 0:
        raise AssertionError(f"detections: {kg.sum()} on cuda, {kc.sum()} "
                             "on cpu (need equal and > 0)")
    np.testing.assert_allclose(dg.boxes[0][kg], dc.boxes[0][kc], atol=0.05)
    np.testing.assert_allclose(dg.scores[0][kg], dc.scores[0][kc], atol=1e-3)
    np.testing.assert_array_equal(dg.classes[0][kg], dc.classes[0][kc])
    log(f"[card-vs-cpu] fp32 256x256: codes, dense outputs and "
        f"{int(kc.sum())} detections agree")


def main() -> int:
    os.environ.pop("SYLPH_TEST_MODE", None)  # it would cut the query set
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    nms_kernel.build(("nms", "nms_greedy"))
    log(f"[build] nms.cu and nms_greedy.cu built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, out in nms_kernel.BUILD_LOG.items():
        for line in out.splitlines():
            if any(w in line for w in ("Compiling", "registers", "spill")):
                log(f"[build] {name}: {line.strip()}")

    max_err = phase_nms_against_twin()
    serve_launches, timing = phase_serving()
    phase_card_vs_cpu()
    # the meta-test's files live in a scratch directory of their own
    work = tempfile.mkdtemp(prefix="sylph_meta_test_")
    try:
        meta_launches, meta_timing = phase_meta_test(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    by_path = {"serve": serve_launches, "meta_test": meta_launches}
    if min(by_path.values()) < 1:
        raise AssertionError(f"a path never launched the NMS kernel: "
                             f"{by_path}")
    kernels = [dict(name="nms", route="cuda",
                    source="sylph_tpu_torch/csrc/nms.cu",
                    replaces="sylph_tpu/ops/nms_pallas.py:96",
                    launches=sum(by_path.values()),
                    launches_by_path=by_path, max_abs_err=max_err,
                    library_ms=None, **timing, **meta_timing)]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
