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
     reproducing the normalized bank to 1e-6, and a complete AP dict;
  7. training, card against CPU (fp32, TF32 off): R-50 at full depth at a
     256x256 train canvas, one fixed episodic batch (2 episodes x 2 shots
     at 128x128) and one fixed pretrain batch (2 images), both with drawn
     device RandAugment ops, 2 steps on cuda and 2 on cpu from the same
     weights: the augmented canvases equal byte for byte, the assigner's
     labels equal, per-step losses within rtol 1e-3, parameters after within
     atol 1e-4, frozen parameters bit-identical on both devices;
  8. episodic meta-training at full width: the finetune config as
     ``auto_scale_world_size`` leaves it on one card (48 episodes x 5 shots
     at 384x384, one 1024x1024 query each, TPU.GRAD_ACCUM 16, clip 1.0,
     bf16, device RandAugment, backbone and bbox branch frozen), from the
     flax initializers' distributions on the meta-test's synthetic tree:
     ``do_train`` for 1 warm-up and 3 counted steps. Every loss finite,
     frozen parameters bit-identical to their start, the code generator and
     cls tower moved, and a checkpoint saved, restored into a fresh model
     and stepped once equal to the same step uninterrupted;
  9. pretraining at full width: the pretrain config (trainable R-50, 1024x
     1024 canvas, batch 128 in micro-batches of TPU.PRETRAIN_MICRO_BATCH 8),
     1 warm-up and 2 counted steps, every loss finite and the backbone moved.
     Phases 8 and 9 each print a ``train`` JSON line (median step ms, data
     and step wait, images per second, peak memory, losses, the card).
     One-stage training never reaches the NMS kernel: its launches there
     must be 0;
 10. NMS at the two-stage shapes, each identical to the twin, timed from
     CUDA-graph replays beside its bound and the twin's time, with the
     ranking route it took: the RPN's (B=8, K=5000, M=1000, IoU 0.7, the 5
     levels as classes; counting route) and the ROI stage's (B=1, K=337,000
     and 1,103,000, M=300, IoU 0.5: 1000 proposals each repeated over E
     classes, near-uniform scores with ties; radix route), then one class
     of 1,103,000 identical boxes (the scan walks the whole list);
 11. the two-stage meta-test at full width: Meta-RCNN-FPN-finetune.yaml
     (R-50, FPN P2-P6, RPN top-k 1000/1000, 2xFC-1024, codes of 1024), bf16,
     random weights from seed 0, EVAL_BATCH 8, CLASS_BATCH 8, 10 shots at
     384x384, REPEAT_TEST 1, on lvis_meta_val_novelr of a synthetic LVIS
     tree (48 train and 24 val images of 480x640); a warm-up
     ``MetaFasterRCNNRunner.do_test``, then a counted one: every RPN and
     ROI NMS call equal to the twin, two launches per query batch, a
     complete LVIS AP dict, the 1024-wide ``.npz`` codes reloaded and
     normalized equal to the driver's bank (1e-6). Then one query batch
     through ``make_rcnn_infer`` with a 337-row bank (the registered rows
     and rows drawn from seed 0 through ``normalize_code``): the ROI NMS on
     real decode at K=337,000 (radix route), equal to the twin, timed with
     its bound and the twin's time. ROIAlign's time and peak memory on one
     image's 1000 proposals;
 12. plain two-stage evaluation: Meta-RCNN-FPN-pretrain.yaml (1103
     classes) ``do_test`` on 8 images of lvis_pretrain_val_basev1: the ROI
     NMS at K=1,103,000 on real decode, every call equal to the twin (that
     input timed with its bound and the twin's time), a complete AP dict.
     Phases 11-12 print one ``rcnn`` JSON line;
 13. two-stage card against CPU (fp32, TF32 off): ``forward_instances``
     (a 3-row bank) and ``forward_base_instances`` with the cosine head,
     R-50 at a 256x256 canvas, the same seeded weights on cuda and cpu:
     normalized codes 1e-5, detections boxes 0.05, scores 1e-3, classes and
     valid counts equal (each image's detections taken in class and score
     order);
 14. two-stage episodic training at full width: Meta-RCNN-FPN-finetune.yaml
     as ``auto_scale_world_size`` leaves it on one card (48 episodes in one
     group: 240 supports at 384x384, 48 queries at 1024x1024; R-50, FPN
     P2-P6, RPN top-k 2000/1000, 256 anchors and 512 ROIs sampled per
     image, 2xFC-1024, codes of 1024; bf16; backbone frozen) from the flax
     initializers' distributions on lvis_meta_train_basefc of phase 11's
     tree: ``do_train`` for 1 + 3 steps. One RPN NMS launch per step and
     micro-group (B=48, K=8768, M=1000, IoU 0.7), all on the counting route,
     each equal to the twin; losses finite; backbone and FPN unchanged, the
     code generator, RPN head and box head moved; a checkpoint restored and
     stepped equal to the uninterrupted step (1e-5);
 15. two-stage pretraining: Meta-RCNN-FPN-pretrain.yaml (1103 classes,
     batch 32 in 4 micro-batches of 8, the repeat-factor sampler, every
     layer but FrozenBN trained), 1 + 2 steps; then the TFA-RCNN finetune
     (``TFAFasterRCNNRunner``, the cosine classifier, backbone, proposal
     generator and box-head FCs frozen), 1 + 1 steps, where only the cosine
     rows and scale and ``bbox_pred`` move. Both hold every RPN NMS launch
     against the twin, as phase 14. Phases 14-15 print one ``train`` line
     per run, with the RPN NMS and ROIAlign (forward, and backward where the
     features train) per step;
 16. two-stage training, card against CPU (fp32, TF32 off): R-50 at 256x256,
     one fixed batch per mode (2 episodes x 2 shots; one pretrain image, as
     the CPU's ROIAlign backward takes ~10 s an image), 2 steps each from the
     same weights with the same draws (made on the CPU), the pretraining
     at its warmup LR (the flax init diverges at the full LR unclipped):
     anchor labels and sampled ROI sets equal,
     losses within rtol 1e-3, trained parameters within atol 1e-4, frozen
     ones bit-identical. Where the card's proposals differ from the CPU's
     (near-tied objectness ranks differently), the phase says so and
     continues those calls from the CPU's proposals.
 17. the ROIEncoder (``MetaFCOSROIEncoderRunner``, the COCO ROIEncoder
     finetune config at full width, bf16): serving as phase 4 on the host
     path (3 classes at 10 shots, 5 requests, the last at K = 5000; each
     request's detections against the twin-decoded dense outputs); the
     meta-test as phase 6 (one NMS launch a query batch, each equal to the
     twin, complete AP dicts, the ``.npz`` codes reloaded into the bank
     within 1e-6 with no normalization); episodic ``do_train`` as
     ``auto_scale_world_size`` leaves it (48 episodes in 16 micro-groups,
     dropout 0.1 drawn per step and micro-group), 1 + 2 steps: losses
     finite, backbone bit-identical, the ROIEncoder (attention, tokenizer,
     heads, MS-CAM) moved, a resume equal to the uninterrupted step, no NMS
     launch;
 18. the TFA one-stage finetune (``TFAFewShotDetectionRunner``,
     tfa-finetune.yaml at IMS_PER_BATCH 16 on coco_pretrain_finetune_all):
     a seeded base-class model saved as a port checkpoint is MODEL.WEIGHTS;
     the surgery's base rows equal the checkpoint's at the mapped columns;
     ``do_train`` 1 + 2 steps (backbone, FPN, cls tower and bbox branch
     bit-identical, ``cls_logits`` moved, no NMS launch); the plain
     ``do_test`` on coco_meta_val_all (every NMS launch equal to the twin, a
     complete AP dict); then the cosine head (the surgery off: the JAX
     package fails on a ``cls_logits`` checkpoint there), 1 + 1 steps where
     only ``cosine_*`` moves among the head's tensors, and ``do_test``;
 19. DCNv2 towers (the finetune config with MODEL.FCOS.USE_DEFORMABLE): the
     offset heads at seeded non-zero weights (samples between pixels and
     past the border), serving as in phase 17, then one pretraining step at
     batch 16 with finite losses and finite, non-zero offset gradients;
 20. the variants, card against CPU (fp32, TF32 off, R-50 at 256x256): the
     ROIEncoder's codes at eval (1e-5), the cosine head's and the DCN
     towers' dense outputs (phase 5's limits), two ROIEncoder episodic
     steps at DROPOUT 0.0 (phase 7's limits).
     Phases 17-19 print one ``serve`` or ``train`` JSON line per run.
 21. data-parallel registration and meta-test: phase 6's config. In this
     process, fp32 with TF32 off, coco_meta_val_all's 6 classes registered
     2 a call by ``generate_class_codes`` and by
     ``generate_class_codes_sharded`` over an NCCL group of world 1: equal
     bit for bit. Then 2 ranks (``torchrun --standalone``, each a process
     on cuda:0 in one gloo group: the one card allows no NCCL past world
     1) register their 3 classes each, the tail call padded: codes within
     rtol 1e-4 / atol 1e-5 of the one process, both ranks' banks identical;
     then the bf16 meta-test of phase 6 with the sharded bank: every NMS
     launch equal to the twin (one a query batch, every rank scoring the
     whole query set), the AP dicts of both ranks identical. One ``dp``
     line: launches, registration ms a class alone and sharded, the
     all-gather's ms;
 22. data-parallel training, fp32, TF32 off: phase 8's 48 episodes on 2
     ranks x GRAD_ACCUM 8 against this process x 16, and phase 14's on 2
     ranks x 1 against this process x 2, 2 steps each from the same
     weights and batches: losses within rtol 1e-3, trained parameters
     within atol 1e-4, both ranks' parameters bit-identical; in the
     two-stage run the anchor labels and sampled ROIs of every rank and
     step equal the one process's group's (its proposals handed on where
     they differ), every RPN NMS launch (B = 24, K = 8768) equal to the
     twin; rank 0's checkpoint restored on both ranks bit-equal and one
     more step equal to the uninterrupted one (1e-5). One ``train`` line
     per run with each rank's step ms, data wait and peak memory;
 23. the registration benchmark: ``tools/bench_registration.py`` on the
     card, bf16, 1203 classes at 10 shots 8 a call and 64 one a call; one
     ``registration`` line.
     A child rank that fails or hangs past its timeout fails the script.

The last lines are the card's ``name, power.limit``, one JSON object
listing every kernel with its launches (in all, by path and by ranking
route), error and times (``earlier_ms``: the first design's time on the
serving path's NMS input; ``meta_test_ms``: the kernel on a B=8 meta-test
batch; ``shapes``: phase 10's cases and the RPN-train inputs of phases
14-15; ``launches_by_path`` counts the ranks' launches of phases 21-22 as
``dp_meta_test`` and ``dp_rcnn_train``), and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sylph_tpu_torch import get_default_cfg
from sylph_tpu_torch.data.catalog import (DatasetCatalog, register_all_coco,
                                          register_all_lvis)
from sylph_tpu_torch.data.loader import (build_query_loader,
                                         build_support_set_loader)
from sylph_tpu_torch.data.meta_dataset import MetaDataset, temp_seed
from sylph_tpu_torch.data.synthetic import (make_synthetic_coco,
                                            make_synthetic_lvis)
from sylph_tpu_torch import runner as runner_mod
from sylph_tpu_torch.evaluation import meta_eval
from sylph_tpu_torch.meta_faster_rcnn_runner import (
    MetaFasterRCNNRunner, TFAFasterRCNNRunner, build_rcnn_model_from_cfg,
    eval_anchor_grid, train_anchor_grid)
from sylph_tpu_torch.models import rcnn
from sylph_tpu_torch.ops.deform_conv import DFConv2d
from sylph_tpu_torch.ops.roi_align import multilevel_roi_align
from sylph_tpu_torch.ops import nms_kernel
from sylph_tpu_torch.ops.decode import select_candidates
from sylph_tpu_torch.ops.image_ops import resize_shortest_edge_device
from sylph_tpu_torch.ops.nms import (batched_multiclass_nms,
                                     class_offset_boxes,
                                     nms_select_reference)
from sylph_tpu_torch.parallel import create_mesh
from sylph_tpu_torch.predictor import SylphPredictor
from sylph_tpu_torch.ops.assigner import assign_fcos_targets
from sylph_tpu_torch.ops.image_aug import rand_augment_device
from sylph_tpu_torch.ops.locations import build_location_grid
from sylph_tpu_torch.runner import (MetaFCOSRunner, _freeze_cfg, _mapper,
                                    build_model_from_cfg, create_runner)
from sylph_tpu_torch.data.loader import batch_to_device
from sylph_tpu_torch.data.transforms import draw_rand_augment
from sylph_tpu_torch.tools import bench_registration
from sylph_tpu_torch.tools.profile_meta_test import DATA as META_TEST_DATA
from sylph_tpu_torch.tools.profile_meta_test import (ONE_STAGE, RCNN_DATA,
                                                     meta_test_cfg,
                                                     rcnn_meta_test_cfg)
from sylph_tpu_torch.tools.profile_train import (rcnn_train_cfg, train_cfg,
                                                 variant_train_cfg)
from sylph_tpu_torch.train.checkpoint import CheckpointManager
from sylph_tpu_torch.utils.events import peak_memory_gb

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


def reset_counts() -> None:
    """The start of a main-path window: the kernel's launch counts, in all
    and by route, to 0."""
    nms_kernel.LAUNCHES = 0
    for route in nms_kernel.LAUNCHES_BY_ROUTE:
        nms_kernel.LAUNCHES_BY_ROUTE[route] = 0


def read_counts(what: str):
    """The end of a main-path window: -> (launches, launches by route);
    raises if the routes do not add up to the launches."""
    launches, routes = nms_kernel.LAUNCHES, dict(nms_kernel.LAUNCHES_BY_ROUTE)
    if sum(routes.values()) != launches:
        raise AssertionError(f"{what}: {launches} NMS launches, but by route "
                             f"{routes}")
    return launches, routes


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
    reset_counts()
    reg_ms = register(pred, rng, ["class_a", "class_b", "class_c"], shots)
    results, lat_ms = [], []
    for img, full_k, dev_pre in requests:
        set_thresh(full_k)
        t0 = time.perf_counter()
        results.append(pred(img, device_preprocess=dev_pre))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts("serve")
    # ---- end of the main path
    launches = counts[0]

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
    return counts, timing


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
    """The kernel's CUDA-graph time, its bound and the twin's time on one
    meta-test query batch, from the arguments its ``decode_proposals`` call
    was given."""
    logits, reg, ctr, iou, locs, strides, _, dcfg, splits = args
    with torch.inference_mode():
        cand = select_candidates(logits, reg, ctr, iou, locs, strides, dcfg,
                                 splits, kwargs.get("class_valid"))
    m, thr = dcfg.post_nms_topk, dcfg.nms_thresh
    shifted, *planes = nms_planes(cand.boxes, cand.scores, cand.classes,
                                  cand.valid)
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, thr, m), 50,
                 graph=True)
    idx, ok = nms_kernel.nms_cuda(*planes, thr, m)
    bound_ms, bound_by = nms_bound_ms(cand.scores, cand.valid, idx,
                                      ok.bool())
    plain_ms = time_ms(lambda: nms_select_reference(
        shifted, cand.scores, cand.valid, thr, m), 3, warmup=1)
    b, k = cand.scores.shape
    log(f"[nms] meta-test input B={b} K={k} M={m} "
        f"({int(cand.valid.sum())} valid): kernel {ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}), twin {plain_ms:.3f} ms")
    return ms, bound_ms, bound_by, plain_ms


# ------------------------------------------------------------- meta-test
def check_ap_dict(name: str, bbox: dict, class_names,
                  repeated: bool = True) -> None:
    """Every AP key of the dataset, with the REPEAT_TEST spreads when the
    meta-test ran (``repeated``), without for a plain evaluation."""
    want = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1", "AR@10",
            "AR@100"] + [f"AP-{c}" for c in class_names]
    if name.endswith("_all"):
        want += ["nAP", "bAP"]
    if repeated:
        want += [f"{k}_std" for k in want]
    missing = [k for k in want if not isinstance(bbox.get(k), float)]
    if missing:
        raise AssertionError(f"{name}: AP dict lacks {missing}")


def coco_tree(work: str) -> None:
    """The synthetic COCO tree of the one-stage phases, written once."""
    root = os.path.join(work, "coco")
    if not os.path.isdir(root):
        make_synthetic_coco(root, **META_TEST_DATA)
    register_all_coco(root)


def phase_meta_test(work: str, runner_name: str = "MetaFCOSRunner",
                    label: str = "meta_test"):
    """The two-phase meta-test at full width with ``runner_name``'s config;
    returns its NMS launch counts and the kernel's time on one of its B=8
    batches (the default runner) or the driver's stats."""
    coco_tree(work)
    cfg = meta_test_cfg(os.path.join(work, label), runner_name)
    runner = create_runner(runner_name)
    model = runner.build_model(cfg)
    t0 = time.perf_counter()
    runner.do_test(cfg, model)  # warm-up: cuDNN plans, the g++ matcher
    log(f"[{label}] warm-up do_test: {time.perf_counter() - t0:.1f} s")
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
        reset_counts()
        t0 = time.perf_counter()
        results = runner.do_test(cfg, model)
        wall = time.perf_counter() - t0
        counts = read_counts(label)
        # ---- end of the main path
    finally:
        meta_eval.decode_proposals = decode
    launches = counts[0]

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
        log(f"[{label}] {name}: {int(st['classes'])} classes, "
            f"{int(st['query_images'])} query images in "
            f"{int(st['query_batches'])} batches of {cfg.TPU.EVAL_BATCH}; "
            f"AP {res['bbox']['AP']:.4f}, AP50 {res['bbox']['AP50']:.4f}")
        log(f"[{label}] {name} times (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in st.items()
            if k.endswith("_s")))
        log(f"[{label}] {name}: code generation "
            f"{st['codegen_s'] / st['classes'] * 1e3:.2f} ms per class "
            f"({cfg.TPU.CLASS_BATCH} classes per call), query "
            f"{st['query_images'] / st['query_s']:.2f} img/s at B="
            f"{cfg.TPU.EVAL_BATCH}")
    log(f"[{label}] do_test on both datasets: {wall:.2f} s on the host "
        f"clock; NMS launches {launches}")
    if launches != batches or len(recorded) != batches:
        raise AssertionError(f"expected {batches} NMS launches (one per "
                             f"query batch), got {launches} "
                             f"({len(recorded)} decode calls)")
    for i, (args, kwargs, det) in enumerate(recorded):
        want = decode(*args, **dict(kwargs, nms_impl="reference"))
        check_detections_equal(det, want, f"{label} batch {i}")
    log(f"[{label}] all {batches} query batches equal the twin-decoded "
        "ones, the padded tail batches included")

    novel = "coco_meta_val_novel"
    pred = SylphPredictor(cfg=cfg, model=model, runner_name=runner_name,
                          class_code_path=os.path.join(
                              cfg.OUTPUT_DIR, "class_codes", novel))
    bank = runner.drivers[novel].bank
    n = bank["cls_conv"].shape[0]
    for key, got in (("cls_conv", pred.bank.conv[:n]),
                     ("cls_bias", pred.bank.bias[:n])):
        np.testing.assert_allclose(got.cpu().numpy(), bank[key], rtol=0,
                                   atol=1e-6, err_msg=key)
    norm = ("no normalization: the ROIEncoder's codes are final"
            if model.code_generator_name == "ROIEncoder"
            else "normalized on loading")
    log(f"[{label}] {novel}: the .npz directory reloads into the "
        f"predictor's bank equal to the driver's ({n} rows, 1e-6, {norm})")
    if runner_name != "MetaFCOSRunner":
        return counts, {name: dict(d.stats)
                        for name, d in runner.drivers.items()}
    meta_ms, meta_bound, meta_by, meta_plain = time_nms_meta(
        *recorded[0][:2])
    return counts, dict(meta_test_ms=meta_ms, meta_test_bound_ms=meta_bound,
                        meta_test_bound_by=meta_by,
                        meta_test_plain_ms=meta_plain)


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


# ------------------------------------------------------------- training
def _fixed_train_batch(episodic: bool, canvas, support, max_gt: int):
    """One batch from a numpy seed: uint8 canvases, GT boxes, drawn
    RandAugment ops (episodic: 2 episodes x 2 shots, 1 query each;
    pretrain: 2 images)."""
    rng = np.random.RandomState(11)
    n = 2
    xy = rng.uniform(0, canvas[0] * 0.5, (n, max_gt, 2))
    wh = rng.uniform(24, canvas[0] * 0.5, (n, max_gt, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.zeros((n, max_gt), bool)
    valid[:, :5] = True
    ids = np.array([3, 7], np.int32)
    labels = rng.randint(0, 10, (n, max_gt)).astype(np.int32)
    labels[:, 0], labels[:, 1] = ids, ids[::-1]
    drawn = [draw_rand_augment(np.random.RandomState(20 + i))
             for i in range(n)]
    sizes = np.array([[canvas[0] - 17, canvas[1] - 5],
                      [canvas[0] - 40, canvas[1]]], np.int32)
    images = np.zeros((n, *canvas, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        images[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
    aug = (np.stack([d[0] for d in drawn]), np.stack([d[1] for d in drawn]),
           sizes)
    if not episodic:
        return {"images": images, "gt_boxes": boxes, "gt_labels": labels,
                "gt_valid": valid, "aug_ops": aug[0], "aug_params": aug[1],
                "image_sizes": aug[2]}
    sx = rng.uniform(4, support[0] * 0.4, (2 * n, 2))
    return {
        "support_images": rng.randint(0, 256, (2 * n, *support, 3)).astype(
            np.uint8),
        "support_boxes": np.concatenate([sx, sx + support[0] * 0.5],
                                        -1).astype(np.float32),
        "support_box_valid": np.ones((2 * n,), bool),
        "query_images": images, "query_gt_boxes": boxes,
        "query_gt_labels": labels, "query_gt_valid": valid,
        "episode_class_ids": ids, "query_aug_ops": aug[0],
        "query_aug_params": aug[1], "query_image_sizes": aug[2]}


def _train_small_cfg(episodic: bool):
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG if episodic else
                        "sylph://COCO-Detection/Meta-FCOS/"
                        "Meta-FCOS-pretrain.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.TRAIN_CANVAS = [256, 256]
    cfg.TPU.SUPPORT_CANVAS = [128, 128]
    cfg.TPU.MAX_GT_BOXES = 20
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.WARMUP_ITERS = 0  # the configs' full LR: parameters move
    cfg.OUTPUT_DIR = ""
    return cfg


def phase_train_card_vs_cpu(devices=("cuda", "cpu"), cases=None) -> None:
    """Two train steps on each device from the same init and batch:
    ``cases`` is a list of (label, config), by default the episodic and the
    pretrain step of ``_train_small_cfg``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for mode, cfg in cases or [("episodic", _train_small_cfg(True)),
                               ("pretrain", _train_small_cfg(False))]:
        episodic = cfg.MODEL.META_LEARN.EPISODIC_LEARNING
        batch = _fixed_train_batch(episodic, tuple(cfg.TPU.TRAIN_CANVAS),
                                   tuple(cfg.TPU.SUPPORT_CANVAS),
                                   cfg.TPU.MAX_GT_BOXES)
        img_key = "query_images" if episodic else "images"
        pre = "query_" if episodic else ""
        grid = build_location_grid(tuple(cfg.TPU.TRAIN_CANVAS),
                                   tuple(cfg.MODEL.FCOS.FPN_STRIDES),
                                   list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))
        runs = []
        for dev in devices:
            runner = MetaFCOSRunner(device=dev)
            model = build_model_from_cfg(cfg, device=dev, init="train")
            start = {k: v.clone() for k, v in model.state_dict().items()}
            state, _, _ = runner._common_train_setup(cfg, model)
            step = runner.make_train_step(cfg, model)
            b = batch_to_device(batch, dev)
            canvas = rand_augment_device(
                b[img_key], batch[pre + "aug_ops"], batch[pre + "aug_params"],
                batch[pre + "image_sizes"]).cpu()
            gt = b[pre + "gt_boxes"], b[pre + "gt_labels"], b[pre + "gt_valid"]
            labels = assign_fcos_targets(
                *(torch.as_tensor(a, device=dev) for a in (
                    grid.locations, grid.strides, grid.size_ranges)),
                *gt).labels.cpu()
            losses = [{k: float(v) for k, v in step(state, b)[1].items()}
                      for _ in range(2)]
            runs.append((canvas, labels, losses, {
                k: v.detach().cpu() for k, v in model.state_dict().items()},
                set(state.tx.names), {k: v.cpu() for k, v in start.items()}))
        (cg, lg, los_g, pg, train_g, start), (cc, lc, los_c, pc, _, _) = runs
        if not torch.equal(cg, cc):
            raise AssertionError(f"{mode}: RandAugment canvases differ "
                                 "between cuda and cpu")
        if not torch.equal(lg, lc) or int((lc >= 0).sum()) == 0:
            raise AssertionError(f"{mode}: assigner labels differ")
        for i, (a, c) in enumerate(zip(los_g, los_c)):
            for k in c:
                if not (np.isfinite(a[k]) and abs(a[k] - c[k])
                        <= 1e-3 * abs(c[k])):
                    raise AssertionError(f"{mode} step {i} {k}: cuda {a[k]} "
                                         f"cpu {c[k]}")
        worst = 0.0
        for k, v in pc.items():
            if k in train_g:
                worst = max(worst, float((pg[k] - v).abs().max()))
            elif not (torch.equal(pg[k], start[k]) and torch.equal(v,
                                                                   start[k])):
                raise AssertionError(f"{mode}: frozen {k} changed")
        if worst > 1e-4:
            raise AssertionError(f"{mode}: parameters differ by {worst}")
        log(f"[train-card-vs-cpu] {mode}: canvases equal, "
            f"{int((lc >= 0).sum())} positive labels equal, losses "
            f"{[{k: round(v, 5) for k, v in s.items()} for s in los_g]} "
            f"within rtol 1e-3, trained parameters within {worst:.2e}, "
            f"frozen bit-identical")


def _train_line(mode: str, cfg, runner, counted, images_per_step, card,
                config: str = ""):
    """The ``train`` JSON line of one full-width run."""
    times = runner.loop_times[-counted:]
    steps_ms = [1e3 * (d + s) for d, s in times]
    return {"train": mode, "config": config or os.path.basename(
        CONFIG if mode == "episodic" else "Meta-FCOS-pretrain.yaml"),
        "batch": cfg.SOLVER.IMS_PER_BATCH,
        "grad_accum": cfg.TPU.GRAD_ACCUM,
        "counted_steps": counted,
        "median_step_ms": float(np.median(steps_ms)),
        "step_ms": steps_ms,
        "data_wait_ms": [1e3 * d for d, _ in times],
        "step_wait_ms": [1e3 * s for _, s in times],
        "images_per_s": float(images_per_step
                              / (np.median(steps_ms) / 1e3)),
        "peak_memory_gb": peak_memory_gb(),
        "losses": runner.train_metrics[-counted:], "card": card}


def phase_train_episodic(work: str, card: str):
    """Meta-training at full width; returns its NMS launch counts and the
    ``train`` line."""
    cfg = train_cfg("episodic", 4)
    runner = MetaFCOSRunner()
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts are read around this block alone
    reset_counts()
    _, state = runner.do_train(cfg, model)
    counts = read_counts("train_episodic")
    # ---- end of the main path
    for i, m in enumerate(runner.train_metrics):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i}: non-finite loss {m}")
    trainable = set(state.tx.names)
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, start[k])}
    if not moved <= trainable:
        raise AssertionError(f"frozen parameters changed: "
                             f"{sorted(moved - trainable)[:5]}")
    for prefix in ("code_generator.", "fcos_head.cls_tower."):
        if not any(k.startswith(prefix) for k in moved):
            raise AssertionError(f"{prefix} did not move")
    if any(k.startswith(("backbone.", "fpn.", "fcos_head.bbox"))
           for k in trainable):
        raise AssertionError("backbone or bbox branch trainable")
    e = cfg.SOLVER.IMS_PER_BATCH
    imgs = e * (cfg.MODEL.META_LEARN.SHOT + cfg.MODEL.META_LEARN.QUERY_SHOT)
    line = _train_line("episodic", cfg, runner, 3, imgs, card)
    log(f"[train-episodic] {e} episodes, GRAD_ACCUM {cfg.TPU.GRAD_ACCUM}: "
        f"median step {line['median_step_ms']:.1f} ms, "
        f"{line['images_per_s']:.1f} img/s, peak "
        f"{line['peak_memory_gb']:.2f} GB; {len(moved)} tensors moved, "
        f"{len(start) - len(moved)} unchanged")
    check_resume(cfg, runner, state, work)
    return counts, line


def check_resume(cfg, runner, state, work: str,
                 label: str = "train-episodic") -> None:
    """Checkpoint, restore into a fresh model, one step: equal to the same
    step taken by the uninterrupted state."""
    cfg = cfg.clone()
    cfg.OUTPUT_DIR = os.path.join(work, "resume", label)
    CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "ckpt")).save(
        state.step, state)
    loader = runner._episodic_loader(cfg)
    batch = next(loader)
    loader.close()
    runner.make_train_step(cfg, state.model)(state, batch)
    fresh = runner.build_model(cfg, init="train")
    resumed, _, _ = runner._common_train_setup(cfg, fresh)
    if resumed.step != state.step - 1:
        raise AssertionError(f"restored step {resumed.step}")
    runner.make_train_step(cfg, fresh)(resumed, batch)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(state.model.state_dict().values(),
                                fresh.state_dict().values()))
    worst_m = max(float((a - b).abs().max())
                  for a, b in zip(state.tx.trace, resumed.tx.trace))
    if worst > 1e-5 or worst_m > 1e-5:
        raise AssertionError(f"resumed step differs: params {worst}, "
                             f"momentum {worst_m}")
    log(f"[{label}] save, restore, one step = one uninterrupted step "
        f"(params within {worst:.2e}, momentum within {worst_m:.2e})")


def phase_train_pretrain(card: str, batch: int = 128):
    cfg = train_cfg("pretrain", 3, batch=batch)
    runner = MetaFCOSRunner()
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts are read around this block alone
    reset_counts()
    runner.do_train(cfg, model)
    counts = read_counts("train_pretrain")
    # ---- end of the main path
    for i, m in enumerate(runner.train_metrics):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i}: non-finite loss {m}")
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, start[k])}
    if not any(k.startswith("backbone.") for k in moved):
        raise AssertionError("the backbone did not move")
    line = _train_line("pretrain", cfg, runner, 2, cfg.SOLVER.IMS_PER_BATCH,
                       card)
    log(f"[train-pretrain] batch {cfg.SOLVER.IMS_PER_BATCH}, GRAD_ACCUM "
        f"{cfg.TPU.GRAD_ACCUM}: median step {line['median_step_ms']:.1f} ms, "
        f"{line['images_per_s']:.1f} img/s, peak "
        f"{line['peak_memory_gb']:.2f} GB")
    return counts, line


# ------------------------------------------------------------- two-stage
def roi_stage_inputs(gen: torch.Generator, e: int, p: int = 1000):
    """One image's ROI-stage NMS input, built as ``roi_candidates`` builds
    it: ``p`` proposal boxes each repeated over ``e`` classes, near-uniform
    softmax scores rounded to multiples of 2^-20 (ties everywhere), a score
    threshold of 1e-4."""
    ctr = torch.rand((p, 2), generator=gen) * torch.tensor([1344.0, 1024.0])
    wh = 8 + torch.rand((p, 2), generator=gen) * 300
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    probs = torch.softmax(torch.randn((p, e + 1), generator=gen) * 0.5,
                          -1)[:, :-1]
    flat = (probs * 2 ** 20).round().reshape(1, -1) / 2 ** 20
    return [t.cuda() for t in (
        boxes.repeat_interleave(e, dim=0)[None], flat,
        torch.arange(e).repeat(p)[None], flat > 1e-4)]


def rpn_inputs(gen: torch.Generator, b: int = 8, per_level: int = 1000):
    """The RPN's NMS input: 5 levels of ``per_level`` proposals, the level
    as the class, boxes crowded around 400 centres (anchors overlap), sigmoid
    scores rounded to 1/1024 (ties)."""
    k = 5 * per_level
    centres = torch.rand((b, 400, 2), generator=gen) * 1200
    pick = torch.randint(0, 400, (b, k), generator=gen)
    ctr = centres.gather(1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn((b, k, 2), generator=gen) * 8
    wh = 32 * 2 ** torch.arange(5).repeat_interleave(per_level)[None, :, None]
    wh = wh * (0.7 + 0.6 * torch.rand((b, k, 2), generator=gen))
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    scores = (torch.sigmoid(torch.randn((b, k), generator=gen) * 2)
              * 1024).round() / 1024
    levels = torch.arange(5).repeat_interleave(per_level)[None].expand(b, -1)
    valid = torch.rand((b, k), generator=gen) > 0.02
    return [t.cuda() for t in (boxes, scores, levels.contiguous(), valid)]


def check_two_stage_case(inputs, m: int, thr: float, what: str,
                         reps: int = 20):
    """One case: kernel equal to the twin, the route it took, the kernel's
    CUDA-graph time beside its bound, the twin's time."""
    boxes, scores, classes, valid = inputs
    reset_counts()
    got = batched_multiclass_nms(boxes, scores, classes, valid, thr, m)
    torch.cuda.synchronize()
    route = [r for r, n in read_counts(what)[1].items() if n]
    want = batched_multiclass_nms(boxes, scores, classes, valid, thr, m,
                                  impl="reference")
    for name, g, w in zip(("boxes", "scores", "classes", "ok", "idx"), got,
                          want):
        if not torch.equal(g, w):
            raise AssertionError(f"NMS kernel != twin in {name}: {what}")
    shifted, *planes = nms_planes(boxes, scores, classes, valid)
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, thr, m), reps,
                 graph=True)
    plain_ms = time_ms(lambda: nms_select_reference(shifted, scores, valid,
                                                    thr, m), 1, warmup=1,
                       rounds=3)
    bound_ms, bound_by = nms_bound_ms(scores, valid, got[4], got[3])
    b, k = scores.shape
    log(f"[nms-2stage] {what}: identical to the twin, route {route}; "
        f"kernel {ms:.4f} ms, twin {plain_ms:.3f} ms, bound {bound_ms:.6f} "
        f"ms ({bound_by}), {int(got[3].sum())} picks of "
        f"{int(valid.sum())} alive")
    return dict(case=what, b=b, k=k, m=m, route=route[0], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_nms_two_stage():
    gen = torch.Generator().manual_seed(3)
    shapes = [check_two_stage_case(rpn_inputs(gen), 1000, 0.7,
                                   "RPN B=8 K=5000 M=1000")]
    if shapes[0]["route"] != "count":
        raise AssertionError("the RPN's K=5000 should take the counting route")
    for e in (337, 1103):
        shapes.append(check_two_stage_case(
            roi_stage_inputs(gen, e), 300, 0.5,
            f"ROI B=1 K={e * 1000} M=300", reps=10))
    k = 1_103_000
    same = torch.tensor([300.0, 200.0, 700.0, 500.0]).expand(1, k, 4)
    shapes.append(check_two_stage_case(
        [same.contiguous().cuda(), torch.rand((1, k), generator=gen).cuda(),
         torch.zeros((1, k), dtype=torch.long).cuda(),
         torch.ones((1, k), dtype=torch.bool).cuda()], 300, 0.5,
        f"identical boxes B=1 K={k} M=300", reps=3))
    if any(c["route"] != "radix" for c in shapes[1:]):
        raise AssertionError("the ROI-stage shapes should take the radix "
                             "route")
    return shapes


class NMSRecorder:
    """Records every ``batched_multiclass_nms`` call the two-stage model
    makes by device (the RPN's and the ROI stage's); ``check`` runs each
    again with the twin on the card and requires identical results."""

    def __enter__(self):
        self.calls = []
        self.orig = rcnn.batched_multiclass_nms

        def recording(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            if kwargs.get("impl") is None:
                self.calls.append((args, out))
            return out

        rcnn.batched_multiclass_nms = recording
        return self

    def __exit__(self, *exc):
        rcnn.batched_multiclass_nms = self.orig

    def check(self, what: str):
        """-> (number of calls, their (B, K) shapes)."""
        shapes = []
        with torch.inference_mode():
            for i, (args, got) in enumerate(self.calls):
                want = self.orig(*args, impl="reference")
                shapes.append(tuple(args[1].shape))
                for name, g, w in zip(("boxes", "scores", "classes", "ok",
                                       "idx"), got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"{what}: NMS call {i} (B, K = {shapes[-1]}) "
                            f"differs from the twin in {name}")
        self.calls = []
        return len(shapes), shapes


def check_lvis_ap(name: str, bbox: dict, classes, meta: bool) -> None:
    """The AP keys, one per class, and on a meta split (whose categories
    carry LVIS frequencies) APr/APc/APf and every key's REPEAT_TEST std."""
    want = ["AP", "AP50", "AP75", "APs", "APm", "APl"] \
        + [f"AP-{c}" for c in classes] + (["APr", "APc", "APf"] if meta
                                          else [])
    if meta:
        want += [f"{k}_std" for k in want]
    missing = [k for k in want if not isinstance(bbox.get(k), float)]
    if missing:
        raise AssertionError(f"{name}: AP dict lacks {missing}")


def query_batch(cfg, dataset_dict, device="cuda"):
    """The first query batch of ``dataset_dict`` on the card."""
    ds = MetaDataset(dataset_dict, "episodic_test_queryset",
                     num_shot=cfg.MODEL.META_LEARN.EVAL_SHOT)
    loader = build_query_loader(ds, _mapper(cfg),
                                batch_size=cfg.TPU.EVAL_BATCH)
    batch = next(iter(loader))
    return (torch.as_tensor(batch["images"], device=device),
            torch.as_tensor(batch["image_sizes"], device=device))


def roi_align_cost(model, images, sizes, cfg):
    """ROIAlign of one image's proposals at P2-P5 (as ``roi_forward`` runs
    it): ms on the card (median of 5 event-timed calls) and the peak memory
    it adds, in GB."""
    grid = eval_anchor_grid(cfg)
    with torch.inference_mode():
        feats, logits, deltas = model.forward_rpn(images[:1])
        props, _, valid = rcnn.rpn_proposals(
            logits, deltas, torch.as_tensor(grid.anchors, device="cuda"),
            grid.level_splits, sizes[:1],
            pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST)

        def pool():
            return multilevel_roi_align(
                feats[:4], model.ROI_STRIDES, props[0], valid[0],
                torch.zeros(props.shape[1], dtype=torch.long,
                            device="cuda"),
                output_size=7)

        ms = time_ms(pool, 1, warmup=1, rounds=5)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pool()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return ms, peak, int(props.shape[1])


def time_real_decode(inputs, reps: int):
    """The ROI stage's recorded NMS input (IoU 0.5, M = 300): the kernel's
    CUDA-graph ms, its bound (ms, basis) and the twin's ms."""
    boxes, scores, classes, valid = inputs
    shifted, *planes = nms_planes(boxes, scores, classes, valid)
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, 0.5, 300), reps,
                 graph=True)
    idx, ok = nms_kernel.nms_cuda(*planes, 0.5, 300)
    bound = nms_bound_ms(scores, valid, idx, ok.bool())
    plain_ms = time_ms(lambda: nms_select_reference(shifted, scores, valid,
                                                    0.5, 300), 1, warmup=1,
                       rounds=3)
    return ms, bound, plain_ms


def lvis_tree(work: str) -> None:
    """The synthetic LVIS tree of the two-stage phases, written once."""
    lvis_root = os.path.join(work, "lvis")
    if not os.path.isdir(lvis_root):
        make_synthetic_lvis(lvis_root, os.path.join(work, "lvis_images"),
                            **RCNN_DATA)
    register_all_lvis(lvis_root, os.path.join(work, "lvis_images"))


def phase_rcnn_meta_test(work: str):
    """Phase 11; returns the readings of its two main-path windows (the
    meta-test's and the 337-row bank's: launches, and launches by route) by
    path, and the ``rcnn`` line's meta-test part."""
    lvis_tree(work)
    cfg = rcnn_meta_test_cfg(os.path.join(work, "rcnn_out"))
    name = cfg.DATASETS.TEST[0]
    runner = MetaFasterRCNNRunner()
    model = runner.build_model(cfg)
    t0 = time.perf_counter()
    runner.do_test(cfg, model)  # warm-up: cuDNN plans
    log(f"[rcnn] warm-up do_test: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(cfg.OUTPUT_DIR)

    torch.cuda.reset_peak_memory_stats()
    with NMSRecorder() as rec:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        t0 = time.perf_counter()
        results = runner.do_test(cfg, model)
        wall = time.perf_counter() - t0
        counts = read_counts("rcnn_meta_test")
        # ---- end of the main path
    launches, routes = counts
    peak = peak_memory_gb()
    driver = runner.drivers[name]
    st, meta = driver.stats, driver.dataset_dict["metadata"]
    n_calls, shapes = rec.check("two-stage meta-test")
    batches = int(st["query_batches"])
    if launches != 2 * batches or n_calls != launches:
        raise AssertionError(f"expected 2 NMS launches per query batch "
                             f"({batches} batches), got {launches} "
                             f"({n_calls} calls)")
    check_lvis_ap(name, results[name]["bbox"], meta["thing_classes"], True)
    log(f"[rcnn] {name}: {int(st['classes'])} classes, "
        f"{int(st['query_images'])} query images in {batches} batches; "
        f"{n_calls} NMS calls (B, K: {sorted(set(shapes))}) equal the twin, "
        f"routes {routes}; AP {results[name]['bbox']['AP']:.4f}; do_test "
        f"{wall:.2f} s, peak {peak:.2f} GB")
    log(f"[rcnn] {name} times (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in st.items() if k.endswith("_s")))

    # the .npz codes (raw, 1024 wide) reload into the normalized bank
    code_dir = os.path.join(cfg.OUTPUT_DIR, "class_codes", name)
    ids = {c: i for i, c in enumerate(meta["thing_classes"])}
    codes = {ids[f[:-4]]: {"code": dict(np.load(os.path.join(code_dir, f)))}
             for f in os.listdir(code_dir)}
    if any(c["code"]["cls_conv"].shape != (1, 1024) for c in codes.values()):
        raise AssertionError("class codes are not 1024 wide")
    reloaded = meta_eval.normalize_class_codes(model, codes)
    for key in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(reloaded[key], driver.bank[key], rtol=0,
                                   atol=1e-6, err_msg=key)
    log(f"[rcnn] {len(codes)} .npz codes reload and normalize to the "
        "driver's bank (1e-6)")

    # one query batch against a 337-row bank: K = 337,000 on real decode
    gen = torch.Generator().manual_seed(0)
    n_extra = 337 - driver.bank["cls_conv"].shape[0]
    with torch.inference_mode():
        drawn = model.normalize_code({
            "cls_conv": torch.randn((n_extra, 1024), generator=gen).cuda(),
            "cls_bias": torch.randn((n_extra,), generator=gen).cuda()})
    bank = {k: np.concatenate([driver.bank[k], drawn[k].cpu().numpy()])
            for k in ("cls_conv", "cls_bias")}
    images, sizes = query_batch(cfg, driver.dataset_dict)
    infer = runner.make_infer(cfg, model, bank, eval_anchor_grid(cfg))
    infer(images, sizes)  # warm-up
    with NMSRecorder() as rec:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = infer(images, sizes)
        torch.cuda.synchronize()
        bank_ms = (time.perf_counter() - t0) * 1e3
        bank_counts = read_counts("rcnn_bank_337")
        # ---- end of the main path
        roi_args = rec.calls[-1][0]
    bank_routes = bank_counts[1]
    n_calls, shapes = rec.check("337-row bank")
    if (shapes[-1] != (images.shape[0], 337_000)
            or bank_routes.get("radix") != 1 or not bool(det.valid.any())):
        raise AssertionError(f"337-row bank: NMS shapes {shapes}, routes "
                             f"{bank_routes}")
    roi_ms, roi_bound, roi_plain = time_real_decode(roi_args[:4], 10)
    log(f"[rcnn] 337-row bank: one batch of {images.shape[0]} in "
        f"{bank_ms:.1f} ms; ROI NMS (B={images.shape[0]}, K=337000, "
        f"{int(roi_args[3].sum())} alive) equal to the twin, radix route, "
        f"kernel {roi_ms:.4f} ms, bound {roi_bound[0]:.6f} ms "
        f"({roi_bound[1]}), twin {roi_plain:.3f} ms; "
        f"{int(det.valid.sum())} detections")
    ra_ms, ra_gb, n_props = roi_align_cost(model, images, sizes, cfg)
    log(f"[rcnn] ROIAlign of {n_props} proposals at P2-P5: {ra_ms:.2f} ms, "
        f"+{ra_gb:.2f} GB peak")
    line = {"rcnn": "meta_test", "config": "Meta-RCNN-FPN-finetune.yaml",
        "eval_batch": cfg.TPU.EVAL_BATCH,
        "query_img_per_s": st["query_images"] / st["query_s"],
        "registration_ms_per_class": st["codegen_s"] / st["classes"] * 1e3,
        "stats": st, "do_test_s": wall, "peak_memory_gb": peak,
        "nms_launches_per_query_batch": launches / batches,
        "nms_routes": routes,
        "bank_337": {"batch_ms": bank_ms, "roi_nms_ms": roi_ms,
                     "roi_nms_bound_ms": roi_bound[0],
                     "roi_nms_bound_by": roi_bound[1],
                     "roi_nms_plain_ms": roi_plain,
                     "nms_routes": bank_routes},
        "roi_align_ms_per_image": ra_ms,
        "roi_align_peak_gb_per_image": ra_gb}
    return {"rcnn_meta_test": counts, "rcnn_bank_337": bank_counts}, line


def phase_rcnn_plain(work: str):
    """Phase 12: the 1103-class base classifier on 8 images."""
    cfg = rcnn_meta_test_cfg(
        os.path.join(work, "rcnn_plain_out"),
        config="sylph://LVISv1-Detection/Meta-RCNN/"
               "Meta-RCNN-FPN-pretrain.yaml")
    name = "lvis_pretrain_val_basev1"
    cfg.DATASETS.TEST = [name]
    full = DatasetCatalog.get(name)
    DatasetCatalog.register(name, lambda: dict(
        full, records=full["records"][:8]))
    runner = MetaFasterRCNNRunner()
    model = runner.build_model(cfg)
    runner.do_test(cfg, model)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with NMSRecorder() as rec:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        t0 = time.perf_counter()
        results = runner.do_test(cfg, model)
        wall = time.perf_counter() - t0
        counts = read_counts("rcnn_plain")
        # ---- end of the main path
        roi_args = rec.calls[-1][0]
    launches, routes = counts
    peak = peak_memory_gb()
    n_calls, shapes = rec.check("plain two-stage evaluation")
    if (n_calls != launches or (8, 1_103_000) not in shapes
            or not routes.get("radix")):
        raise AssertionError(f"plain evaluation: NMS shapes {shapes}, routes "
                             f"{routes}")
    roi_ms, roi_bound, roi_plain = time_real_decode(roi_args[:4], 5)
    log(f"[rcnn-plain] ROI NMS input (B=8, K=1103000, "
        f"{int(roi_args[3].sum())} alive): kernel {roi_ms:.4f} ms, bound "
        f"{roi_bound[0]:.6f} ms ({roi_bound[1]}), twin {roi_plain:.3f} ms")
    check_lvis_ap(name, results[name]["bbox"],
                  full["metadata"]["thing_classes"], False)
    log(f"[rcnn-plain] {name}, 8 images, 1103 classes: {n_calls} NMS calls "
        f"(B, K: {sorted(set(shapes))}) equal the twin, routes {routes}; "
        f"do_test {wall:.2f} s, peak {peak:.2f} GB, AP "
        f"{results[name]['bbox']['AP']:.4f}")
    return counts, {"config": "Meta-RCNN-FPN-pretrain.yaml", "images": 8,
                    "do_test_s": wall, "img_per_s": 8 / wall,
                    "peak_memory_gb": peak, "nms_launches": launches,
                    "nms_routes": routes, "roi_nms_ms": roi_ms,
                    "roi_nms_bound_ms": roi_bound[0],
                    "roi_nms_bound_by": roi_bound[1],
                    "roi_nms_plain_ms": roi_plain}


def _sorted_dets(det, i):
    """Image i's valid detections in (class, score descending) order."""
    v = det.valid[i]
    cls, sc, bx = det.classes[i][v], det.scores[i][v], det.boxes[i][v]
    order = np.lexsort((-sc, cls))
    return cls[order], sc[order], bx[order]


def phase_rcnn_card_vs_cpu(devices=("cuda", "cpu")) -> None:
    """Phase 13."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(13)
    images = rng.randint(0, 256, (2, 256, 256, 3)).astype(np.float32)
    sizes = np.array([[256, 256], [200, 240]], np.int32)
    raw = {"cls_conv": rng.normal(0, 1, (3, 1024)).astype(np.float32),
           "cls_bias": rng.normal(0, 1, (3,)).astype(np.float32)}
    for mode in ("conditional", "cosine"):
        cfg = MetaFasterRCNNRunner.get_default_cfg()
        cfg.merge_from_file(
            "sylph://LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-"
            + ("finetune" if mode == "conditional" else "pretrain") + ".yaml")
        cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = mode == "cosine"
        cfg.TPU.COMPUTE_DTYPE = "float32"
        grid = rcnn.build_anchor_grid((256, 256))
        kw = dict(rpn_post_nms=1000, score_thresh=1e-4, nms_thresh=0.5,
                  max_dets=100, rpn_pre_nms=1000)
        outs = []
        for dev in devices:
            model = build_rcnn_model_from_cfg(cfg, device=dev)
            args = (torch.as_tensor(images, device=dev),)
            rest = (torch.as_tensor(grid.anchors, device=dev),
                    grid.level_splits, torch.as_tensor(sizes, device=dev))
            with torch.inference_mode():
                if mode == "conditional":
                    bank = model.normalize_code(
                        {k: torch.as_tensor(v, device=dev)
                         for k, v in raw.items()})
                    det = model.forward_instances(*args, bank, *rest, **kw)
                    bank = bank["cls_conv"].cpu().numpy()
                else:
                    det = model.forward_base_instances(*args, *rest, **kw)
                    bank = None
            outs.append((bank, det.numpy()))
        (bg, dg), (bc, dc) = outs
        if bg is not None:
            np.testing.assert_allclose(bg, bc, rtol=0, atol=1e-5)
        n = []
        for i in range(len(images)):
            (cg, sg, xg), (cc, sc, xc) = _sorted_dets(dg, i), _sorted_dets(
                dc, i)
            if len(cg) != len(cc) or not len(cc):
                raise AssertionError(f"{mode} image {i}: {len(cg)} detections "
                                     f"on cuda, {len(cc)} on cpu")
            np.testing.assert_array_equal(cg, cc)
            np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-3)
            np.testing.assert_allclose(xg, xc, rtol=0, atol=0.05)
            n.append(len(cc))
        log(f"[rcnn-card-vs-cpu] {mode}: R-50 fp32 256x256, detections "
            f"{n} agree (boxes 0.05, scores 1e-3, classes equal)")


# ------------------------------------------------------ two-stage training
RCNN_LOSSES = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}


def _check_trained(what: str, runner, model, start, state, move, keep):
    """Every loss finite with the two-stage keys; only trainable tensors
    moved; some tensor under each prefix of ``move`` moved, none under
    ``keep``. -> the moved names."""
    for i, m in enumerate(runner.train_metrics):
        if not (RCNN_LOSSES <= set(m) <= RCNN_LOSSES | {"loss_snnl"}
                and all(np.isfinite(v) for v in m.values())):
            raise AssertionError(f"{what} step {i}: losses {m}")
    trainable = set(state.tx.names)
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, start[k])}
    if not moved <= trainable:
        raise AssertionError(f"{what}: frozen tensors moved: "
                             f"{sorted(moved - trainable)[:5]}")
    for prefix in move:
        if not any(k.startswith(prefix) for k in moved):
            raise AssertionError(f"{what}: {prefix} did not move")
    if keep and any(k.startswith(keep) for k in moved):
        raise AssertionError(f"{what}: one of {keep} moved")
    return moved


def _rcnn_train_window(what: str, runner, cfg, model):
    """One two-stage ``do_train`` as a main-path window, every NMS call
    recorded; -> (state, counts, one recorded call, peak GB). Requires one
    launch per micro-group and step, on the counting route, each equal to
    the twin."""
    torch.cuda.reset_peak_memory_stats()
    with NMSRecorder() as rec:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        _, state = runner.do_train(cfg, model)
        counts = read_counts(what)
        # ---- end of the main path
        call = rec.calls[-1]
    peak = peak_memory_gb()
    launches, routes = counts
    n_calls, shapes = rec.check(what)
    want = cfg.SOLVER.MAX_ITER * max(1, cfg.TPU.GRAD_ACCUM)
    if launches != want or n_calls != want or routes.get("count") != want:
        raise AssertionError(f"{what}: expected {want} NMS launches on the "
                             f"counting route, got {launches} ({routes}), "
                             f"{n_calls} calls")
    log(f"[{what}] {launches} NMS launches (B, K: {sorted(set(shapes))}), "
        f"counting route, each equal to the twin")
    return state, counts, call, peak


def roi_align_train_ms(model, cfg, images, backward: bool):
    """ROIAlign at P2-P5 of one image's ROI batch as the train step runs it
    (the first BATCH_SIZE_PER_IMAGE of its proposals): the forward's ms
    and, where the features take gradients, the backward's (forward and
    backward less forward); medians of 5 event-timed calls."""
    grid = train_anchor_grid(cfg)
    roi_batch = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    sizes = torch.tensor([list(cfg.TPU.TRAIN_CANVAS)], dtype=torch.int32,
                         device="cuda")
    with torch.no_grad():
        feats, logits, deltas = model.forward_rpn(images[:1])
        props, _, _ = rcnn.rpn_proposals(
            logits, deltas, torch.as_tensor(grid.anchors, device="cuda"),
            grid.level_splits, sizes,
            pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
            post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN)
    rois = props[0, :roi_batch]
    feats = [f.detach().requires_grad_(backward) for f in feats[:4]]
    ones = torch.ones(roi_batch, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(roi_batch, dtype=torch.long, device="cuda")

    def fwd():
        return multilevel_roi_align(feats, model.ROI_STRIDES, rois, ones,
                                    zeros, output_size=7)

    fwd_ms = time_ms(fwd, 1, warmup=1, rounds=5)
    if not backward:
        return fwd_ms, 0.0
    grad = torch.randn_like(fwd())
    both_ms = time_ms(lambda: torch.autograd.grad(fwd(), feats, grad), 1,
                      warmup=1, rounds=5)
    return fwd_ms, both_ms - fwd_ms


def _rcnn_line(mode, config, cfg, runner, counted, images, queries, card,
               peak, call, model, backward):
    """The ``train`` line of a two-stage run, with the RPN NMS (the
    recorded input, a CUDA-graph replay) and ROIAlign per step, and the
    RPN-train shape for the kernel line's ``shapes``."""
    line = _train_line(mode, cfg, runner, counted, images, card,
                       config=config)
    line["peak_memory_gb"] = peak
    args = call[0]
    b, k = args[1].shape
    case = check_two_stage_case(list(args[:4]), args[5], args[4],
                                f"RPN train B={b} K={k} M={args[5]}",
                                reps=10)
    if case["route"] != "count" or k != 8768:
        raise AssertionError(f"{mode}: RPN-train NMS at K={k}, route "
                             f"{case['route']}")
    groups = max(1, cfg.TPU.GRAD_ACCUM)
    fwd_ms, bwd_ms = roi_align_train_ms(model, cfg, queries, backward)
    n = cfg.SOLVER.IMS_PER_BATCH * cfg.MODEL.META_LEARN.QUERY_SHOT \
        if cfg.MODEL.META_LEARN.EPISODIC_LEARNING else cfg.SOLVER.IMS_PER_BATCH
    line.update(rpn_nms_launches_per_step=groups,
                rpn_nms_ms_per_step=case["ms"] * groups,
                rpn_nms_shape=[b, k, args[5]],
                roi_align_fwd_ms_per_step=fwd_ms * n,
                roi_align_bwd_ms_per_step=bwd_ms * n)
    log(f"[{mode}] batch {cfg.SOLVER.IMS_PER_BATCH}, GRAD_ACCUM {groups}: "
        f"median step {line['median_step_ms']:.1f} ms, "
        f"{line['images_per_s']:.1f} img/s, peak {peak:.2f} GB; RPN NMS "
        f"{line['rpn_nms_ms_per_step']:.3f} ms per step ({groups} launches "
        f"at B={b}); ROIAlign per step {line['roi_align_fwd_ms_per_step']:.1f}"
        f" ms forward, {line['roi_align_bwd_ms_per_step']:.1f} ms backward "
        f"({n} images x {cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE} ROIs)")
    return line, case


def _first_batch(loader):
    batch = next(loader)
    loader.close()
    return batch


def phase_rcnn_train_episodic(work: str, card: str):
    """Phase 14; -> (counts, the ``train`` line, the RPN-train shape)."""
    cfg = rcnn_train_cfg("episodic", 4)
    runner = MetaFasterRCNNRunner()
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state, counts, call, peak = _rcnn_train_window(
        "rcnn_train_episodic", runner, cfg, model)
    moved = _check_trained("rcnn_train_episodic", runner, model, start, state,
                           ("code_generator.", "rpn_head.", "box_head."),
                           ("backbone.", "fpn."))
    log(f"[rcnn-train-episodic] {len(moved)} tensors moved, backbone and FPN "
        "unchanged")
    check_resume(cfg, runner, state, work, label="rcnn-train-episodic")
    queries = _first_batch(runner._episodic_loader(cfg))["query_images"]
    e = cfg.SOLVER.IMS_PER_BATCH
    imgs = e * (cfg.MODEL.META_LEARN.SHOT + cfg.MODEL.META_LEARN.QUERY_SHOT)
    line, case = _rcnn_line("rcnn_episodic", "Meta-RCNN-FPN-finetune.yaml",
                            cfg, runner, 3, imgs, queries, card, peak, call,
                            model, backward=False)
    return counts, line, case


def phase_rcnn_train_pretrain(card: str):
    """Phase 15, pretraining; -> (counts, the ``train`` line, the RPN-train
    shape)."""
    cfg = rcnn_train_cfg("pretrain", 3)
    runner = MetaFasterRCNNRunner()
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state, counts, call, peak = _rcnn_train_window(
        "rcnn_train_pretrain", runner, cfg, model)
    _check_trained("rcnn_train_pretrain", runner, model, start, state,
                   ("backbone.", "fpn.", "rpn_head.", "box_head.cls_score."),
                   ())
    images = _first_batch(runner._pretrain_loader(cfg))["images"]
    line, case = _rcnn_line("rcnn_pretrain", "Meta-RCNN-FPN-pretrain.yaml",
                            cfg, runner, 2, cfg.SOLVER.IMS_PER_BATCH, images,
                            card, peak, call, model, backward=True)
    return counts, line, case


TFA_TRAINED = {"box_head.cosine_weight", "box_head.cosine_scale_param",
               "box_head.bbox_pred.weight", "box_head.bbox_pred.bias"}


def phase_rcnn_train_tfa(card: str):
    """Phase 15, the TFA-RCNN finetune; -> (counts, the ``train`` line)."""
    cfg = rcnn_train_cfg("pretrain", 2, tfa=True)
    runner = TFAFasterRCNNRunner()
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state, counts, _, peak = _rcnn_train_window("rcnn_train_tfa", runner,
                                                cfg, model)
    if set(state.tx.names) != TFA_TRAINED:
        raise AssertionError(f"TFA-RCNN trains {sorted(state.tx.names)}")
    _check_trained("rcnn_train_tfa", runner, model, start, state,
                   ("box_head.cosine_weight", "box_head.bbox_pred."), ())
    line = _train_line("rcnn_tfa", cfg, runner, 1, cfg.SOLVER.IMS_PER_BATCH,
                       card, config="Meta-RCNN-FPN-pretrain.yaml (TFA-RCNN)")
    line["peak_memory_gb"] = peak
    log(f"[rcnn-train-tfa] only {sorted(TFA_TRAINED)} moved; step "
        f"{line['median_step_ms']:.1f} ms, peak {peak:.2f} GB")
    return counts, line


class _Tap:
    """Records what ``rcnn.<name>`` returns, on the CPU, call by call."""

    def __init__(self, name: str):
        self.name, self.calls = name, []

    def __enter__(self):
        self.orig = getattr(rcnn, self.name)

        def tap(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append(tuple(t.cpu() for t in out))
            return out

        setattr(rcnn, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(rcnn, self.name, self.orig)


class _SharedProposals(_Tap):
    """Records each ``rpn_proposals`` result; given the reference run's,
    compares each call with it and, where the picks differ, hands the
    reference's proposals on, so that what follows starts from one
    proposal set."""

    def __init__(self, reference=None):
        super().__init__("rpn_proposals")
        self.reference, self.differed = reference, []

    def __enter__(self):
        super().__enter__()
        recording = getattr(rcnn, self.name)

        def shared(*args, **kwargs):
            out = recording(*args, **kwargs)
            if self.reference is None:
                return out
            i = len(self.calls) - 1
            mine, ref = self.calls[i], self.reference[i]
            if torch.equal(mine[2], ref[2]) and torch.allclose(
                    mine[0], ref[0], rtol=0, atol=1e-2):
                return out
            picks = int((mine[2] != ref[2]).sum() + (
                (mine[0] - ref[0]).abs().amax(-1) > 1e-2).sum())
            self.differed.append((i, picks))
            return tuple(t.to(out[0].device) for t in ref)

        setattr(rcnn, self.name, shared)
        return self


def _rcnn_train_small_cfg(episodic: bool):
    cfg = MetaFasterRCNNRunner.get_default_cfg()
    cfg.merge_from_file(
        "sylph://LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-"
        + ("finetune" if episodic else "pretrain") + ".yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.TRAIN_CANVAS = [256, 256]
    cfg.TPU.SUPPORT_CANVAS = [128, 128]
    cfg.TPU.MAX_GT_BOXES = 20
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.SOLVER.IMS_PER_BATCH = 2
    if episodic:
        # the finetune config clips gradients at 1.0, so its full LR moves
        # the parameters; pretraining keeps its warmup: from the flax init
        # the unnormalized heads read FPN maps of O(100), and the full LR
        # unclipped diverges within two steps
        cfg.SOLVER.WARMUP_ITERS = 0
    cfg.OUTPUT_DIR = ""
    return cfg


def phase_rcnn_train_card_vs_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 16. The CPU runs first and is the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for episodic in (True, False):
        mode = "episodic" if episodic else "pretrain"
        cfg = _rcnn_train_small_cfg(episodic)
        batch = _fixed_train_batch(episodic, tuple(cfg.TPU.TRAIN_CANVAS),
                                   tuple(cfg.TPU.SUPPORT_CANVAS),
                                   cfg.TPU.MAX_GT_BOXES)
        if not episodic:  # one image: the CPU's ROIAlign backward is slow
            batch = {k: v[:1] for k, v in batch.items()}
            cfg.SOLVER.IMS_PER_BATCH = 1
        runs, reference = [], None
        for dev in devices:
            runner = MetaFasterRCNNRunner(
                device=dev, draws=lambda it, g, m, d=dev:
                rcnn.SampleDraws.for_step(0, it, g, d, draw_device="cpu"))
            model = build_rcnn_model_from_cfg(cfg, device=dev, init="train")
            start = {k: v.clone() for k, v in model.state_dict().items()}
            state, _, _ = runner._common_train_setup(cfg, model)
            step = runner.make_train_step(cfg, model)
            b = batch_to_device(batch, dev)
            with _SharedProposals(reference) as props, \
                    _Tap("match_anchors") as anchors, \
                    _Tap("sample_rois") as rois:
                losses = [{k: float(v) for k, v in step(state, b)[1].items()}
                          for _ in range(2)]
            reference = props.calls
            runs.append((losses, anchors.calls, rois.calls, props.differed,
                         {k: v.detach().cpu()
                          for k, v in model.state_dict().items()},
                         set(state.tx.names),
                         {k: v.cpu() for k, v in start.items()}))
        (los_c, anc_c, roi_c, _, pc, train_c, start), \
            (los_g, anc_g, roi_g, differed, pg, _, _) = runs
        if differed:
            log(f"[rcnn-train-card-vs-cpu] {mode}: the card's proposals "
                f"differ from the CPU's in calls {differed} ((call, boxes "
                "that differ)); those calls continue from the CPU's "
                "proposals")
        for i, (a, c) in enumerate(zip(anc_g, anc_c)):
            if not (torch.equal(a[1], c[1]) and torch.equal(a[0], c[0])):
                raise AssertionError(f"{mode}: anchor labels of match {i} "
                                     "differ")
        for i, (a, c) in enumerate(zip(roi_g, roi_c)):
            if not (all(torch.equal(x, y) for x, y in zip(a[1:], c[1:]))
                    and torch.allclose(a[0], c[0], rtol=0, atol=1e-3)):
                raise AssertionError(f"{mode}: sampled ROIs of call {i} "
                                     "differ")
        for i, (a, c) in enumerate(zip(los_g, los_c)):
            for k in c:
                if not (np.isfinite(a[k])
                        and abs(a[k] - c[k]) <= 1e-3 * abs(c[k])):
                    raise AssertionError(f"{mode} step {i} {k}: cuda {a[k]} "
                                         f"cpu {c[k]}")
        worst = 0.0
        for k, v in pc.items():
            if k in train_c:
                worst = max(worst, float((pg[k] - v).abs().max()))
            elif not (torch.equal(pg[k], start[k]) and torch.equal(v,
                                                                   start[k])):
                raise AssertionError(f"{mode}: frozen {k} changed")
        if worst > 1e-4:
            raise AssertionError(f"{mode}: parameters differ by {worst}")
        n_pos = sum(int((c[1] == 1).sum()) for c in anc_c)
        log(f"[rcnn-train-card-vs-cpu] {mode}: {len(anc_c)} anchor matchings "
            f"({n_pos} positives) and {len(roi_c)} ROI samplings equal, "
            f"losses {[{k: round(v, 5) for k, v in s.items()} for s in los_g]}"
            f" within rtol 1e-3, trained parameters within {worst:.2e}, "
            f"frozen bit-identical")


# ------------------------------------------------ one-stage variants (17-20)
ROI_ENCODER = "MetaFCOSROIEncoderRunner"
TFA = "TFAFewShotDetectionRunner"
REQUEST_SIZES = [(480, 640), (800, 1216), (720, 1280), (1024, 768),
                 (600, 900)]
# the offset heads' gain in phases 19-20: offsets of a few pixels, so
# sampling is fractional and reaches across the maps' borders
OFFSET_GAIN = 4.0


def variant_serving_cfg(runner_name: str = "MetaFCOSRunner",
                        deformable: bool = False):
    """Phase 4's serving config for ``runner_name``'s shipped COCO config,
    DCNv2 towers with ``deformable``."""
    cls, config = ONE_STAGE[runner_name]
    cfg = cls.get_default_cfg()
    cfg.merge_from_file(config)
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.02
    cfg.MODEL.FCOS.USE_DEFORMABLE = deformable
    return cfg


@torch.no_grad()
def seed_offset_heads(model, seed: int) -> int:
    """Every DFConv2d's ``offset`` conv to seeded non-zero weights (fan-in
    scaled, times ``OFFSET_GAIN``); -> how many layers."""
    gen = torch.Generator().manual_seed(seed)
    n = 0
    for m in model.modules():
        if isinstance(m, DFConv2d):
            w = m.offset.weight
            w.copy_(torch.randn(w.shape, generator=gen) * OFFSET_GAIN
                    / math.sqrt(w[0].numel()))
            m.offset.bias.copy_(torch.randn(m.offset.bias.shape,
                                            generator=gen))
            n += 1
    return n


def offset_reach(model, canvas) -> dict:
    """One forward of the first deformable layer on ``canvas``: the share of
    its samples that fall between pixels and of those past the map's
    border."""
    layer = model.fcos_head.cls_tower.conv3
    seen = {}

    def keep_first(mod, inp, out):    # returns None: the output stays as is
        seen.setdefault("om", out.float())

    hook = layer.offset.register_forward_hook(keep_first)
    with torch.inference_mode():
        model.forward_base(canvas)
    hook.remove()
    om = seen["om"]                        # the first level, P3
    _, _, h, w = om.shape
    off = om[:, :2 * layer.k]
    t = torch.arange(layer.k, device=om.device)
    base_y = (torch.arange(h, device=om.device)[:, None]
              + (t // 3 - 1)[:, None, None])
    base_x = (torch.arange(w, device=om.device)[None, :]
              + (t % 3 - 1)[:, None, None])
    py, px = base_y + off[:, 0::2], base_x + off[:, 1::2]
    frac = ((py != py.floor()) | (px != px.floor())).float().mean()
    out = ((py < 0) | (py > h - 1) | (px < 0) | (px > w - 1)).float().mean()
    return {"fractional": float(frac), "past_border": float(out),
            "offset_abs_mean": float(off.abs().mean())}


def serve_and_check(pred: SylphPredictor, label: str, card: str):
    """Phase 4's main path for another predictor: register 3 classes at
    EVAL_SHOT, answer 5 requests on the host path, the last at
    INFERENCE_TH_TEST = 0 (K = 5000); each request's detections against
    the same dense outputs decoded with the twin. -> (counts, the ``serve``
    JSON line)."""
    rng = np.random.RandomState(0)
    shots = pred.cfg.MODEL.META_LEARN.EVAL_SHOT
    images = [random_image(rng, h, w) for h, w in REQUEST_SIZES]
    th = pred.decode_cfg.pre_nms_thresh

    def set_thresh(full_k):
        pred.decode_cfg = pred.decode_cfg._replace(
            pre_nms_thresh=0.0 if full_k else th)

    register(pred, rng, ["warm_up"], shots)        # cuDNN plans, the kernel
    pred(images[0])
    pred.bank = type(pred.bank)(pred.bank.capacity, device=pred.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts are read around this block alone
    reset_counts()
    reg_ms = register(pred, rng, ["class_a", "class_b", "class_c"], shots)
    results, lat_ms = [], []
    for i, img in enumerate(images):
        set_thresh(i == len(images) - 1)
        t0 = time.perf_counter()
        results.append(pred(img))
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts(label)
    # ---- end of the main path
    peak = peak_memory_gb()
    for i, (img, res) in enumerate(zip(images, results)):
        n = len(res["scores"])
        if not (np.isfinite(res["boxes"]).all()
                and np.isfinite(res["scores"]).all()
                and res["boxes"].shape == (n, 4)
                and set(res["class_names"]) <= {"class_a", "class_b",
                                                "class_c"}):
            raise AssertionError(f"{label}: malformed detections")
        if i == len(images) - 1 and n != pred.decode_cfg.post_nms_topk:
            raise AssertionError(f"{label}: the INFERENCE_TH_TEST=0 request "
                                 f"kept {n} detections")
        set_thresh(i == len(images) - 1)
        canvas, size, _ = pred.prepare(img)
        out = pred.dense(canvas)
        got = pred.decode(out, size, pred.bank.valid)
        want = pred.decode(out, size, pred.bank.valid, nms_impl="reference")
        check_detections_equal(got, want, f"{label} request {i}")
        log(f"[{label}] request {img.shape[0]}x{img.shape[1]}: "
            f"{lat_ms[i]:.1f} ms, {n} detections, equal to the twin")
    set_thresh(False)
    if counts[0] != len(images):
        raise AssertionError(f"{label}: {counts[0]} NMS launches for "
                             f"{len(images)} requests")
    med = float(np.median(lat_ms))
    line = {"serve": label, "batch": 1,
            "canvas": list(pred.eval_canvas), "median_request_ms": med,
            "request_ms": lat_ms, "images_per_s": 1e3 / med,
            "registration_ms_per_class": reg_ms, "shots": shots,
            "peak_memory_gb": peak, "card": card}
    log(f"[{label}] registration {', '.join(f'{t:.1f}' for t in reg_ms)} ms "
        f"a class ({shots} shots); median request {med:.1f} ms, peak "
        f"{peak:.2f} GB; {counts[0]} NMS launches")
    return counts, line


def _finite_losses(what: str, runner) -> None:
    for i, m in enumerate(runner.train_metrics):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{what} step {i}: non-finite loss {m}")


def _moved(model, start):
    return {k for k, v in model.state_dict().items()
            if not torch.equal(v, start[k])}


def phase_roi_encoder(work: str, card: str):
    """Phase 17: the ROIEncoder's serving, meta-test and episodic training
    at full width. -> ({path: counts}, the serve line, the train line,
    the training's counts)."""
    pred = SylphPredictor(cfg=variant_serving_cfg(ROI_ENCODER),
                          runner_name=ROI_ENCODER)
    serve_counts, serve_line = serve_and_check(pred, "roi_encoder_serve",
                                               card)
    serve_line["config"] = "Meta-FCOS-ROIEncoder/Meta-FCOS-finetune.yaml"
    del pred
    meta_counts, stats = phase_meta_test(work, ROI_ENCODER,
                                         "roi_encoder_meta_test")
    serve_line["meta_test"] = {
        name: {"codegen_ms_per_class": 1e3 * st["codegen_s"] / st["classes"],
               "query_images_per_s": st["query_images"] / st["query_s"]}
        for name, st in stats.items()}

    cfg = variant_train_cfg(ROI_ENCODER, 3)
    runner = create_runner(ROI_ENCODER)
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts are read around this block alone
    reset_counts()
    _, state = runner.do_train(cfg, model)
    train_counts = read_counts("roi_encoder_train")
    # ---- end of the main path
    _finite_losses("roi_encoder_train", runner)
    moved = _moved(model, start)
    if not moved <= set(state.tx.names):
        raise AssertionError("roi_encoder_train: frozen tensors moved")
    if any(k.startswith(("backbone.", "fpn.")) for k in moved):
        raise AssertionError("roi_encoder_train: the backbone moved")
    for prefix in ("code_generator.encoder_layer0.self_attn.",
                   "code_generator.tok_fc0.", "code_generator.weight_fc0.",
                   "code_generator.ms_cam."):
        if not any(k.startswith(prefix) for k in moved):
            raise AssertionError(f"roi_encoder_train: {prefix} did not move")
    e = cfg.SOLVER.IMS_PER_BATCH
    imgs = e * (cfg.MODEL.META_LEARN.SHOT + cfg.MODEL.META_LEARN.QUERY_SHOT)
    line = _train_line("roi_encoder_episodic", cfg, runner, 2, imgs, card,
                       config="Meta-FCOS-ROIEncoder/Meta-FCOS-finetune.yaml")
    line["dropout"] = cfg.MODEL.META_LEARN.CODE_GENERATOR \
        .TRANSFORMER_ENCODER.DROPOUT
    log(f"[roi-encoder-train] {e} episodes, GRAD_ACCUM {cfg.TPU.GRAD_ACCUM}, "
        f"dropout {line['dropout']}: median step "
        f"{line['median_step_ms']:.1f} ms, {line['images_per_s']:.1f} img/s, "
        f"peak {line['peak_memory_gb']:.2f} GB; {len(moved)} tensors moved, "
        f"backbone and FPN bit-identical")
    check_resume(cfg, runner, state, work, label="roi-encoder-train")
    return ({"roi_encoder_serve": serve_counts,
             "roi_encoder_meta_test": meta_counts}, serve_line, line,
            train_counts)


def _record_plain_decode():
    """Record every ``decode_proposals`` call of the plain evaluation;
    -> (the calls, a function that undoes it)."""
    recorded = []
    decode = runner_mod.decode_proposals

    def recording(*args, **kwargs):
        det = decode(*args, **kwargs)
        recorded.append((args, kwargs, det))
        return det

    runner_mod.decode_proposals = recording

    def undo():
        runner_mod.decode_proposals = decode
    return recorded, undo


def tfa_plain_test(runner, cfg, model, label: str):
    """The plain ``do_test`` of a TFA model on coco_meta_val_all as a
    main-path window: one NMS launch a query batch, each equal to the twin,
    a complete AP dict. -> counts."""
    cfg = cfg.clone()
    cfg.DATASETS.TEST = ["coco_meta_val_all"]
    cfg.TPU.EVAL_BATCH = 8
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.02
    recorded, undo = _record_plain_decode()
    try:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        t0 = time.perf_counter()
        results = runner.do_test(cfg, model)
        wall = time.perf_counter() - t0
        counts = read_counts(label)
        # ---- end of the main path
    finally:
        undo()
    name = "coco_meta_val_all"
    data = DatasetCatalog.get(name)
    n_query = len(data[-1])
    batches = -(-n_query // cfg.TPU.EVAL_BATCH)
    check_ap_dict(name, results[name]["bbox"],
                  data["metadata"]["thing_classes"], repeated=False)
    if counts[0] != batches or len(recorded) != batches:
        raise AssertionError(f"{label}: {counts[0]} NMS launches, "
                             f"{len(recorded)} decodes for {batches} batches")
    for i, (args, kwargs, det) in enumerate(recorded):
        want = runner_mod.decode_proposals(*args, **dict(
            kwargs, nms_impl="reference"))
        check_detections_equal(det, want, f"{label} batch {i}")
    log(f"[{label}] plain do_test on {name}: {n_query} images in {batches} "
        f"batches, {wall:.2f} s; AP {results[name]['bbox']['AP']:.4f}; each "
        f"of the {counts[0]} NMS launches equal to the twin")
    return counts


HEAD_BRANCH = ("fcos_head.cls_tower.", "fcos_head.bbox_tower.",
               "fcos_head.bbox_pred.", "fcos_head.ctrness.",
               "fcos_head.iou_overlap.")


def _tfa_train(what: str, cfg, card: str, config: str):
    """``do_train`` of a TFA config as a main-path window: no NMS launch,
    finite losses, the backbone, FPN, cls tower and bbox branch
    bit-identical. -> (runner, model, counts, moved, train line)."""
    runner = create_runner(TFA)
    model = runner.build_model(cfg, init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts are read around this block alone
    reset_counts()
    _, state = runner.do_train(cfg, model)
    counts = read_counts(what)
    # ---- end of the main path
    _finite_losses(what, runner)
    moved = _moved(model, start)
    if not moved <= set(state.tx.names):
        raise AssertionError(f"{what}: frozen tensors moved")
    if any(k.startswith(("backbone.", "fpn.") + HEAD_BRANCH) for k in moved):
        raise AssertionError(f"{what}: a frozen part moved: {sorted(moved)}")
    line = _train_line(what, cfg, runner, cfg.SOLVER.MAX_ITER - 1,
                       cfg.SOLVER.IMS_PER_BATCH, card, config=config)
    log(f"[{what}] batch {cfg.SOLVER.IMS_PER_BATCH}: median step "
        f"{line['median_step_ms']:.1f} ms, {line['images_per_s']:.1f} img/s, "
        f"peak {line['peak_memory_gb']:.2f} GB; moved {sorted(moved)}; "
        "backbone, FPN, cls tower and bbox branch bit-identical")
    return runner, model, counts, moved, line


def phase_tfa(work: str, card: str):
    """Phase 18: the TFA one-stage finetune from a seeded base-class model
    saved as a port checkpoint: the surgery, training and the plain
    evaluation, then the cosine head. -> ({path: counts}, [train lines],
    the training's counts)."""
    coco_tree(work)
    base_split = "coco_pretrain_train_base"
    base_ids = DatasetCatalog.get(base_split)["metadata"][
        "thing_dataset_id_to_contiguous_id"]
    cfg = variant_train_cfg(TFA, 3)
    base_cfg = cfg.clone()
    base_cfg.MODEL.FCOS.NUM_CLASSES = len(base_ids)
    base = build_model_from_cfg(base_cfg, init="train", seed=5)
    with torch.no_grad():   # base rows that differ from a fresh init's
        base.fcos_head.cls_logits.weight.normal_(
            0.0, 0.01, generator=torch.Generator(base.fcos_head.cls_logits
                                                 .weight.device)
            .manual_seed(6))
    path = os.path.join(work, "tfa_base.pt")
    torch.save({"step": 0, "model": {k: v.cpu() for k, v in
                                     base.state_dict().items()}}, path)
    base_w = base.fcos_head.cls_logits.weight.detach().cpu()
    base_b = base.fcos_head.cls_logits.bias.detach().cpu()
    del base
    cfg.MODEL.WEIGHTS = path
    cfg.DATASETS.BASE_CLASSES_SPLIT = base_split
    cur_ids = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])["metadata"][
        "thing_dataset_id_to_contiguous_id"]

    runner, model, train_counts, moved, line = _tfa_train(
        "tfa_train", cfg, card, "tfa-finetune.yaml")
    # the surgery, read back from a fresh build
    built = runner.build_model(cfg, init="train").fcos_head.cls_logits
    rows = 0
    for did, bi in base_ids.items():
        if did in cur_ids:
            ci = cur_ids[did]
            if not (torch.equal(built.weight[ci].cpu(), base_w[bi])
                    and torch.equal(built.bias[ci].cpu(), base_b[bi])):
                raise AssertionError(f"surgery: class {did} row {ci}")
            rows += 1
    if not rows or not any(k.startswith("fcos_head.cls_logits.")
                           for k in moved):
        raise AssertionError(f"surgery rows {rows}; cls_logits moved: "
                             f"{sorted(moved)}")
    log(f"[tfa] surgery: {rows} base rows equal the checkpoint's at the "
        "all-classes columns")
    counts = {"tfa_test": tfa_plain_test(runner, cfg, model, "tfa_test")}
    del model

    ccfg = variant_train_cfg(TFA, 2, cosine=True)
    ccfg.MODEL.WEIGHTS = path
    # the base checkpoint has a cls_logits head, which the cosine head
    # cannot take: the surgery is off (the JAX package fails there)
    ccfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS = False
    runner, model, cos_counts, moved, cos_line = _tfa_train(
        "tfa_cosine_train", ccfg, card, "tfa-finetune.yaml (cosine head)")
    head_moved = {k for k in moved if k.startswith("fcos_head.")}
    if not head_moved or not all(k.startswith("fcos_head.cosine_")
                                 for k in head_moved):
        raise AssertionError(f"tfa_cosine_train: head tensors moved "
                             f"{sorted(head_moved)}")
    counts["tfa_cosine_test"] = tfa_plain_test(runner, ccfg, model,
                                               "tfa_cosine_test")
    return (counts, [line, cos_line],
            (train_counts[0] + cos_counts[0], None))


def phase_dcn(work: str, card: str):
    """Phase 19: serving with DCNv2 towers, the offset heads at seeded
    non-zero weights, then one pretraining step. -> (counts, the serve
    line, the train line)."""
    pred = SylphPredictor(cfg=variant_serving_cfg(deformable=True))
    n = seed_offset_heads(pred.model, 7)
    canvas, _, _ = pred.prepare(random_image(np.random.RandomState(1), 800,
                                             1216))
    reach = offset_reach(pred.model, canvas)
    if reach["fractional"] < 0.9 or reach["past_border"] <= 0:
        raise AssertionError(f"dcn offsets: {reach}")
    log(f"[dcn] {n} deformable layers; at P3 {100 * reach['fractional']:.1f}"
        f"% of the samples fall between pixels, "
        f"{100 * reach['past_border']:.2f}% past the border (mean |offset| "
        f"{reach['offset_abs_mean']:.2f} px)")
    counts, line = serve_and_check(pred, "dcn_serve", card)
    line.update(config="Meta-FCOS-finetune.yaml + USE_DEFORMABLE",
                offsets=reach)
    del pred

    coco_tree(work)
    cfg = train_cfg("pretrain", 1)
    cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.GRAD_ACCUM = 16, 2   # micro-batches of 8
    cfg.MODEL.FCOS.USE_DEFORMABLE = True
    runner = MetaFCOSRunner()
    model = runner.build_model(cfg, init="train")
    seed_offset_heads(model, 8)
    state, _, _ = runner._common_train_setup(cfg, model)
    step = runner.make_train_step(cfg, model)
    batch = _first_batch(runner._pretrain_loader(cfg))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    losses = {k: float(v) for k, v in losses.items()}
    grads = [m.offset.weight.grad for m in model.modules()
             if isinstance(m, DFConv2d)]
    if not (all(np.isfinite(v) for v in losses.values())
            and all(g is not None and bool(torch.isfinite(g).all())
                    and bool(g.abs().sum() > 0) for g in grads)):
        raise AssertionError(f"dcn pretrain step: losses {losses}, offset "
                             "gradients not finite and non-zero")
    tline = {"train": "dcn_pretrain_step", "config":
             "Meta-FCOS-pretrain.yaml + USE_DEFORMABLE",
             "batch": cfg.SOLVER.IMS_PER_BATCH,
             "grad_accum": cfg.TPU.GRAD_ACCUM, "counted_steps": 1,
             "median_step_ms": ms, "images_per_s": cfg.SOLVER.IMS_PER_BATCH
             / (ms / 1e3), "peak_memory_gb": peak_memory_gb(),
             "losses": [losses], "card": card}
    log(f"[dcn-train] one pretrain step at batch {cfg.SOLVER.IMS_PER_BATCH} "
        f"({ms:.1f} ms, the first: cuDNN plans included): losses finite, "
        f"{len(grads)} offset heads with finite, non-zero gradients")
    return {"dcn_serve": counts}, line, tline


def _small_variant_cfg(runner_name: str, **opts):
    """Phase 5's card-vs-CPU setting (fp32, R-50 at a 256x256 canvas) for a
    variant."""
    cfg = variant_serving_cfg(runner_name, opts.pop("deformable", False))
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_CANVAS = [256, 256]
    cfg.TPU.SUPPORT_CANVAS = [128, 128]
    return cfg


def phase_variants_card_vs_cpu(devices=("cuda", "cpu")) -> None:
    """Phase 20 (fp32, TF32 off): the ROIEncoder's codes at eval (1e-5), the
    cosine head's and the DCN towers' dense outputs (phase 5's rtol 1e-3 /
    atol 5e-3), two ROIEncoder episodic steps at DROPOUT 0.0 (phase 7's
    limits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(12)
    sup = torch.as_tensor(rng.randint(0, 256, (6, 128, 128, 3)),
                          dtype=torch.uint8)
    boxes = torch.tensor([[8, 10, 90, 100], [20, 4, 120, 60],
                          [0, 0, 128, 128]] * 2, dtype=torch.float32)
    image = torch.as_tensor(rng.randint(0, 256, (1, 256, 256, 3)),
                            dtype=torch.uint8)
    outs = {}
    for dev in devices:
        roi = build_model_from_cfg(_small_variant_cfg(ROI_ENCODER),
                                   device=dev)
        with torch.inference_mode():
            codes = roi.forward_class_code(
                sup.to(dev), boxes.to(dev),
                torch.ones(6, dtype=torch.bool, device=dev), 3)
        del roi
        dense = []
        for runner_name, opts in ((TFA, {"MODEL.FCOS.L2_NORM_CLS_WEIGHT":
                                         True}),
                                  ("MetaFCOSRunner", {"deformable": True})):
            model = build_model_from_cfg(
                _small_variant_cfg(runner_name, **opts), device=dev)
            seed_offset_heads(model, 9)
            with torch.inference_mode():
                out = model.forward_base(image.to(dev))
            dense.append({k: getattr(out, k).cpu() for k in
                          ("logits", "reg", "ctrness", "iou")})
            del model
        outs[dev] = ({k: v.cpu() for k, v in codes.items()}, dense)
    (cg, dg), (cc, dc) = outs[devices[0]], outs[devices[1]]
    for k in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(cg[k].numpy(), cc[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"ROIEncoder {k}")
    worst = max(float((cg[k] - cc[k]).abs().max()) for k in cg)
    for what, a, b in zip(("cosine head", "DCN towers"), dg, dc):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=1e-3, atol=5e-3,
                                       err_msg=f"{what} {k}")
    log(f"[variants-card-vs-cpu] fp32: ROIEncoder codes within {worst:.2e} "
        "(1e-5), the cosine head's and the DCN towers' dense outputs within "
        "rtol 1e-3 / atol 5e-3")
    cfg = _train_small_cfg(True)
    cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TRANSFORMER_ENCODER.DROPOUT = 0.0
    phase_train_card_vs_cpu(devices, cases=[("roi_encoder episodic", cfg)])


# ------------------------------------------- data parallelism (21-23)
DP_WORLD = 2
DP_TIMEOUT = 600     # s, the children of phases 21-22 together
DP_NAME = "coco_meta_val_all"  # 6 classes: 3 a rank
DP_CLASS_BATCH = 2   # one rank: 3 calls; two: 2 + a padded 1 on each
TWO_SHARE = ("two ranks share one card over gloo: the times show the "
             "plumbing, not a speed-up")


def _exact_fp32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _dp_codes(model, group, dev="cuda"):
    """Raw codes of DP_NAME's classes, the dataset loaded under one seed:
    single-process without ``group``, sharded with it."""
    cfg = meta_test_cfg("")
    with temp_seed(0):
        data = DatasetCatalog.get(DP_NAME)
    ds = MetaDataset(data, "episodic_test_supportset",
                     num_shot=cfg.MODEL.META_LEARN.EVAL_SHOT)
    rank, world = (group.rank, group.world) if group else (0, 1)
    loader = build_support_set_loader(ds, _mapper(cfg), rank=rank,
                                      world_size=world)
    if group is None:
        return meta_eval.generate_class_codes(
            model, loader, class_batch=DP_CLASS_BATCH, device=dev)
    return meta_eval.generate_class_codes_sharded(
        model, loader, group, class_batch=DP_CLASS_BATCH, device=dev)


def _code_arrays(codes):
    return {c: {k: np.asarray(v) for k, v in d["code"].items()}
            for c, d in sorted(codes.items())}


def _fp32_meta_model():
    cfg = meta_test_cfg("")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return create_runner("MetaFCOSRunner").build_model(cfg)


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        h.update(name.encode())
        h.update(p.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _dp_train_cfgs(grad_accum_one: int, grad_accum_dp: int, rcnn: bool):
    """(one process's, each rank's) fp32 config of a two-step run."""
    cfgs = []
    for ga in (grad_accum_one, grad_accum_dp):
        cfg = (rcnn_train_cfg("episodic", 2) if rcnn
               else train_cfg("episodic", 2))
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.GRAD_ACCUM = ga
        cfgs.append(cfg)
    return cfgs


def run_ranks(work: str, name: str, timeout: float = DP_TIMEOUT, **args):
    """Start DP_WORLD children of this script through torchrun, each running
    ``CHILDREN[name](group, out, **args)`` as one rank (gloo, every rank on
    cuda:0); -> each rank's result. A child that fails, or a run past
    ``timeout``, raises; every process is ended."""
    out = os.path.join(work, "ranks", name)
    os.makedirs(out)
    torch.save(dict(args, work=work), os.path.join(out, "args.pt"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={DP_WORLD}", os.path.abspath(__file__),
           "--child", name, "--out", out]
    log_path = os.path.join(out, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = f"killed after {timeout} s"
    with open(log_path) as f:
        text = f.read()
    for line in text.splitlines():
        if line.startswith("[rank"):
            log(line)
    if rc != 0:
        log(text[-8000:])
        raise AssertionError(f"ranks of {name}: exit {rc}")
    log(f"[ranks] {name}: {DP_WORLD} ranks in "
        f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(DP_WORLD)]


def _rank_log(group, msg: str) -> None:
    log(f"[rank{group.rank}] {msg}")


def child_meta_test(group, work: str):
    """Phase 21 on one rank: fp32 sharded codes, then the bf16 meta-test
    with the sharded bank as a main-path window, every decode replayed with
    the twin."""
    _exact_fp32()
    coco_tree(work)
    codes = _code_arrays(_dp_codes(_fp32_meta_model(), group))
    cfg = meta_test_cfg(os.path.join(work, "dp_meta_test"))
    runner = create_runner("MetaFCOSRunner", group=group)
    model = runner.build_model(cfg)
    # warm-up: the bf16 registration and one query batch's plans
    _dp_codes(model, group)
    recorded = []
    decode = meta_eval.decode_proposals

    def recording(*args, **kwargs):
        det = decode(*args, **kwargs)
        recorded.append((args, kwargs, det))
        return det

    meta_eval.decode_proposals = recording
    try:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        results = runner.do_test(cfg, model)
        counts = read_counts(f"dp_meta_test rank {group.rank}")
        # ---- end of the main path
    finally:
        meta_eval.decode_proposals = decode
    for i, (args, kwargs, det) in enumerate(recorded):
        want = decode(*args, **dict(kwargs, nms_impl="reference"))
        check_detections_equal(det, want, f"rank {group.rank} batch {i}")
    stats = {name: dict(d.stats) for name, d in runner.drivers.items()}
    for name, res in results.items():
        meta = runner.drivers[name].dataset_dict["metadata"]
        check_ap_dict(name, res["bbox"], meta["thing_classes"])
    _rank_log(group, f"meta-test: {counts[0]} NMS launches, each equal to "
              f"the twin; {len(recorded)} decodes")
    return {"codes": codes, "counts": counts, "stats": stats,
            "results": {n: r["bbox"] for n, r in results.items()},
            "batches": len(recorded)}


def _train_result(group, runner, model, state):
    return {"losses": runner.train_metrics, "loop_times": runner.loop_times,
            "digest": _digest(model),
            "trainable": {n: p.detach().cpu() for n, p in
                          model.named_parameters() if n in state.tx.names},
            "peak_memory_gb": peak_memory_gb()}


def dp_resume(cfg, runner, state, group) -> str:
    """Rank 0's last checkpoint restored on this rank into a fresh model,
    bit-equal to the trained state; one step from each on the same batch:
    equal (1e-5)."""
    loader = runner._episodic_loader(cfg)
    batch = next(loader)
    loader.close()
    fresh = runner.build_model(cfg, init="train")
    resumed, _, _ = runner._common_train_setup(cfg, fresh)
    if resumed.step != state.step:
        raise AssertionError(f"restored step {resumed.step}, trained "
                             f"{state.step}")
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"restored {n} differs")
    step = state.step
    runner.make_train_step(cfg, state.model)(state, batch)
    runner.make_train_step(cfg, fresh)(resumed, batch)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(state.model.state_dict().values(),
                                fresh.state_dict().values()))
    worst_m = max(float((a - b).abs().max())
                  for a, b in zip(state.tx.trace, resumed.tx.trace))
    if worst > 1e-5 or worst_m > 1e-5:
        raise AssertionError(f"resumed step differs: params {worst}, "
                             f"momentum {worst_m}")
    return (f"rank 0's step-{step} checkpoint restored bit-equal, and "
            f"one more step equals the uninterrupted one (params within "
            f"{worst:.2e}, momentum within {worst_m:.2e})")


def _chunks(calls, n: int):
    """``calls`` cut into n equal runs (a micro-group's calls each)."""
    per = len(calls) // n
    if per * n != len(calls):
        raise AssertionError(f"{len(calls)} calls do not make {n} groups")
    return [calls[i * per:(i + 1) * per] for i in range(n)]


def child_train(group, work: str, episodic_cfg, rcnn_cfg, rcnn_reference):
    """Phase 22 on one rank: the one-stage episodic run and its resume,
    then the two-stage run, fp32, TF32 off."""
    _exact_fp32()
    coco_tree(work)
    lvis_tree(work)
    out = {}
    cfg = episodic_cfg.clone()
    cfg.OUTPUT_DIR = os.path.join(work, "dp_train")
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    runner = MetaFCOSRunner(group=group)
    model = runner.build_model(cfg, init="train")
    torch.cuda.reset_peak_memory_stats()
    _, state = runner.do_train(cfg, model)
    out["episodic"] = _train_result(group, runner, model, state)
    out["episodic"]["resume"] = dp_resume(cfg, runner, state, group)

    runner = MetaFasterRCNNRunner(group=group)
    model = runner.build_model(rcnn_cfg, init="train")
    torch.cuda.reset_peak_memory_stats()
    ref = [rcnn_reference[it * DP_WORLD + group.rank]
           for it in range(rcnn_cfg.SOLVER.MAX_ITER)]
    with _SharedProposals(ref) as props, _Tap("match_anchors") as anchors, \
            _Tap("sample_rois") as rois, NMSRecorder() as rec:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        _, state = runner.do_train(rcnn_cfg, model)
        counts = read_counts(f"dp_rcnn_train rank {group.rank}")
        # ---- end of the main path
    n_calls, shapes = rec.check(f"dp_rcnn_train rank {group.rank}")
    if counts[0] != n_calls or counts[0] != rcnn_cfg.SOLVER.MAX_ITER:
        raise AssertionError(f"rank {group.rank}: {counts} NMS launches, "
                             f"{n_calls} calls")
    _rank_log(group, f"two-stage: {counts[0]} RPN NMS launches {shapes}, "
              "each equal to the twin")
    out["rcnn"] = dict(_train_result(group, runner, model, state),
                       counts=counts, anchors=anchors.calls,
                       rois=rois.calls, differed=props.differed)
    return out


CHILDREN = {"meta_test": child_meta_test, "train": child_train}


def child_main(argv) -> int:
    """One rank of ``run_ranks``: torchrun's environment names it."""
    os.environ.pop("SYLPH_TEST_MODE", None)
    name = argv[argv.index("--child") + 1]
    out = argv[argv.index("--out") + 1]
    args = torch.load(os.path.join(out, "args.pt"), weights_only=False)
    group = create_mesh("cuda:0", backend="gloo")
    try:
        result = CHILDREN[name](group, **args)
        torch.save(result, os.path.join(out, f"rank{group.rank}.pt"))
    finally:
        group.close()
    return 0


def _close(a, b, what: str, atol: float) -> float:
    worst = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    if not worst <= atol:
        raise AssertionError(f"{what}: differs by {worst} (atol {atol})")
    return worst


def _check_losses(got, want, what: str, rtol: float = 1e-3) -> float:
    """-> the largest relative difference."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} steps, want {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            rel = abs(g[k] - w[k]) / abs(w[k])
            if not (np.isfinite(g[k]) and rel <= rtol):
                raise AssertionError(f"{what} step {i} {k}: {g[k]} vs {w[k]}")
            worst = max(worst, rel)
    return worst


def _same_results(a: dict, b: dict) -> bool:
    """Two {dataset: AP dict}s equal key for key, NaN (an AP with no ground
    truth) equal to NaN."""
    return a.keys() == b.keys() and all(
        a[n].keys() == b[n].keys() and all(
            x == y or (isinstance(x, float) and math.isnan(x)
                       and math.isnan(y)) for x, y in
            ((a[n][k], b[n][k]) for k in a[n])) for n in a)


def _dp_train_line(mode: str, config: str, cfg, ranks, key: str,
                   one_times, card: str):
    line = {"train": mode, "config": config, "world": DP_WORLD,
            "backend": "gloo", "batch": cfg.SOLVER.IMS_PER_BATCH,
            "grad_accum_per_rank": cfg.TPU.GRAD_ACCUM, "dtype": "float32",
            "one_process_step_ms": [1e3 * (d + s) for d, s in one_times],
            "note": TWO_SHARE, "card": card}
    for r, res in enumerate(ranks):
        times = res[key]["loop_times"]
        line[f"rank{r}"] = {
            "step_ms": [1e3 * (d + s) for d, s in times],
            "data_wait_ms": [1e3 * d for d, _ in times],
            "peak_memory_gb": res[key]["peak_memory_gb"]}
    line["losses"] = ranks[0][key]["losses"]
    return line


def phase_dp(work: str, card: str):
    """Phases 21-22: the references in this process, then one torchrun of
    DP_WORLD children per phase; -> (counts by path, the ``dp`` line, the
    ``train`` lines)."""
    _exact_fp32()
    coco_tree(work)
    lvis_tree(work)
    # ---- phase 21: the references, one process
    model = _fp32_meta_model()
    one = _code_arrays(_dp_codes(model, None))
    group = create_mesh("cuda:0", "nccl",
                        init_method="file://" + os.path.join(work, "nccl1"),
                        rank=0, world_size=1)
    try:
        nccl = _code_arrays(_dp_codes(model, group))
    finally:
        group.close()
    for c, code in one.items():
        for k, v in code.items():
            if not np.array_equal(nccl[c][k], v):
                raise AssertionError(f"NCCL world 1: class {c} {k} differs")
    log(f"[dp-meta-test] {DP_NAME}: {len(one)} classes; NCCL at world 1 "
        "through generate_class_codes_sharded equals the one process "
        "exactly (fp32)")
    del model
    cfg = meta_test_cfg("")
    single_model = create_runner("MetaFCOSRunner").build_model(cfg)
    _dp_codes(single_model, None)  # warm-up
    st = {}
    with temp_seed(0):
        data = DatasetCatalog.get(DP_NAME)
    ds = MetaDataset(data, "episodic_test_supportset",
                     num_shot=cfg.MODEL.META_LEARN.EVAL_SHOT)
    meta_eval.generate_class_codes(
        single_model, build_support_set_loader(ds, _mapper(cfg)),
        class_batch=cfg.TPU.CLASS_BATCH, stats=st)
    single_ms = 1e3 * (st["support_wait_s"] + st["codegen_s"]) / st["classes"]
    single_codegen_ms = 1e3 * st["codegen_s"] / st["classes"]
    del single_model
    torch.cuda.empty_cache()

    ranks = run_ranks(work, "meta_test")
    code_err = 0.0
    for r, res in enumerate(ranks):
        for c, code in one.items():
            for k, v in code.items():
                got = res["codes"][c][k]
                code_err = max(code_err, float(np.abs(got - v).max()))
                if not np.allclose(got, v, rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"rank {r} class {c} {k}: "
                                         f"{np.abs(got - v).max()}")
                if not np.array_equal(got, ranks[0]["codes"][c][k]):
                    raise AssertionError(f"rank {r}'s bank differs from "
                                         "rank 0's")
        if not _same_results(res["results"], ranks[0]["results"]):
            raise AssertionError(f"rank {r}'s AP dicts differ from rank 0's")
    dp_counts = {"dp_meta_test": (
        sum(r["counts"][0] for r in ranks),
        {k: sum(r["counts"][1][k] for r in ranks)
         for k in ranks[0]["counts"][1]})}
    shard = [sum(s["support_wait_s"] + s["codegen_s"] + s["gather_s"]
                 for s in r["stats"].values()) for r in ranks]
    classes = sum(s["classes"] for r in ranks for s in r["stats"].values())
    gather_ms = [1e3 * sum(s["gather_s"] for s in r["stats"].values())
                 for r in ranks]
    codegen = [sum(s["codegen_s"] for s in r["stats"].values())
               for r in ranks]
    dp_line = {"dp": "meta_test", "config": os.path.basename(CONFIG),
               "world": DP_WORLD, "backend": "gloo", "dtype": "bfloat16",
               "datasets": sorted(ranks[0]["results"]),
               "nms_launches": dp_counts["dp_meta_test"][0],
               "nms_launches_by_rank": [r["counts"][0] for r in ranks],
               "ms_per_class_single": single_ms,
               "ms_per_class_sharded": 1e3 * max(shard) / classes,
               "codegen_ms_per_class_single": single_codegen_ms,
               "codegen_ms_per_class_sharded": 1e3 * max(codegen) / classes,
               "all_gather_ms": gather_ms, "note": TWO_SHARE, "card": card}
    log(f"[dp-meta-test] world 2 over gloo: codes within {code_err:.2e} of "
        f"the one process (fp32; limit rtol 1e-4 / atol 1e-5), the banks and "
        f"AP dicts of both "
        f"ranks identical; bf16 meta-test {dp_line['nms_launches']} NMS "
        f"launches, each equal to the twin; registration "
        f"{single_ms:.2f} ms/class alone, "
        f"{dp_line['ms_per_class_sharded']:.2f} sharded, all-gather "
        f"{gather_ms} ms ({TWO_SHARE})")

    # ---- phase 22: the references, one process
    ep_one, ep_dp = _dp_train_cfgs(16, 8, rcnn=False)
    runner = MetaFCOSRunner()
    model = runner.build_model(ep_one, init="train")
    _, state = runner.do_train(ep_one, model)
    ep_ref = (runner.train_metrics,
              {n: p.detach().cpu() for n, p in model.named_parameters()
               if n in state.tx.names})
    ep_times = runner.loop_times
    del runner, model, state
    rc_one, rc_dp = _dp_train_cfgs(DP_WORLD, 1, rcnn=True)
    runner = MetaFasterRCNNRunner()
    model = runner.build_model(rc_one, init="train")
    with _SharedProposals() as props, _Tap("match_anchors") as anchors, \
            _Tap("sample_rois") as rois:
        _, state = runner.do_train(rc_one, model)
    rc_ref = (runner.train_metrics,
              {n: p.detach().cpu() for n, p in model.named_parameters()
               if n in state.tx.names}, anchors.calls, rois.calls)
    rc_times = runner.loop_times
    del runner, model, state
    torch.cuda.empty_cache()

    ranks = run_ranks(work, "train", episodic_cfg=ep_dp,
                      rcnn_cfg=rc_dp, rcnn_reference=props.calls)
    lines = []
    for key, (losses, params), cfg in (
            ("episodic", ep_ref, ep_dp), ("rcnn", rc_ref[:2], rc_dp)):
        if ranks[0][key]["digest"] != ranks[1][key]["digest"]:
            raise AssertionError(f"{key}: the ranks' parameters differ")
        rel = _check_losses(ranks[0][key]["losses"], losses, f"dp {key}")
        worst = max(_close(ranks[0][key]["trainable"][n], p, f"dp {key} {n}",
                           1e-4) for n, p in params.items())
        log(f"[dp-train] {key}: world 2 x GRAD_ACCUM {cfg.TPU.GRAD_ACCUM} "
            f"against one process x {cfg.TPU.GRAD_ACCUM * DP_WORLD}: losses "
            f"within {rel:.2e} relative (limit 1e-3), trained parameters "
            f"within {worst:.2e} (limit 1e-4), both ranks' parameters "
            "bit-identical")
    # rank r's step ``it`` is the one process's group it * DP_WORLD + r
    steps = rc_dp.SOLVER.MAX_ITER
    _, _, anc_one, roi_one = rc_ref
    for r, res in enumerate(ranks):
        rc = res["rcnn"]
        if rc["differed"]:
            log(f"[dp-train] rank {r}: proposals differ from the one "
                f"process's in calls {rc['differed']}; those calls continue "
                "from its proposals")
        for mine, want, what in ((rc["anchors"], anc_one, "anchor labels"),
                                 (rc["rois"], roi_one, "sampled ROIs")):
            want = _chunks(want, steps * DP_WORLD)
            for it, calls in enumerate(_chunks(mine, steps)):
                ref = want[it * DP_WORLD + r]
                if len(calls) != len(ref) or not all(
                        torch.equal(x, y) for c, w in zip(calls, ref)
                        for x, y in zip(c, w)):
                    raise AssertionError(f"rank {r} step {it}: {what} "
                                         "differ")
    log(f"[dp-train] two-stage: anchor labels and sampled ROI sets of every "
        "rank and step equal the one process's group's")
    dp_counts["dp_rcnn_train"] = (
        sum(r["rcnn"]["counts"][0] for r in ranks),
        {k: sum(r["rcnn"]["counts"][1][k] for r in ranks)
         for k in ranks[0]["rcnn"]["counts"][1]})
    for r, res in enumerate(ranks):
        log(f"[dp-train] rank {r}: {res['episodic']['resume']}")
    lines.append(_dp_train_line("dp_episodic", os.path.basename(CONFIG),
                                ep_dp, ranks, "episodic", ep_times, card))
    lines.append(_dp_train_line("dp_rcnn_episodic",
                                "Meta-RCNN-FPN-finetune.yaml", rc_dp, ranks,
                                "rcnn", rc_times, card))
    return dp_counts, dp_line, lines


def phase_registration(card: str):
    """Phase 23: ``bench_registration`` on the card, bf16: 1203 classes at
    CLASS_BATCH and 64 one per call; -> the ``registration`` line."""
    result = bench_registration.main(["--classes", "1203", "--single"])
    line = {"registration": "bench_registration", **result, "card": card}
    log(f"[registration] 1203 classes: {result['ms_per_class']:.3f} ms per "
        f"class at {result['class_batch']} per call, "
        f"{result['ms_per_class_single']:.3f} one per call")
    return line


def main() -> int:
    os.environ.pop("SYLPH_TEST_MODE", None)  # it would cut the query set
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    serve_counts, timing = phase_serving()
    phase_card_vs_cpu()
    # the meta-test's and training's files live in a scratch directory
    work = tempfile.mkdtemp(prefix="sylph_meta_test_")
    try:
        meta_counts, meta_timing = phase_meta_test(work)
        phase_train_card_vs_cpu()
        train_counts, episodic_line = phase_train_episodic(work, card)
        pre_counts, pretrain_line = phase_train_pretrain(card)
        shapes = phase_nms_two_stage()
        rcnn_counts, rcnn_line = phase_rcnn_meta_test(work)
        plain_counts, plain_part = phase_rcnn_plain(work)
        phase_rcnn_card_vs_cpu()
        ep_counts, ep_line, ep_case = phase_rcnn_train_episodic(work, card)
        rpre_counts, rpre_line, rpre_case = phase_rcnn_train_pretrain(card)
        tfa_counts, tfa_line = phase_rcnn_train_tfa(card)
        phase_rcnn_train_card_vs_cpu()
        t0 = time.perf_counter()
        roi_counts, roi_serve, roi_train, roi_train_counts = \
            phase_roi_encoder(work, card)
        tfa1_counts, tfa1_lines, tfa1_train_counts = phase_tfa(work, card)
        dcn_counts, dcn_serve, dcn_train = phase_dcn(work, card)
        phase_variants_card_vs_cpu()
        log(f"[time] phases 17-20: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_counts, dp_line, dp_train_lines = phase_dp(work, card)
        registration_line = phase_registration(card)
        log(f"[time] phases 21-23: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[time] every phase, the builds included: "
        f"{time.perf_counter() - t_start:.1f} s")
    shapes += [ep_case, rpre_case]

    # every main-path window's reading: (launches, launches by route)
    counts = {"serve": serve_counts, "meta_test": meta_counts, **rcnn_counts,
              "rcnn_plain": plain_counts, "rcnn_train_episodic": ep_counts,
              "rcnn_train_pretrain": rpre_counts, "rcnn_train_tfa": tfa_counts,
              **roi_counts, **tfa1_counts, **dcn_counts, **dp_counts}
    by_path = {path: n for path, (n, _) in counts.items()}
    if min(by_path.values()) < 1:
        raise AssertionError(f"a path never launched the NMS kernel: "
                             f"{by_path}")
    train_launches = (train_counts[0] + pre_counts[0] + roi_train_counts[0]
                      + tfa1_train_counts[0])
    if train_launches:
        raise AssertionError("one-stage training launched the NMS kernel")
    by_route = {r: sum(routes[r] for _, routes in counts.values())
                for r in nms_kernel.LAUNCHES_BY_ROUTE}
    if sum(by_route.values()) != sum(by_path.values()):
        raise AssertionError(f"launches by route {by_route} do not add up to "
                             f"those by path {by_path}")
    kernels = [dict(name="nms", route="cuda",
                    source="sylph_tpu_torch/csrc/nms.cu",
                    replaces="sylph_tpu/ops/nms_pallas.py:96",
                    launches=sum(by_path.values()),
                    launches_by_path=by_path,
                    launches_by_route=by_route,
                    launches_on_one_stage_train_paths=train_launches,
                    max_abs_err=max_err,
                    library_ms=None, **timing, **meta_timing,
                    shapes=shapes)]
    rcnn_line["plain"] = plain_part
    rcnn_line["card"] = card
    print(json.dumps(episodic_line), flush=True)
    print(json.dumps(pretrain_line), flush=True)
    for line in (ep_line, rpre_line, tfa_line, roi_serve, roi_train,
                 *tfa1_lines, dcn_serve, dcn_train, *dp_train_lines, dp_line,
                 registration_line):
        print(json.dumps(line), flush=True)
    print(json.dumps(rcnn_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv) if "--child" in sys.argv else main())
