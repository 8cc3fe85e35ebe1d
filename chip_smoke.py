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
  5. card against CPU: the same predictor in float32 (its weights held in
     float32 on the card too) at a 256x256 canvas on cuda and on cpu; dense outputs to rtol 1e-3 / atol 5e-3, detections
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
 24. the quality loop: ``tools/quality_loop.py --family fcos_heldout
     --hard`` at the recipe's width (R-18, FPN 256, 1-conv towers, 128x128
     canvas, 64x64 supports, float32; artifacts/quality_loop_fcos_heldout)
     cut to 100 + 100 iterations and REPEAT_TEST 1, on the hard 18-class
     synthetic set it writes: a base pretrain, its ``base_pretrain.npz``,
     the frozen-backbone episodic finetune on the base classes, the
     meta-test on the novel, base and all splits. Both stages'
     ``config_diff.yaml`` equal the recorded recipe's but for the cut and
     the paths, the loss falls over each stage, bAP is above 0, and every
     NMS launch (each evaluation's) equals the twin; one ``quality`` line
     with the AP, each stage's times and idle share, and the kernel's time
     at each shape the loop gave it;
 25. the repo's benchmark drivers at full width: ``tools/bench.py`` (the
     root bench.py's query path: R-50, bf16 parameters, batch 48 at
     768x1280, the normalized 20-class bank; 5 + 30 calls, then code
     generation one class and 8 classes a call), ``tools/
     bench_stage_breakdown.py`` at batch 16, ``entry.entry()`` once (512x512,
     the zero bank: NMS over K = 4320) and ``tools/bench_train.py`` at its
     defaults with 3 timed steps. Each driver's NMS launches are counted
     around it alone (35, 21 and 1; training 0) and every one is held
     against the twin afterwards (``tools/nms_audit.py``); the kernel is
     timed at each new shape, and at B = 4 (the probes' batch) on the first
     four images of the breakdown's input. bench.py's normalized bank leaves
     nothing alive at B = 48 on random weights, so one more query call on
     its model and images with the breakdown's random bank (every candidate
     alive) holds the kernel against the twin at B = 48, K = 5000 on live
     candidates, outside the counted windows. One ``bench`` line: img/s, ms a
     batch, GFLOP an image and the share of the card's dense bf16 peak,
     codegen ms a class, the stage ms, train episodes/s, peak memory, the
     card;
 26. the repeat check: ``tools/repeat_steps.py``'s training steps, three at
     full width (phase 15's two-stage pretraining step, phase 14's episodic
     one and phase 8's one-stage episodic one) and the ``tfa_rcnn`` quality
     recipe's pretraining step (R-18 at 128x128), each run twice from one
     saved train state and one batch of its loader: the sha256 of every
     parameter, momentum and EMA leaf equal after both runs, every uniform
     the sampling drew on the card equal to the CPU generator's stream for
     its seed, every RPN NMS launch equal to the twin. One ``repeat`` line:
     each step's digest, ms a step as shipped and with cuDNN left free
     (``repeat_steps.free_kernels``), and the draws' cost (B x K uniforms
     on the CPU plus the copy, against the same draw on the card);
 27. the config switches: ``TPU.STEPS_PER_CALL`` (phase 8's one-stage
     episodic step and phase 15's two-stage pretraining step, each over the
     same 4 loader batches from one saved state as 4 calls of one step and
     as 2 calls of two: the sha256 of the parameters, momentum and EMA and
     the 4 metric rows equal, every RPN NMS launch equal to the twin, ms a
     step both ways; ``tools/bench_train.py --steps-per-call 2``);
     ``TPU.S2D_STEM`` (R-50 at 1024x1344, the 7x7 model's
     weights carried to the s2d one by ``merge_state_dict``: in float32
     with TF32 off, dense outputs and detections within phase 5's limits;
     in bf16 both served as phase 17 serves, each launch equal to the twin,
     dense outputs within 5% of their range; the stem conv's ms both ways
     at B = 1, 1024x1344 and B = 48, 768x1280); ``TPU.EVAL_BF16_RESIDENT``
     (``SylphPredictor`` under the default config holds every floating
     weight in bf16 and its bank in float32; its requests against the
     float32-held predictor on the same weights within
     tests/test_torch_bf16.py's limits, each served as phase 17 serves,
     with ms a request and peak memory both ways, then both side by side
     in turns (f32, bf16, bf16, f32, f32, bf16) for ms a request free of
     the order; phase 8's episodic
     training for 2 steps with an evaluation after the first, EMA on,
     equal by sha256 to the same run without it, the evaluation on bf16
     weights and the weights float32 before and after); and one dilation-2
     ``DFConv2d`` on the card against the CPU (phase 20's limits). One
     ``switches`` line;
 28. the ROIAlign kernel (``csrc/roi_align.cu``) against its plain twin
     (``multilevel_roi_align_plain``), max |kernel - twin| within 1e-5 x
     max |map| (float32 sums of at most 64 taps in another order): the
     two-stage query shape (a real RPN's 1000 proposals of the second image
     of a 1024x1344 batch, bf16 P2-P5 as per-image slices), registration's
     (80 supports at 384x384, the FCOS levels P3-P7), the ROIEncoder's (10
     supports), and edges on seeded maps (degenerate, inverted, off-map and
     invalid boxes, ``sampling_ratio`` 2, float32 maps, one-level
     ``roi_align``); the training path's map gradients (bf16 and float32
     maps, 512 ROIs of per-image slices) bit-equal to the twin's; the
     launch and ROI counts after ``roi_forward`` and a registration call;
     the kernel's time (CUDA-graph replays, level assignment included)
     beside its bound (the outputs and the assigned levels' maps, once)
     and the twin's at the query and registration shapes; and the share of
     the kernel's traced time that the profiler ties to the
     ``sylph.roi_align`` span around it. One ``roi_align`` line.

The last lines are the card's ``name, power.limit``, one JSON object
listing every kernel with its launches (in all, by path and by ranking
route), error and times (``earlier_ms``: the first design's time on the
serving path's NMS input; ``meta_test_ms``: the kernel on a B=8 meta-test
batch; ``shapes``: phase 10's cases and the RPN-train inputs of phases
14-15; ``launches_by_path`` counts the ranks' launches of phases 21-22 as
``dp_meta_test`` and ``dp_rcnn_train``, phase 24's as
``quality_fcos_heldout``, phase 25's as ``bench``, ``bench_stages``
and ``entry``, phase 26's as ``repeat``, and phase 27's as
``switches_k_steps`` and ``switches_{7x7,s2d,f32_held,bf16_held}_serve``),
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
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
from sylph_tpu_torch.ops.roi_align import (assign_levels,
                                           multilevel_roi_align,
                                           multilevel_roi_align_plain,
                                           roi_align, roi_align_plain)
from sylph_tpu_torch.ops import nms_kernel, roi_align_kernel
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
from sylph_tpu_torch.entry import entry
from sylph_tpu_torch.tools import (bench, bench_registration,
                                   bench_stage_breakdown, bench_train,
                                   quality_loop, repeat_steps)
from sylph_tpu_torch.tools.bench_common import (CANVAS, N_CLASSES,
                                                QueryPath, query_images,
                                                random_bank)
from sylph_tpu_torch.tools.quality_loop import card_line
from sylph_tpu_torch.tools.nms_audit import (HBM_BYTES_PER_S, NMSAudit,
                                             nms_bound_ms, time_ms)
from sylph_tpu_torch.tools.profile_meta_test import DATA as META_TEST_DATA
from sylph_tpu_torch.tools.profile_meta_test import (ONE_STAGE, RCNN_DATA,
                                                     meta_test_cfg,
                                                     rcnn_meta_test_cfg)
from sylph_tpu_torch.tools.profile_train import (rcnn_train_cfg, train_cfg,
                                                 variant_train_cfg)
from sylph_tpu_torch.models.resnet import stem_kernel_from_s2d
from sylph_tpu_torch.train import steps as train_steps
from sylph_tpu_torch.train.checkpoint import (CheckpointManager,
                                              merge_state_dict)
from sylph_tpu_torch.utils.events import peak_memory_gb
from sylph_tpu_torch.utils.precision import eval_resident

CONFIG = "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml"
ADVERSARIAL = ("identical_boxes", "no_overlap", "dense_clusters",
               "chunk_boundary_ties", "signed_zeros")


def log(msg: str) -> None:
    print(msg, flush=True)


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
    cfg.TPU.EVAL_BF16_RESIDENT = False  # float32-held on the card too
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


def roi_align_cost(model, images, sizes, cfg,
                   pool=multilevel_roi_align):
    """ROIAlign of one image's proposals at P2-P5 (as ``roi_forward`` runs
    it) by ``pool`` (the kernel's dispatch, or the twin): ms on the card
    (median of 5 event-timed calls) and the peak memory it adds, in GB."""
    grid = eval_anchor_grid(cfg)
    with torch.inference_mode():
        feats, logits, deltas = model.forward_rpn(images[:1])
        props, _, valid = rcnn.rpn_proposals(
            logits, deltas, torch.as_tensor(grid.anchors, device="cuda"),
            grid.level_splits, sizes[:1],
            pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST)

        def call():
            return pool(
                feats[:4], model.ROI_STRIDES, props[0], valid[0],
                torch.zeros(props.shape[1], dtype=torch.long,
                            device="cuda"),
                output_size=7)

        ms = time_ms(call, 1, warmup=1, rounds=5)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
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
    # normalized as do_test normalized them: on the weights the config
    # holds for evaluation (bf16 on the card by default)
    with eval_resident(cfg, model):
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
    twin_ms, twin_gb, _ = roi_align_cost(model, images, sizes, cfg,
                                         multilevel_roi_align_plain)
    log(f"[rcnn] ROIAlign of {n_props} proposals at P2-P5: kernel "
        f"{ra_ms:.3f} ms, +{ra_gb:.3f} GB peak; twin {twin_ms:.2f} ms, "
        f"+{twin_gb:.2f} GB")
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
        "roi_align_peak_gb_per_image": ra_gb,
        "roi_align_twin_ms_per_image": twin_ms,
        "roi_align_twin_peak_gb_per_image": twin_gb}
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
                rcnn.SampleDraws.for_step(0, it, g, d))
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
    cfg.TPU.EVAL_BF16_RESIDENT = False  # float32-held on the card too
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


# ------------------------------------------------------- quality loop
QUALITY_ITERS = 100   # a stage; the recipe's is 600
QUALITY_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "artifacts", "quality_loop_fcos_heldout")
# what the cut changes in config_diff.yaml besides the paths: MAX_ITER and
# the schedule scaled with it by _common_shrink, and REPEAT_TEST 5 -> 1
QUALITY_CUT = {("SOLVER", "MAX_ITER"): QUALITY_ITERS,
               ("SOLVER", "STEPS"): [int(QUALITY_ITERS * 0.8)],
               ("SOLVER", "WARMUP_ITERS"): min(50, QUALITY_ITERS // 4),
               ("TEST", "REPEAT_TEST"): None}


def _recipe_diff(path: str, cut: bool):
    """A config_diff.yaml without its paths; with ``cut``, the cut's keys
    checked against QUALITY_CUT and dropped."""
    import yaml

    with open(path) as f:
        diff = yaml.safe_load(f)
    diff.pop("OUTPUT_DIR", None)
    diff.get("MODEL", {}).pop("WEIGHTS", None)
    for (section, key), value in QUALITY_CUT.items():
        got = diff.get(section, {}).pop(key, None)
        if cut and got != value:
            raise AssertionError(f"{path}: {section}.{key} is {got}, the cut "
                                 f"gives {value}")
    return {k: v for k, v in diff.items() if v != {}}


def phase_quality(work: str, card: str):
    """Phase 24: ``tools/quality_loop.py`` fcos_heldout at the recipe's
    width (R-18, FPN 256, 1-conv towers, 128x128 canvas, 64x64 supports,
    float32) on the hard 18-class set, cut to QUALITY_ITERS + QUALITY_ITERS
    iterations and REPEAT_TEST 1. Both stages' config_diff.yaml equal the
    recorded recipe's but for the cut and the paths; the loss falls over
    each stage; bAP is above 0; every NMS launch equals the twin (the
    driver's audit). -> (counts, the ``quality`` line)."""
    out = os.path.join(work, "quality_fcos_heldout")
    args = quality_loop.parse_args(
        ["--family", "fcos_heldout", "--hard", "--iters", str(QUALITY_ITERS),
         "--repeat-test", "1", "--data-root",
         os.path.join(work, "quality_hard"), "--output-dir", out])
    # ---- the main path: counts are read around this block alone
    reset_counts()
    t0 = time.perf_counter()
    results = quality_loop.train_and_score(args)
    wall = time.perf_counter() - t0
    counts = read_counts("quality_fcos_heldout")
    # ---- end of the main path
    quality_loop.report(args, results)   # times the kernel per shape
    with open(os.path.join(out, "run_stats.json")) as f:
        stats = json.load(f)
    audited = sum(stats["nms"]["launches_by_label"].values())
    if audited != counts[0] or counts[0] < 1:
        raise AssertionError(f"quality: {counts[0]} NMS launches, the audit "
                             f"held {audited} against the twin")
    for stage, recorded in (("pretrain/config_diff.yaml",
                             "pretrain_config_diff.yaml"),
                            ("config_diff.yaml", "config_diff.yaml")):
        got = _recipe_diff(os.path.join(out, stage), cut=True)
        want = _recipe_diff(os.path.join(QUALITY_RECIPE, recorded),
                            cut=False)
        if got != want:
            raise AssertionError(f"quality: {stage} != the recorded recipe's "
                                 f"{recorded}: {got} vs {want}")
    for s in stats["stages"]:
        if not s["loss_last"] < s["loss_first"]:
            raise AssertionError(f"quality: the {s['stage']} loss did not "
                                 f"fall: {s['loss_first']:.4f} -> "
                                 f"{s['loss_last']:.4f}")
    allb = results["coco_meta_val_all"]["bbox"]
    if not allb["bAP"] > 0:
        raise AssertionError(f"quality: bAP {allb['bAP']}")
    line = {"quality": "fcos_heldout", "iters": QUALITY_ITERS,
            "AP": allb["AP"], "nAP": allb["nAP"], "bAP": allb["bAP"],
            "base_pretrain_AP": stats["stages"][0]["ap"][
                "coco_pretrain_val_base"],
            "wall_s": wall, "nms_launches": counts[0],
            "stages": [{k: s[k] for k in (
                "stage", "train_s", "train_parts", "profiler_s", "test_s",
                "median_step_ms", "median_data_wait_ms", "loss_first",
                "loss_last", "profile")} for s in stats["stages"]],
            "nms_shapes": [{k: v for k, v in row.items()
                            if k != "launches_by_label"}
                           for row in stats["nms"]["shapes"]],
            "card": card}
    log(f"[quality] fcos_heldout {QUALITY_ITERS} + {QUALITY_ITERS} its in "
        f"{wall:.1f} s: AP {allb['AP']:.2f}, nAP {allb['nAP']:.2f}, bAP "
        f"{allb['bAP']:.2f}; every one of the {counts[0]} NMS launches "
        f"equal to the twin; config_diff.yaml equal to {QUALITY_RECIPE}'s "
        f"but for the cut")
    return {"quality_fcos_heldout": counts}, line


BENCH_LAUNCHES = {"bench": 35, "bench_stages": 21, "entry": 1}


def _bench_window(audit: NMSAudit, path: str, run):
    """One driver of phase 25 with the kernel's counts read around it
    alone, then its launches held against the twin. -> (its result, the
    counts)."""
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts(path)
    held = audit.flush(path)
    if held != counts[0] or counts[0] != BENCH_LAUNCHES.get(path, 0):
        raise AssertionError(f"{path}: {counts[0]} NMS launches, {held} "
                             f"held against the twin, "
                             f"{BENCH_LAUNCHES.get(path, 0)} expected")
    return out, counts


def _b4_row(sample):
    """The probes' B = 4: the kernel on the first four images of a B = 16
    input, held against the twin and timed as ``time_shapes`` times."""
    planes, iou, m, _, _ = sample
    planes = tuple(t[:4].contiguous() for t in planes)
    x1, y1, x2, y2, scores, valid = planes
    idx, ok = nms_kernel.nms_cuda(*planes, iou, m)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    w_idx, w_ok = nms_select_reference(boxes, scores, valid.bool(), iou, m)
    if not (torch.equal(idx.long(), w_idx.long())
            and torch.equal(ok.bool(), w_ok)):
        raise AssertionError("NMS kernel != twin at B=4")
    ms = time_ms(lambda: nms_kernel.nms_cuda(*planes, iou, m), 20,
                 graph=True)
    plain_ms = time_ms(lambda: nms_select_reference(
        boxes, scores, valid.bool(), iou, m), 3, warmup=1, rounds=3)
    bound_ms, bound_by = nms_bound_ms(scores, valid.bool(), idx, ok.bool())
    return dict(case=f"probes B=4 K={scores.shape[1]} M={m}", b=4,
                k=scores.shape[1], m=m,
                route=nms_kernel.select_route(4, scores.shape[1], m), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                launches=0, alive=int(valid.sum()))


def _bench_live_row():
    """bench.py's B = 48 with candidates alive: its model and images, the
    bank swapped for the stage breakdown's ``random_bank``, which passes
    every location through the score threshold (the normalized bank on
    random weights passes none). One query call, its launch held against
    the twin, then timed as ``time_shapes`` times; outside the counted
    windows."""
    model, _, _ = bench.build_query_path("cuda")
    path = QueryPath(model, random_bank(N_CLASSES, "cuda"), CANVAS,
                     bench.BATCH)
    images = query_images(bench.BATCH, CANVAS, "cuda")
    audit = NMSAudit().install()
    try:
        path(images)
        torch.cuda.synchronize()
        if audit.flush("bench_live") != 1:
            raise AssertionError("bench at B=48 with the random bank: "
                                 "expected one NMS launch")
        (_, shape), = audit.shapes.items()
        alive = int(shape["sample"][0][5].sum())
        row, = audit.time_shapes()
    finally:
        audit.uninstall()
    if alive == 0:
        raise AssertionError("bench at B=48 with the random bank: nothing "
                             "alive")
    return dict(case=f"bench_live B={row['b']} K={row['k']} M={row['m']}",
                b=row["b"], k=row["k"], m=row["m"], route=row["route"],
                ms=row["kernel_ms"], plain_ms=row["twin_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                launches=0, alive=alive)


def phase_bench(card: str):
    """Phase 25: the port's counterparts of bench.py, the stage breakdown,
    ``__graft_entry__.entry()`` and bench_train on the card, each driver's
    NMS launches counted alone and held against the twin. -> (counts by
    path, shape rows, the ``bench`` line)."""
    t0 = time.perf_counter()
    audit = NMSAudit().install()
    try:
        line, bench_counts = _bench_window(audit, "bench",
                                           lambda: bench.run("cuda"))
        stages, stage_counts = _bench_window(
            audit, "bench_stages", lambda: bench_stage_breakdown.run("cuda"))

        def run_entry():
            fn, args = entry("cuda")
            return fn(*args)
        det, entry_counts = _bench_window(audit, "entry", run_entry)
        if tuple(det.boxes.shape) != (1, 100, 4) or not bool(
                det.valid.all()) or not bool(det.boxes.isfinite().all()):
            raise AssertionError(f"entry(): {tuple(det.boxes.shape)}, "
                                 f"{int(det.valid.sum())} valid")
        train, train_counts = _bench_window(
            audit, "bench_train", lambda: bench_train.run("cuda", iters=3))
        wall = time.perf_counter() - t0
        samples = {key[0]: row["sample"] for key, row in audit.shapes.items()}
        shapes = []
        for row in audit.time_shapes():
            label, = row["launches_by_label"]
            planes = samples[row["b"]][0]
            shapes.append(dict(
                case=f"{label} B={row['b']} K={row['k']} M={row['m']}",
                b=row["b"], k=row["k"], m=row["m"], route=row["route"],
                ms=row["kernel_ms"], plain_ms=row["twin_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                launches=row["launches"], alive=int(planes[5].sum())))
    finally:
        audit.uninstall()
    shapes.append(_b4_row(samples[16]))
    shapes.append(_bench_live_row())
    for row in shapes:
        log(f"[bench] NMS {row['case']}: {row['launches']} launches equal "
            f"to the twin, {row['alive']} of {row['b'] * row['k']} alive; "
            f"kernel {row['ms']:.4f} ms, twin {row['plain_ms']:.3f} ms, "
            f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    extra = line["extra"]
    bench_line = {
        "bench": bench.METRIC, "img_per_sec": line["value"],
        "ms_per_batch": extra["ms_per_batch"], "batch": extra["batch"],
        "canvas": extra["canvas"], "gflop_per_image": extra["gflop_per_image"],
        "gflop_per_image_backbone_fpn": extra["gflop_per_image_backbone_fpn"],
        "gflop_per_image_head": extra["gflop_per_image_head"],
        "bf16_dense_peak_share": extra["bf16_dense_peak_share"],
        "codegen_ms_per_class": extra["codegen_ms_per_class"],
        "codegen_ms_per_class_single_dispatch":
            extra["codegen_ms_per_class_single_dispatch"],
        "peak_memory_gb": extra["peak_memory_gb"],
        "stages_b16": {k: stages[k] for k in (
            "backbone_fpn_ms", "towers_cond_head_ms", "decode_nms_ms",
            "total_ms", "img_per_sec")},
        "train_episodes_per_sec": train["value"],
        "train_sec_per_step": train["extra"]["sec_per_step"],
        "nms_launches": {"bench": bench_counts[0],
                         "bench_stages": stage_counts[0],
                         "entry": entry_counts[0],
                         "bench_train": train_counts[0]},
        "wall_s": wall, "card": card}
    log(f"[bench] batch 48 at 768x1280: {line['value']} img/s, "
        f"{extra['ms_per_batch']:.2f} ms a batch, "
        f"{extra['gflop_per_image']:.1f} GFLOP an image, "
        f"{100 * extra['bf16_dense_peak_share']:.2f}% of the dense bf16 "
        f"peak, peak memory {extra['peak_memory_gb']:.2f} GB; codegen "
        f"{extra['codegen_ms_per_class']} / "
        f"{extra['codegen_ms_per_class_single_dispatch']} ms a class; "
        f"stages at 16: {stages['backbone_fpn_ms']} / "
        f"{stages['towers_cond_head_ms']} / {stages['decode_nms_ms']} ms; "
        f"train {train['value']} episodes/s; phase {wall:.1f} s")
    counts = {"bench": bench_counts, "bench_stages": stage_counts,
              "entry": entry_counts}
    return counts, shapes, bench_line


# ------------------------------------------------- the repeat check (26)
class _DrawTap:
    """Records every uniform a ``SampleDraws`` source hands out: its
    generator's seed, the shape and the values, in call order."""

    def __enter__(self):
        self.draws = []
        self.orig = rcnn.SampleDraws._uniform
        tap = self

        def recording(src, shape):
            out = tap.orig(src, shape)
            # the source is kept, so no other one takes its id
            tap.draws.append((src, src.gen.initial_seed(), tuple(shape),
                              out))
            return out

        rcnn.SampleDraws._uniform = recording
        return self

    def __exit__(self, *exc):
        rcnn.SampleDraws._uniform = self.orig

    def check(self, device: str) -> int:
        """Every draw was on ``device`` and equals the CPU generator's
        stream for its seed; -> the number of sources."""
        gens = {}
        for src, seed, shape, out in self.draws:
            if out.device.type != device:
                raise AssertionError(f"a draw landed on {out.device}")
            gen = gens.setdefault(id(src),
                                  torch.Generator().manual_seed(seed))
            if not torch.equal(out.cpu(), torch.rand(shape, generator=gen)):
                raise AssertionError(f"a draw of seed {seed}, shape {shape}, "
                                     "differs from the CPU generator's")
        return len(gens)


def phase_repeat(work: str, card: str):
    """Phase 26; -> (counts, the ``repeat`` line)."""
    coco_tree(work)
    lvis_tree(work)
    line = {"repeat": {}, "card": card}
    counts, routes = 0, {}
    for name in repeat_steps.STEPS:
        runner, cfg = repeat_steps.step_cfg(name, work)
        case = repeat_steps.Case(runner, cfg)
        with repeat_steps.free_kernels():
            case.run()                                  # warm-up
        with NMSRecorder() as rec, _DrawTap() as tap:
            # ---- the main path: counts are read around this block alone
            reset_counts()
            digests, ms = [], []
            for _ in range(2):
                _, t = case.run()
                digests.append(repeat_steps.state_digest(case.state))
                ms.append(t)
            n, by_route = read_counts(f"repeat:{name}")
            # ---- end of the main path
            n_calls, _ = rec.check(f"repeat:{name}")
        if digests[0] != digests[1]:
            raise AssertionError(f"repeat: {name} gave two states from one "
                                 f"state and one batch: {digests}")
        groups = max(1, cfg.TPU.GRAD_ACCUM)
        want = 2 * groups if name.startswith("rcnn") else 0
        if n != want or n_calls != want:
            raise AssertionError(f"repeat: {name} made {n} NMS launches "
                                 f"({n_calls} calls), expected {want}")
        sources = tap.check("cuda")
        if name.startswith("rcnn") and sources != 2 * groups:
            raise AssertionError(f"repeat: {name} drew from {sources} "
                                 "sources")
        with repeat_steps.free_kernels():
            free_ms = [case.run()[1] for _ in range(2)]
        row = {"digest": digests[0], "runs_equal": True, "ms": ms,
               "ms_cudnn_free": free_ms, "nms_launches": n,
               "draw_sources": sources, "grad_accum": groups}
        if name.startswith("rcnn"):
            b, k = repeat_steps.rpn_draw_shape(cfg)
            row["draws"] = repeat_steps.draw_ms(b, k)
        line["repeat"][name] = row
        counts += n
        for r, c in by_route.items():
            routes[r] = routes.get(r, 0) + c
        log(f"[repeat] {name}: two runs from one state, digest "
            f"{digests[0][:16]} both; {sources} draw sources equal to the "
            f"CPU's; {n} NMS launches, each equal to the twin; "
            f"{np.median(ms):.1f} ms a step (cuDNN free "
            f"{np.median(row['ms_cudnn_free']):.1f})")
        del case
        torch.cuda.empty_cache()
    return {"repeat": (counts, routes)}, line


# ------------------------------------------------- the switches (27)
SWITCH_STEPS = ("fcos_episodic", "rcnn_pretrain")  # phases 8 and 15
SWITCH_BATCHES = 4
STEM_SHAPES = ((1, (1024, 1344)), (48, (768, 1280)))


def _k_step_case(name: str, work: str):
    """Phase 8's or phase 15's step over the same 4 loader batches from one
    saved state, as 4 calls of one step and as 2 calls of two: -> the
    ``steps_per_call`` row. Raises unless the state digests (parameters,
    momentum, EMA) and the metric rows are equal."""
    runner, cfg = repeat_steps.step_cfg(name, work)
    model = runner.build_model(cfg, init="train")
    state, _, _ = runner._common_train_setup(cfg, model)
    loader = (runner._episodic_loader(cfg)
              if cfg.MODEL.META_LEARN.EPISODIC_LEARNING
              else runner._pretrain_loader(cfg))
    batches = [next(loader) for _ in range(SWITCH_BATCHES)]
    loader.close()
    saved = repeat_steps._clone(state.state_dict())
    # no warm-up: phase 26 ran the same steps (cuDNN plans, the allocator)
    ways = {}
    for k in (1, 2):
        kcfg = cfg.clone()
        kcfg.defrost()
        kcfg.TPU.STEPS_PER_CALL = k
        step = runner.make_train_step(kcfg, model)
        state.load_state_dict(saved)
        rows = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, SWITCH_BATCHES, k):
            batch = (batches[i] if k == 1
                     else train_steps.stack_batches(batches[i:i + k]))
            state, metrics = step(state, batch)
            rows += train_steps.metric_rows(metrics, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SWITCH_BATCHES
        ways[k] = (repeat_steps.state_digest(state), rows, ms)
    (d1, r1, ms1), (d2, r2, ms2) = ways[1], ways[2]
    if d1 != d2 or r1 != r2:
        raise AssertionError(f"switches: {name} in calls of 2 steps gave "
                             f"{d2[:16]} / {r2}, in calls of 1 {d1[:16]} / "
                             f"{r1}")
    if not all(np.isfinite(v) for r in r1 for v in r.values()):
        raise AssertionError(f"switches: {name}: non-finite losses {r1}")
    log(f"[switches] {name}: {SWITCH_BATCHES} steps as 2 calls of 2 equal "
        f"4 calls of 1 (digest {d1[:16]}, {len(r1)} metric rows); "
        f"{ms1:.1f} / {ms2:.1f} ms a step (K = 1 / 2)")
    return {"digest": d1, "equal": True, "steps": SWITCH_BATCHES,
            "grad_accum": max(1, cfg.TPU.GRAD_ACCUM), "ms_per_step_k1": ms1,
            "ms_per_step_k2": ms2}


def _dense_rel_errs(a, b) -> dict:
    """max |a - b| / max |b| per dense output (tests/test_torch_bf16.py)."""
    return {n: float((getattr(a, n).float() - getattr(b, n).float()).abs()
                     .max() / getattr(b, n).float().abs().max().clamp_min(
                         1e-12))
            for n in ("logits", "reg", "ctrness", "iou")}


def match_detections(a, b, strides, what: str) -> dict:
    """tests/test_torch_bf16.py's limits for two bf16 pipelines: a
    detection's counterpart has the same class and FPN level, coordinates
    within a tenth of the level's stride and score within 0.005. Below
    every slot the counts may differ by two, and each detection of the
    shorter list has a counterpart. Where a list fills every slot, its
    lowest score is a cut like the threshold: each detection of either
    list has a counterpart but for those within 0.005 of the cut (which of
    two near-tied candidates makes it may differ). -> the counts matched
    and exempted."""
    def rows(d):
        k = d.valid[0].cpu()
        return list(zip(d.classes[0].cpu()[k].tolist(),
                        d.fpn_levels[0].cpu()[k].tolist(),
                        d.boxes[0].cpu()[k].numpy(),
                        d.scores[0].cpu()[k].tolist()))
    ra, rb = rows(a), rows(b)
    slots = a.valid.shape[1]
    cuts = [min(r[3] for r in x) for x in (ra, rb) if len(x) == slots]
    if cuts:
        cut = max(cuts)
        passes = ((ra, rb), (rb, ra))
    else:
        if abs(len(ra) - len(rb)) > 2 or min(len(ra), len(rb)) == 0:
            raise AssertionError(f"{what}: {len(ra)} against {len(rb)} "
                                 "detections")
        cut = -1.0
        passes = ((ra, rb),) if len(ra) <= len(rb) else ((rb, ra),)
    out = {"matched": 0, "near_cut": 0}
    for mine, other in passes:
        free = list(range(len(other)))
        for cls, lvl, box, score in mine:
            tol = strides[lvl] / 10
            hit = [i for i in free if other[i][0] == cls
                   and other[i][1] == lvl
                   and np.abs(other[i][2] - box).max() <= tol
                   and abs(other[i][3] - score) <= 0.005]
            if hit:
                free.remove(hit[0])
                out["matched"] += 1
            elif score <= cut + 0.005:
                out["near_cut"] += 1
            else:
                raise AssertionError(f"{what}: no counterpart for class "
                                     f"{cls} box {box} score {score} (cut "
                                     f"{cut})")
    return out


def _stem_pair(cfg):
    """The seeded 7x7 model of ``cfg`` on the CPU and its s2d rewrite, the
    weights carried across by ``merge_state_dict``; raises unless the stem
    came across exactly."""
    model7 = create_runner("MetaFCOSRunner", device="cpu").build_model(cfg)
    cfg4 = cfg.clone()
    cfg4.TPU.S2D_STEM = True
    model4 = merge_state_dict(build_model_from_cfg(cfg4, device="cpu",
                                                   seed=99),
                              model7.state_dict())
    w7, w4 = (m.backbone.stem_conv1.weight for m in (model7, model4))
    if tuple(w4.shape) != (64, 12, 4, 4) or not torch.equal(
            stem_kernel_from_s2d(w4), w7):
        raise AssertionError(f"s2d: the stem came across as {w4.shape}")
    return (cfg, model7), (cfg4, model4)


def _s2d_exact_fp32() -> dict:
    """The 7x7 model and its s2d rewrite in float32 (TF32 off), served
    side by side on 2 requests: dense outputs and detections within phase
    5's limits."""
    _exact_fp32()
    cfg = serving_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_BF16_RESIDENT = False
    preds = [SylphPredictor(cfg=c, model=m, max_classes=8)
             for c, m in _stem_pair(cfg)]
    for pred in preds:
        register(pred, np.random.RandomState(27), ["class_a", "class_b"], 3)
    rng = np.random.RandomState(28)
    worst, n_det = {}, 0
    for h, w in REQUEST_SIZES[:2]:
        img = random_image(rng, h, w)
        outs = []
        for pred in preds:
            canvas, size, _ = pred.prepare(img)
            out = pred.dense(canvas)
            outs.append((out, pred.decode(out, size, pred.bank.valid)))
        (o7, d7), (o4, d4) = outs
        for n in ("logits", "reg", "ctrness", "iou"):
            np.testing.assert_allclose(
                getattr(o4, n).cpu().numpy(), getattr(o7, n).cpu().numpy(),
                rtol=1e-3, atol=5e-3, err_msg=f"s2d fp32 {n}")
            worst[n] = max(worst.get(n, 0.0), float(
                (getattr(o4, n) - getattr(o7, n)).abs().max()))
        k4, k7 = d4.valid[0], d7.valid[0]
        if int(k4.sum()) != int(k7.sum()) or int(k7.sum()) == 0:
            raise AssertionError(f"s2d fp32: {int(k4.sum())} against "
                                 f"{int(k7.sum())} detections")
        np.testing.assert_allclose(d4.boxes[0][k4].cpu().numpy(),
                                   d7.boxes[0][k7].cpu().numpy(), atol=0.05)
        np.testing.assert_allclose(d4.scores[0][k4].cpu().numpy(),
                                   d7.scores[0][k7].cpu().numpy(), atol=1e-3)
        if not torch.equal(d4.classes[0][k4], d7.classes[0][k7]):
            raise AssertionError("s2d fp32: classes differ")
        n_det += int(k7.sum())
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    del preds
    torch.cuda.empty_cache()
    return {"dense_max_abs_diff": worst, "detections": n_det}


def _stem_ms(model7, model4) -> dict:
    """The stem conv alone in bf16 (the s2d one with its rearrangement and
    padding), CUDA events around graph replays."""
    out = {}
    for b, (h, w) in STEM_SHAPES:
        x = torch.randn(b, 3, h, w, device="cuda", dtype=torch.bfloat16)
        row = {}
        for key, model in (("7x7", model7), ("s2d", model4)):
            conv = model.backbone.stem_conv1
            with torch.inference_mode():
                row[f"{key}_ms"] = time_ms(lambda: conv(x), reps=20,
                                           graph=True)
        out[f"b{b}_{h}x{w}"] = row
        del x
    return out


def _switch_s2d(card: str):
    """The s2d stem at full width on weights carried from the 7x7 model by
    ``merge_state_dict``: exact in float32, then served in bf16 both ways
    (the default config's bf16-held weights). -> (counts, the row)."""
    exact = _s2d_exact_fp32()
    log(f"[switches] s2d stem fp32 (TF32 off), 2 requests: dense outputs "
        f"within {max(exact['dense_max_abs_diff'].values()):.2e} of the 7x7 "
        f"model's, {exact['detections']} detections within phase 5's limits")
    (cfg7, model7), (cfg4, model4) = _stem_pair(serving_cfg())
    pred7 = SylphPredictor(cfg=cfg7, model=model7)
    pred4 = SylphPredictor(cfg=cfg4, model=model4)
    counts, lines = {}, {}
    for label, pred in (("switches_7x7_serve", pred7),
                        ("switches_s2d_serve", pred4)):
        counts[label], lines[label] = serve_and_check(pred, label, card)
    img = random_image(np.random.RandomState(29), 800, 1216)
    outs = [pred.dense(pred.prepare(img)[0]) for pred in (pred7, pred4)]
    errs = _dense_rel_errs(outs[1], outs[0])
    if max(errs.values()) > 0.05:
        raise AssertionError(f"s2d bf16 dense outputs: {errs}")
    log(f"[switches] s2d stem bf16: dense outputs within "
        f"{max(errs.values()):.4f} of the range of the 7x7 model's ({errs})")
    stem = _stem_ms(pred7.model, pred4.model)
    for shape, row in stem.items():
        log(f"[switches] stem {shape} bf16: 7x7 {row['7x7_ms']:.4f} ms, "
            f"s2d {row['s2d_ms']:.4f} ms")
    row = {"fp32": exact, "bf16_dense_rel_err": errs, "stem": stem,
           "request_ms": {k: v["median_request_ms"]
                          for k, v in lines.items()},
           "nms_launches": {k: c[0] for k, c in counts.items()}}
    del pred7, pred4, model7, model4
    torch.cuda.empty_cache()
    return counts, row


def _alternating_request_ms(preds: dict, images, turns: int = 3) -> dict:
    """Request ms of each predictor, served in turns (a, b, b, a, ...) on
    the same images after each answered one warm-up request: -> the
    median of each turn's requests, by predictor."""
    names = list(preds)
    for pred in preds.values():
        pred(images[0])
    out = {n: [] for n in names}
    order = [names[j] for i in range(turns)
             for j in ((0, 1) if i % 2 == 0 else (1, 0))]
    for name in order:
        ms = []
        for img in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds[name](img)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name].append(float(np.median(ms)))
    return out


def _switch_bf16_serving(card: str):
    """``SylphPredictor`` under the default config (bf16-held weights)
    against the float32-held one on the same weights. -> (counts, row)."""
    cfg = serving_cfg()
    f32_cfg = serving_cfg()
    f32_cfg.TPU.EVAL_BF16_RESIDENT = False
    # on the CPU: each predictor carries a copy of it to the card
    model = create_runner("MetaFCOSRunner", device="cpu").build_model(cfg)
    rng = np.random.RandomState(30)
    images = [random_image(rng, h, w) for h, w in REQUEST_SIZES[:3]]
    counts, row, outs = {}, {}, {}
    for label, c in (("switches_f32_held_serve", f32_cfg),
                     ("switches_bf16_held_serve", cfg)):
        pred = SylphPredictor(cfg=c, model=copy.deepcopy(model))
        dtypes = {str(t.dtype) for t in itertools.chain(
            pred.model.parameters(), pred.model.buffers())
            if t.is_floating_point()}
        want = {"torch.bfloat16"} if c is cfg else {"torch.float32"}
        if dtypes != want or pred.bank.conv.dtype != torch.float32:
            raise AssertionError(f"{label}: weights held in {dtypes}, bank "
                                 f"{pred.bank.conv.dtype}")
        counts[label], line = serve_and_check(pred, label, card)
        row[label] = {"median_request_ms": line["median_request_ms"],
                      "request_ms": line["request_ms"],
                      "peak_memory_gb": line["peak_memory_gb"],
                      "weights": sorted(dtypes)}
        outs[label] = []
        for img in images:
            canvas, size, _ = pred.prepare(img)
            out = pred.dense(canvas)
            dets = pred.decode(out, size, pred.bank.valid)
            # dense outputs on the CPU: the next predictor's peak memory
            # leaves them out
            outs[label].append((type(out)(*(t.cpu() for t in out)), dets))
            del out, dets
        del pred
        torch.cuda.empty_cache()
    strides = tuple(cfg.MODEL.FCOS.FPN_STRIDES)
    errs, matched = {}, {"matched": 0, "near_cut": 0}
    for i, ((of, df), (ob, db)) in enumerate(zip(
            outs["switches_f32_held_serve"],
            outs["switches_bf16_held_serve"])):
        e = _dense_rel_errs(ob, of)
        errs = {n: max(errs.get(n, 0.0), v) for n, v in e.items()}
        m = match_detections(db, df, strides, f"bf16-held request {i}")
        matched = {k: matched[k] + m[k] for k in matched}
    if max(errs.values()) > 0.05:
        raise AssertionError(f"bf16-held dense outputs: {errs}")
    row.update(dense_rel_err=errs, detections=matched)
    # both held side by side, served in turns: the order of the two runs
    # above is out of the comparison
    preds = {label: SylphPredictor(cfg=c, model=copy.deepcopy(model))
             for label, c in (("f32_held", f32_cfg), ("bf16_held", cfg))}
    for pred in preds.values():
        register(pred, np.random.RandomState(0), ["class_a", "class_b",
                                                   "class_c"], 10)
    row["turns_median_request_ms"] = _alternating_request_ms(preds, images)
    log(f"[switches] in turns (f32, bf16, bf16, f32, ...), median request "
        f"ms: {row['turns_median_request_ms']}")
    del preds
    torch.cuda.empty_cache()
    log(f"[switches] bf16-held serving: dense outputs within "
        f"{max(errs.values()):.4f} of the range of the float32-held ones "
        f"({errs}); detections matched {matched['matched']}, "
        f"{matched['near_cut']} within 0.005 of the top-100 cut; median request "
        f"{row['switches_bf16_held_serve']['median_request_ms']:.1f} / "
        f"{row['switches_f32_held_serve']['median_request_ms']:.1f} ms, "
        f"peak {row['switches_bf16_held_serve']['peak_memory_gb']:.2f} / "
        f"{row['switches_f32_held_serve']['peak_memory_gb']:.2f} GB "
        "(bf16 / float32 held)")
    return counts, row


def _switch_eval_in_training(work: str) -> dict:
    """Phase 8's episodic config, 2 steps, with an evaluation after the
    first (EMA on) and without: equal digests; the evaluation saw bf16
    weights and the weights were float32 before and after it."""
    coco_tree(work)
    seen = []
    orig = MetaFCOSRunner._do_test_episodic

    def recording(self, cfg, model):
        seen.append(sorted({str(p.dtype) for p in model.parameters()}))
        return orig(self, cfg, model)

    digests = {}
    MetaFCOSRunner._do_test_episodic = recording
    try:
        for period in (1, 0):
            cfg = train_cfg("episodic", 2)
            cfg.TEST.EVAL_PERIOD = period
            cfg.DATASETS.TEST = ["coco_meta_val_novel"]
            cfg.TEST.REPEAT_TEST = 1
            cfg.MODEL_EMA.ENABLED = True
            runner = MetaFCOSRunner()
            model, state = runner.do_train(cfg)
            dtypes = {str(p.dtype) for p in model.parameters()} | {
                str(v.dtype) for v in state.ema.values()}
            if dtypes != {"torch.float32"}:
                raise AssertionError(f"after training with EVAL_PERIOD "
                                     f"{period}: {dtypes}")
            digests[period] = repeat_steps.state_digest(state)
            del model, state, runner
            torch.cuda.empty_cache()
    finally:
        MetaFCOSRunner._do_test_episodic = orig
    if seen != [["torch.bfloat16"]]:
        raise AssertionError(f"the evaluations saw weights in {seen}")
    if digests[1] != digests[0]:
        raise AssertionError(f"an evaluation inside training changed the "
                             f"run: {digests}")
    log(f"[switches] episodic training with an evaluation after step 1 "
        f"(bf16-held inside it) equals the run without (digest "
        f"{digests[0][:16]}; float32 weights and EMA)")
    return {"digest": digests[0], "equal": True, "eval_weights": seen[0]}


def _switch_dilated_dcn() -> dict:
    """One dilation-2 ``DFConv2d`` (256 -> 256, seeded non-zero offset
    head) on the card against the CPU, fp32 with TF32 off: phase 20's
    limits."""
    _exact_fp32()
    gen = torch.Generator().manual_seed(31)
    layer = DFConv2d(256, 256, dilation=2)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (0.5 / math.sqrt(max(1, p[0].numel()))))
    x = torch.randn(2, 256, 48, 64, generator=gen)
    with torch.inference_mode():
        want = layer(x)
        got = layer.to("cuda")(x.cuda()).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=5e-3, err_msg="dilated DFConv2d")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    err = float((got - want).abs().max())
    log(f"[switches] dilated DFConv2d (256 -> 256, dilation 2, 2x48x64): "
        f"card within {err:.2e} of the CPU")
    return {"max_abs_diff": err, "shape": [2, 256, 48, 64], "dilation": 2}


def phase_switches(work: str, card: str):
    """Phase 27; -> (counts, the ``switches`` line)."""
    coco_tree(work)
    lvis_tree(work)
    line = {"switches": {}, "card": card}
    rows = {}
    with NMSRecorder() as rec:
        # ---- the main path: counts are read around this block alone
        reset_counts()
        for name in SWITCH_STEPS:
            rows[name] = _k_step_case(name, work)
        k_counts = read_counts("switches_k_steps")
        # ---- end of the main path
        n_calls, _ = rec.check("switches_k_steps")
    # 4 steps each way, one launch a step and micro-group
    groups = rows["rcnn_pretrain"]["grad_accum"]
    want = 2 * SWITCH_BATCHES * groups
    if k_counts[0] != want or n_calls != want:
        raise AssertionError(f"switches: {k_counts[0]} RPN NMS launches "
                             f"({n_calls} calls), expected {want}")
    rows["rcnn_pretrain"]["nms_launches"] = k_counts[0]
    torch.cuda.empty_cache()
    bt = bench_train.run(steps_per_call=2, iters=3)
    if bt["extra"]["steps_per_call"] != 2 or not all(
            np.isfinite(v) for v in bt["extra"]["losses"].values()):
        raise AssertionError(f"bench_train --steps-per-call 2: {bt}")
    rows["bench_train"] = {"steps_per_call": 2,
                           "sec_per_step": bt["extra"]["sec_per_step"],
                           "episodes_per_s": bt["value"]}
    log(f"[switches] bench_train --steps-per-call 2: "
        f"{bt['extra']['sec_per_step'] * 1e3:.1f} ms a step, "
        f"{bt['value']} episodes/s")
    line["switches"]["steps_per_call"] = rows
    torch.cuda.empty_cache()
    s2d_counts, line["switches"]["s2d_stem"] = _switch_s2d(card)
    bf16_counts, line["switches"]["bf16_held_eval"] = \
        _switch_bf16_serving(card)
    line["switches"]["bf16_held_eval"]["training_with_eval"] = \
        _switch_eval_in_training(work)
    line["switches"]["dilated_dcn"] = _switch_dilated_dcn()
    return {"switches_k_steps": k_counts, **s2d_counts,
            **bf16_counts}, line


# ------------------------------------------------------------- ROIAlign
ROI_ALIGN_REL_LIMIT = 1e-5  # of max |map|: float32 sums in another order


def roi_align_case(what: str, feats, strides, boxes, valid, bidx,
                   **opts) -> float:
    """One call of the kernel against the twin on the same inputs -> the
    largest gap over max |map|; raises past ``ROI_ALIGN_REL_LIMIT``."""
    with torch.no_grad():
        got = multilevel_roi_align(feats, strides, boxes, valid, bidx, **opts)
        want = multilevel_roi_align_plain(feats, strides, boxes, valid, bidx,
                                          **opts)
    if (got.dtype != torch.float32 or not got.is_contiguous()
            or got.shape != want.shape):
        raise AssertionError(f"{what}: kernel gave {got.dtype} "
                             f"{tuple(got.shape)}, twin {tuple(want.shape)}")
    top = max(float(f.float().abs().max()) for f in feats)
    rel = float((got - want).abs().max()) / top
    if not rel <= ROI_ALIGN_REL_LIMIT:
        raise AssertionError(f"{what}: max |kernel - twin| = {rel:.3e} x "
                             f"max |map|, limit {ROI_ALIGN_REL_LIMIT}")
    if not torch.all(got[~valid] == 0):
        raise AssertionError(f"{what}: an invalid ROI pooled nonzero")
    log(f"[roi_align] {what}: N={boxes.shape[0]}, {len(feats)} levels "
        f"{feats[0].dtype}: max |kernel - twin| {rel:.2e} x max |map|")
    return rel


def roi_align_bound_ms(feats, strides, boxes, valid, output_size: int):
    """Least time for one call's bytes: (N, C, P, P) float32 written once
    and each level that a valid ROI is assigned to read once."""
    lvl = assign_levels(boxes, strides, len(feats))
    used = set(lvl[valid].unique().tolist())
    n, c = boxes.shape[0], feats[0].shape[1]
    nbytes = (n * c * output_size ** 2 * 4
              + sum(f.numel() * f.element_size()
                    for i, f in enumerate(feats) if i in used))
    return nbytes / HBM_BYTES_PER_S * 1e3


def roi_align_times(feats, strides, boxes, valid, bidx, **opts) -> dict:
    """Kernel ms (20 calls a CUDA-graph replay, the level assignment
    included), bound ms and twin ms (host-issued, median of 3)."""
    args = (feats, strides, boxes, valid, bidx)
    with torch.no_grad():
        kernel = time_ms(lambda: multilevel_roi_align(*args, **opts), 20,
                         graph=True)
        twin = time_ms(lambda: multilevel_roi_align_plain(*args, **opts), 1,
                       warmup=1, rounds=3)
    return {"kernel_ms": kernel,
            "bound_ms": roi_align_bound_ms(feats, strides, boxes, valid,
                                           opts["output_size"]),
            "twin_ms": twin}


def roi_align_span_share(call) -> dict:
    """Profile one ``call()`` inside a ``sylph.roi_align`` range: the
    device events recorded, the kernel's device ns by name, and the share
    of it whose launch the profiler ties to a host op inside the range (as
    port_bench's ``Timeline`` attributes kernels)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("sylph.roi_align"):
            call()
        torch.cuda.synchronize()
    launch, ranges, kernels, device = {}, [], [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                launch.setdefault(e.correlation_id(), e.start_ns())
            if e.name() == "sylph.roi_align":
                ranges.append((e.start_ns(), e.end_ns()))
            continue
        device += 1
        if "roi_align_level_kernel" in e.name():
            kernels.append((e.end_ns() - e.start_ns(),
                            e.linked_correlation_id()))
    total = sum(d for d, _ in kernels)
    inside = sum(d for d, corr in kernels if corr in launch
                 and any(a <= launch[corr] <= b for a, b in ranges))
    return {"device_events": device, "kernel_ns": total,
            "share_inside_span": inside / total if total else None}


def _roi_edge_boxes(rng, n: int, canvas, batch: int):
    """Boxes over every level, and the edges: degenerate and inverted,
    wholly and partly off the map, tiny, huge, invalid."""
    h, w = canvas
    xy = rng.uniform(-0.1 * w, 0.9 * w, size=(n, 2))
    wh = np.exp(rng.uniform(np.log(1.0), np.log(1.2 * max(h, w)),
                            size=(n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[0, 2] = boxes[0, 0]                          # degenerate width
    boxes[1, 3] = boxes[1, 1] - 5.0                    # inverted height
    boxes[2] = [-600.0, -500.0, -400.0, -300.0]        # off the map
    boxes[3] = [w - 10.0, h - 12.0, w + 300.0, h + 200.0]  # partly off
    boxes[4] = [5.0, 6.0, 5.5, 6.25]                   # tiny
    boxes[5] = [-2.0 * w, -2.0 * h, 3.0 * w, 3.0 * h]  # huge
    valid = np.ones(n, bool)
    valid[rng.choice(np.arange(6, n), 8, replace=False)] = False
    bidx = rng.randint(0, batch, size=n)
    dev = "cuda"
    return (torch.as_tensor(boxes, device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(bidx, dtype=torch.long, device=dev))


def _roi_edges() -> dict:
    """Seeded maps at the FCOS and two-stage levels: the edge boxes in
    bf16 and float32, NCHW and channels-last, adaptive and
    ``sampling_ratio`` 2, slices with ``batch_idx`` 0, one-level
    ``roi_align``, and a call with no ROIs."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    rng = np.random.RandomState(28)
    errs = {}
    canvas = (320, 448)
    layouts = {"nchw": torch.contiguous_format, "nhwc": torch.channels_last}
    for strides, dtype, layout in itertools.product(
            ((4, 8, 16, 32), (8, 16, 32, 64, 128)),
            (torch.bfloat16, torch.float32), layouts):
        maps = [torch.randn(3, 64, canvas[0] // s, canvas[1] // s,
                            generator=gen, device="cuda").to(
                                dtype, memory_format=layouts[layout])
                for s in strides]
        boxes, valid, bidx = _roi_edge_boxes(rng, 300, canvas, 3)
        tag = f"L{len(strides)}_{str(dtype)[6:]}_{layout}"
        for ratio in (0, 2):
            errs[f"edges_{tag}_s{ratio}"] = roi_align_case(
                f"edges_{tag}_s{ratio}", maps, strides, boxes, valid, bidx,
                output_size=7, sampling_ratio=ratio)
        errs[f"slices_{tag}"] = roi_align_case(
            f"slices_{tag}", [m[2:3] for m in maps], strides, boxes, valid,
            torch.zeros_like(bidx), output_size=7)
    with torch.no_grad():
        one = roi_align(maps[1], boxes, bidx, spatial_scale=1 / 16,
                        output_size=7, sampling_ratio=0)
        ref = roi_align_plain(maps[1], boxes, bidx, spatial_scale=1 / 16,
                              output_size=7, sampling_ratio=0)
    rel = float((one - ref).abs().max()) / float(maps[1].abs().max())
    if not rel <= ROI_ALIGN_REL_LIMIT:
        raise AssertionError(f"one-level roi_align: {rel:.3e} x max |map|")
    errs["one_level"] = rel
    empty = multilevel_roi_align(maps, strides, boxes[:0], valid[:0],
                                 bidx[:0], output_size=7)
    if tuple(empty.shape) != (0, 64, 7, 7):
        raise AssertionError(f"no ROIs gave {tuple(empty.shape)}")
    return errs


def _roi_grads(feats, strides, rois) -> dict:
    """The training path: ``multilevel_roi_align`` on per-image slices of
    maps that train, its map gradients against the twin's own autograd,
    bit for bit, in bf16 and float32, twice each."""
    n = rois.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(n, dtype=torch.long, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(280)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        maps = [f.detach().to(dtype).requires_grad_() for f in feats]
        grad = torch.randn((n, maps[0].shape[1], 7, 7), generator=gen,
                           device="cuda")
        runs = []
        for pool in (multilevel_roi_align, multilevel_roi_align_plain,
                     multilevel_roi_align):
            pooled = pool([m[1:2] for m in maps], strides, rois, ones, zeros,
                          output_size=7)
            runs.append(torch.autograd.grad(pooled, maps, grad))
        for got in (runs[0], runs[2]):
            for i, (g, w) in enumerate(zip(got, runs[1])):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(
                        f"{dtype} maps: level {i}'s gradient differs from "
                        f"the twin's by {float((g - w).abs().max()):.3e}")
        out[str(dtype)[6:]] = "bit-equal"
        log(f"[roi_align] training gradients, {dtype} maps, {n} ROIs: "
            "bit-equal to the twin's, twice")
    return out


def phase_roi_align(work: str, card: str) -> dict:
    """Phase 28."""
    earlier = roi_align_kernel.LAUNCHES  # phases 4-27's main paths
    rcnn_cfg = rcnn_meta_test_cfg(work)
    model = build_rcnn_model_from_cfg(rcnn_cfg, device="cuda")
    canvas = tuple(rcnn_cfg.TPU.EVAL_CANVAS)
    rng = np.random.RandomState(280)
    images = torch.as_tensor(
        rng.randint(0, 256, (2, *canvas, 3)).astype(np.float32),
        device="cuda")
    sizes = torch.tensor([list(canvas)] * 2, dtype=torch.int32,
                         device="cuda")
    grid = eval_anchor_grid(rcnn_cfg)
    with torch.inference_mode():
        feats, logits, deltas = model.forward_rpn(images)
        props, _, pvalid = rcnn.rpn_proposals(
            logits, deltas, torch.as_tensor(grid.anchors, device="cuda"),
            grid.level_splits, sizes,
            pre_nms_topk=rcnn_cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk=rcnn_cfg.MODEL.RPN.POST_NMS_TOPK_TEST)
    feats = [f.clone() for f in feats[:4]]
    props, pvalid = props.clone(), pvalid.clone()
    strides = model.ROI_STRIDES
    query = ([f[1:2] for f in feats], strides, props[1], pvalid[1],
             torch.zeros(props.shape[1], dtype=torch.long, device="cuda"))
    lvl = assign_levels(props[1], strides, 4)
    errs = {"query": roi_align_case("query (cell 2's shape)", *query,
                                    output_size=7)}
    levels_used = torch.bincount(lvl[pvalid[1]], minlength=4).tolist()

    # registration: 80 supports at 384x384 on the FCOS levels
    fcos_cfg = serving_cfg()
    fcos = build_model_from_cfg(fcos_cfg, device="cuda")
    support = tuple(fcos_cfg.TPU.SUPPORT_CANVAS)
    s_img = torch.as_tensor(rng.randint(0, 256, (80, *support, 3))
                            .astype(np.float32), device="cuda")
    xy = rng.uniform(0, 0.6 * support[1], size=(80, 2))
    wh = rng.uniform(16, 0.4 * support[1], size=(80, 2))
    s_boxes = torch.as_tensor(np.concatenate([xy, xy + wh], 1)
                              .astype(np.float32), device="cuda")
    s_valid = torch.ones(80, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        s_feats = [f.to(fcos.code_generator.compute_dtype).clone()
                   for f in fcos.extract_features(s_img)]
    register = (s_feats, fcos.code_generator.strides, s_boxes, s_valid,
                torch.arange(80, device="cuda"))
    errs["register"] = roi_align_case("registration (cell 3's shape)",
                                      *register, output_size=7)
    errs["roi_encoder"] = roi_align_case(
        "ROIEncoder (10 supports)", [f[:10] for f in s_feats],
        fcos.code_generator.strides, s_boxes[:10], s_valid[:10],
        torch.arange(10, device="cuda"), output_size=7)
    errs.update(_roi_edges())

    # counts on the paths themselves
    bank = model.normalize_code({
        "cls_conv": torch.randn(8, 1024, device="cuda"),
        "cls_bias": torch.zeros(8, device="cuda")})
    counts = {}
    for path, call in (
            ("rcnn_roi_forward", lambda: model.roi_forward(
                query[0], props[1], pvalid[1], bank)),
            ("fcos_register", lambda: fcos.forward_class_code(
                s_img, s_boxes, s_valid, num_shots=10))):
        roi_align_kernel.LAUNCHES = roi_align_kernel.ROIS = 0
        with torch.inference_mode():
            call()
        torch.cuda.synchronize()
        counts[path] = {"launches": roi_align_kernel.LAUNCHES,
                        "rois": roi_align_kernel.ROIS}
        if roi_align_kernel.LAUNCHES < 1 or roi_align_kernel.ROIS < 1:
            raise AssertionError(f"{path}: no ROIAlign launch ({counts})")
    log(f"[roi_align] launches and ROIs by path: {counts}")

    grads = _roi_grads(feats, strides, props[1, :512].clone())
    times = {"query": roi_align_times(*query, output_size=7),
             "register": roi_align_times(*register, output_size=7)}
    for k, t in times.items():
        log(f"[roi_align] {k}: kernel {t['kernel_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms (bytes), twin {t['twin_ms']:.2f} ms")
    with torch.no_grad():
        span_share = roi_align_span_share(
            lambda: multilevel_roi_align(*query, output_size=7))
    log(f"[roi_align] profiler: {span_share}")
    return {"roi_align": "kernel_vs_twin",
            "launches_in_phases_4_27": earlier, "max_rel_err": errs,
            "limit_rel": ROI_ALIGN_REL_LIMIT,
            "query_rois_by_level": levels_used, "gradients": grads,
            "counts_by_path": counts, "times": times,
            "profiler": span_share,
            "channels_per_block": {
                str(n): roi_align_kernel.channels_per_block(
                    n, 256, 7, torch.cuda.get_device_properties(0)
                    .multi_processor_count) for n in (10, 80, 1000)},
            "card": card}


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
    t0 = time.perf_counter()
    roi_align_kernel.build()
    log(f"[build] roi_align.cu built in {time.perf_counter() - t0:.1f} s")
    logs = {**nms_kernel.BUILD_LOG, "roi_align": roi_align_kernel.BUILD_LOG}
    for name, out in logs.items():
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
        t0 = time.perf_counter()
        quality_counts, quality_line = phase_quality(work, card)
        log(f"[time] phase 24: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bench_counts, bench_shapes, bench_line = phase_bench(card)
        log(f"[time] phase 25: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        repeat_counts, repeat_line = phase_repeat(work, card)
        log(f"[time] phase 26: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        switch_counts, switch_line = phase_switches(work, card)
        log(f"[time] phase 27: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        roi_line = phase_roi_align(work, card)
        log(f"[time] phase 28: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[time] every phase, the builds included: "
        f"{time.perf_counter() - t_start:.1f} s")
    shapes += [ep_case, rpre_case, *bench_shapes]

    # every main-path window's reading: (launches, launches by route)
    counts = {"serve": serve_counts, "meta_test": meta_counts, **rcnn_counts,
              "rcnn_plain": plain_counts, "rcnn_train_episodic": ep_counts,
              "rcnn_train_pretrain": rpre_counts, "rcnn_train_tfa": tfa_counts,
              **roi_counts, **tfa1_counts, **dcn_counts, **dp_counts,
              **quality_counts, **bench_counts, **repeat_counts,
              **switch_counts}
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
                    shapes=shapes),
               dict(name="roi_align", route="cuda",
                    source="sylph_tpu_torch/csrc/roi_align.cu",
                    replaces=None,
                    launches=roi_line["launches_in_phases_4_27"],
                    launches_by_path=roi_line["counts_by_path"],
                    max_rel_err=max(roi_line["max_rel_err"].values()),
                    library_ms=None, shapes=roi_line["times"])]
    rcnn_line["plain"] = plain_part
    rcnn_line["card"] = card
    print(json.dumps(episodic_line), flush=True)
    print(json.dumps(pretrain_line), flush=True)
    for line in (ep_line, rpre_line, tfa_line, roi_serve, roi_train,
                 *tfa1_lines, dcn_serve, dcn_train, *dp_train_lines, dp_line,
                 registration_line, quality_line, bench_line,
                 repeat_line, switch_line, roi_line):
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
