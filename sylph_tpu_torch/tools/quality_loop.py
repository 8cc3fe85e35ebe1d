"""Quality loops: train a detector of each family from scratch on a
learnable synthetic set, then score it (the port's own copy of the JAX
package's ``tools/quality_loop_variants.py`` and ``tools/
quality_loop_rcnn.py``; the functions keep their names).

    python3 -m sylph_tpu_torch.tools.quality_loop --family fcos_heldout \
        --hard --iters 600 --data-root /tmp/learnable_coco_hard \
        --output-dir output/quality_loop_fcos_heldout [--device cuda]

Families (``--family``):

* ``fcos`` — Meta-FCOS meta-trained on every class, the two-phase
  ``do_test`` on ``coco_meta_val_all``; ``--grad-accum`` and
  ``--ref-world`` (``tools/train_net.py::auto_scale_world_size``) change its
  batch schedule;
* ``fcos_heldout`` — a plain base-class pretrain whose weights
  (``base_pretrain.npz``, flax layout) seed an episodic finetune on the
  base classes only, backbone and box branch frozen; novel classes are
  registered from K-shot supports alone (REPEAT_TEST 5);
* ``roi_encoder`` — the ROIEncoder hypernetwork (``--ref-depth``: the
  stack the shipped configs use);
* ``tfa`` — base pretrain, ``cls_logits`` surgery, a K-shot finetune over
  every class with the feature extractor frozen;
* ``tfa_rcnn`` — the two-stage form: base Faster R-CNN pretrain, box-head
  surgery, a frozen-feature cosine finetune;
* ``rcnn`` — Meta Faster R-CNN meta-trained on every class;
* ``owd`` — open-world pretraining (objectness from the IoU head),
  class-agnostic AP on classes never trained;
* ``lvis`` / ``lvis_heldout`` — the LVIS federated protocol (APr), the
  held-out form with a base pretrain on the frequent classes first.

Data comes from ``data/synthetic.py`` (written at ``--data-root`` when
missing: ``--hard`` gives the 18-class set), weights from the flax
initializers' distributions (``init="train"``). Each stage writes
``config.yaml``, ``config_diff.yaml`` and ``env.txt`` into its output
directory; the run writes ``eval_results.json`` (the JAX driver's layout)
and ``run_stats.json``: per stage the time of training (its parts: set-up,
the first batch, the steps at their median, the steps beyond it, what runs
between and after the steps) and of testing, the median step, the data
wait, the losses at the start and the end, the device's idle share over one
``torch.profiler`` window of 20 steps (the profiler's own time is reported
apart and kept out of the training time), and the NMS launches. On a card
every launch of the NMS kernel is held against its plain twin
(``tools/nms_audit.py``) and, after the run, the kernel is timed at each
shape the run gave it.

Runs on the card by default; without one it raises unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Dict, List, Optional

import torch

from ..data.catalog import (DatasetCatalog, MetadataCatalog,
                            register_all_coco, register_all_lvis)
from ..data.synthetic import (BASE_IDS, HARD_ALL_IDS, HARD_BASE_IDS,
                              make_learnable_coco, make_learnable_lvis)
from ..meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                       TFAFasterRCNNRunner)
from ..runner import (MetaFCOSROIEncoderRunner, MetaFCOSRunner,
                      TFAFewShotDetectionRunner, resolve_device)
from ..utils.convert_weights import save_flat_npz
from ..utils.setup import setup_after_launch
from .nms_audit import NMSAudit
from .train_net import auto_scale_world_size

FAMILIES = ("fcos", "fcos_heldout", "roi_encoder", "tfa", "tfa_rcnn",
            "lvis", "lvis_heldout", "owd", "rcnn")
# the results each family prints (the JAX drivers' key lines)
KEYS = {"fcos": ["coco_meta_val_all"],
        "fcos_heldout": ["coco_meta_val_novel", "coco_meta_val_base",
                         "coco_meta_val_all"],
        "roi_encoder": ["coco_meta_val_all"],
        "tfa": ["coco_pretrain_val_all"],
        "tfa_rcnn": ["coco_pretrain_val_all"],
        "lvis": ["lvis_meta_val_all"],
        "lvis_heldout": ["lvis_meta_val_all"],
        "owd": ["coco_pretrain_val_all"],
        "rcnn": ["coco_meta_val_all"]}
METRICS = ("AP", "AP50", "AP75", "nAP", "bAP", "APr", "APf", "AR@10",
           "AP_std", "nAP_std", "bAP_std", "APr_std")
PROFILE_STEPS = 20   # a stage's profiled window on a card, from step 50


def _common_shrink(cfg, iters, lr, canvas=128):
    """Shared small-scale recipe (artifacts/quality_loop/config_diff.yaml,
    the recorded Meta-FCOS recipe)."""
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.BACKBONE.FREEZE = False
    cfg.MODEL.FCOS.NUM_CLASSES = 6
    cfg.MODEL.FCOS.NUM_CLS_CONVS = 1
    cfg.MODEL.FCOS.NUM_BOX_CONVS = 1
    cfg.TPU.TRAIN_CANVAS = [canvas, canvas]
    cfg.TPU.EVAL_CANVAS = [canvas, canvas]
    cfg.TPU.SUPPORT_CANVAS = [64, 64]
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_BATCH = 4
    cfg.INPUT.MIN_SIZE_TRAIN = [canvas]
    cfg.INPUT.MIN_SIZE_TEST = canvas
    cfg.INPUT.MAX_SIZE_TEST = canvas
    cfg.INPUT.USE_SCALE_JITTER = False
    cfg.INPUT.RAND_AUGMENT = False
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.BASE_LR = lr
    cfg.SOLVER.WARMUP_ITERS = min(50, iters // 4)
    cfg.SOLVER.STEPS = [int(iters * 0.8)]
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.TEST.REPEAT_TEST = 1
    return cfg


def build_fcos_cfg(runner, iters, lr, canvas=128):
    """The recorded Meta-FCOS recipe: trained from scratch, so the box
    branch the finetune yaml freezes stays trainable."""
    cfg = runner.get_default_cfg()
    cfg.merge_from_file(
        "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml")
    _common_shrink(cfg, iters, lr, canvas)
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = False
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 5
    cfg.MODEL.META_LEARN.CLASS = 3
    cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES = False
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS = [["GN", "ReLU"]]
    cfg.TEST.REPEAT_TEST = 3
    cfg.DATASETS.TRAIN = ["coco_meta_train_all"]
    cfg.DATASETS.TEST = ["coco_meta_val_all"]
    return cfg


def _apply_overrides(cfg, args):
    """CLI overrides shared by every family (applied before the freeze)."""
    if getattr(args, "repeat_test", 0):
        cfg.TEST.REPEAT_TEST = args.repeat_test
    if getattr(args, "hard", False):
        # the 18-class hard set: more ways per episode
        if cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
            cfg.MODEL.META_LEARN.CLASS = 4
    return cfg


def _fcos_base_pretrain(args, num_classes):
    """Stage 1 of the held-out chain (Meta-FCOS-pretrain.yaml): a plain
    base-class detector whose weights seed the episodic finetune, written
    as ``base_pretrain.npz`` in the flax layout."""
    pre = MetaFCOSRunner(device=args.device)
    pcfg = pre.get_default_cfg()
    pcfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
    _common_shrink(pcfg, args.iters, args.lr, getattr(args, "canvas", 128))
    pcfg.MODEL.FCOS.NUM_CLASSES = num_classes
    pcfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
    pcfg.DATASETS.TEST = ["coco_pretrain_val_base"]
    pcfg.OUTPUT_DIR = os.path.join(args.output_dir, "pretrain")
    pcfg.freeze()
    results, model = _train_and_test(pre, pcfg, args, "pretrain")
    ckpt = save_flat_npz(os.path.join(args.output_dir, "base_pretrain.npz"),
                         model.state_dict())
    print(f"[heldout] base pretrain AP: "
          f"{results['coco_pretrain_val_base']['bbox'].get('AP')}")
    return ckpt


def run_fcos(args, heldout=False):
    runner = MetaFCOSRunner(device=args.device)
    cfg = build_fcos_cfg(runner, args.iters, args.lr,
                         getattr(args, "canvas", 128))
    if heldout:
        # meta-train on the BASE classes only (Meta-FCOS-finetune.yaml:45),
        # from the base pretrain with the finetune yaml's freezes; novel
        # classes are registered purely from K-shot supports
        n_base = len(HARD_BASE_IDS if args.hard else BASE_IDS)
        ckpt = _fcos_base_pretrain(args, n_base)
        cfg.MODEL.WEIGHTS = ckpt
        cfg.MODEL.BACKBONE.FREEZE = True
        cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = True
        cfg.DATASETS.TRAIN = ["coco_meta_train_base"]
        cfg.DATASETS.TEST = ["coco_meta_val_novel", "coco_meta_val_base",
                             "coco_meta_val_all"]
        cfg.TEST.REPEAT_TEST = 5   # reference protocol: 5 seeds, mean±std
    if getattr(args, "grad_accum", 0):
        # keep the reference batch, split it into micro-groups in the step
        cfg.TPU.GRAD_ACCUM = args.grad_accum
    if getattr(args, "ref_world", 0):
        cfg.SOLVER.REFERENCE_WORLD_SIZE = args.ref_world
        auto_scale_world_size(cfg)
    _apply_overrides(cfg, args)
    cfg.OUTPUT_DIR = args.output_dir
    cfg.freeze()
    return _train_and_test(runner, cfg, args,
                           "finetune" if heldout else "train")[0]


def build_roi_encoder_cfg(runner, iters, lr, canvas=128):
    cfg = runner.get_default_cfg()
    cfg.merge_from_file(
        "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml")
    # merge_from_file restores the yaml's CodeGenerator name; put the
    # ROIEncoder back (what MetaFCOSROIEncoderRunner.get_default_cfg sets)
    cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"
    _common_shrink(cfg, iters, lr, canvas)
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = False
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 5
    cfg.MODEL.META_LEARN.CLASS = 3
    cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES = False
    cg = cfg.MODEL.META_LEARN.CODE_GENERATOR
    cg.TRANSFORMER_ENCODER.LAYERS = 1
    cg.TRANSFORMER_ENCODER.DROPOUT = 0.0
    cfg.DATASETS.TRAIN = ["coco_meta_train_all"]
    cfg.DATASETS.TEST = ["coco_meta_val_all"]
    return cfg


def build_tfa_pretrain_cfg(runner, iters, lr, canvas=128):
    """Stage 1: a plain base-class detector."""
    cfg = runner.get_default_cfg()
    cfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
    _common_shrink(cfg, iters, lr, canvas)
    cfg.MODEL.FCOS.NUM_CLASSES = 3          # base classes only
    cfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
    cfg.DATASETS.TEST = ["coco_pretrain_val_base"]
    return cfg


def build_tfa_finetune_cfg(runner, iters, lr, weights, canvas=128):
    """Stage 2: the ``cls_logits`` surgery and a K-shot finetune over every
    class with the feature extractor frozen (only the predictor trains)."""
    cfg = runner.get_default_cfg()
    _common_shrink(cfg, iters, lr, canvas)
    cfg.MODEL.FCOS.NUM_CLASSES = 6
    cfg.MODEL.WEIGHTS = weights
    cfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS = True
    cfg.MODEL.BACKBONE.FREEZE = True
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_CLS_TOWER = True
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_TOWER = True
    cfg.DATASETS.BASE_CLASSES_SPLIT = "coco_pretrain_train_base"
    cfg.DATASETS.TRAIN = ["coco_pretrain_finetune_all"]
    cfg.DATASETS.TEST = ["coco_pretrain_val_all"]
    return cfg


def _rcnn_shrink(cfg):
    """Two-stage small-scale knobs (the ``rcnn`` family's recipe)."""
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    return cfg


def build_tfa_rcnn_pretrain_cfg(runner, iters, lr, canvas=128):
    """Stage 1: a plain base-class Faster R-CNN."""
    cfg = runner.get_default_cfg()
    cfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
    _common_shrink(cfg, iters, lr, canvas)
    _rcnn_shrink(cfg)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3      # base classes only
    cfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
    cfg.DATASETS.TEST = ["coco_pretrain_val_base"]
    return cfg


def build_tfa_rcnn_finetune_cfg(runner, iters, lr, weights, canvas=128):
    """Stage 2: the box-head surgery and a K-shot finetune over every class
    with the backbone and the box-head features frozen; the cosine
    classifier and the box predictor train. The RPN stays trainable: on
    the hue-keyed synthetic set a frozen base-class RPN scores novel hues
    as background."""
    cfg = runner.get_default_cfg()
    _common_shrink(cfg, iters, lr, canvas)
    _rcnn_shrink(cfg)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 6
    cfg.MODEL.WEIGHTS = weights
    cfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS = True
    cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = True  # cosine ROI output layer
    cfg.MODEL.BACKBONE.FREEZE = True
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE = False
    cfg.MODEL.ROI_HEADS.FREEZE_FEAT = True
    cfg.DATASETS.BASE_CLASSES_SPLIT = "coco_pretrain_train_base"
    cfg.DATASETS.TRAIN = ["coco_pretrain_finetune_all"]
    cfg.DATASETS.TEST = ["coco_pretrain_val_all"]
    return cfg


def run_tfa_rcnn(args):
    # ---- stage 1: base pretrain (plain two-stage detector)
    pre = MetaFasterRCNNRunner(device=args.device)
    pcfg = build_tfa_rcnn_pretrain_cfg(pre, args.iters, args.lr,
                                       getattr(args, "canvas", 128))
    if args.hard:
        pcfg.MODEL.ROI_HEADS.NUM_CLASSES = len(HARD_BASE_IDS)
    pcfg.OUTPUT_DIR = os.path.join(args.output_dir, "pretrain")
    pcfg.freeze()
    base_results, model = _train_and_test(pre, pcfg, args, "pretrain")
    ckpt = save_flat_npz(os.path.join(args.output_dir, "base_pretrain.npz"),
                         model.state_dict())
    print(f"[tfa_rcnn] base pretrain AP: "
          f"{base_results['coco_pretrain_val_base']['bbox'].get('AP')}")

    # ---- stage 2: surgery + frozen-feature cosine finetune
    ft = TFAFasterRCNNRunner(device=args.device)
    fcfg = build_tfa_rcnn_finetune_cfg(ft, args.iters, args.lr * 0.5, ckpt,
                                       getattr(args, "canvas", 128))
    if args.hard:
        fcfg.MODEL.ROI_HEADS.NUM_CLASSES = len(HARD_ALL_IDS)
    _apply_overrides(fcfg, args)
    fcfg.OUTPUT_DIR = os.path.join(args.output_dir, "finetune")
    fcfg.freeze()
    results = _train_and_test(ft, fcfg, args, "finetune")[0]
    results["base_pretrain"] = base_results["coco_pretrain_val_base"]
    return results


def build_owd_cfg(runner, iters, lr, canvas=128):
    """Open-world pretraining (Base-Meta-FCOS-pretrain_owd.yaml): the cls
    loss dropped, objectness from the IoU head alone; trained on the base
    classes, scored class-agnostic on every class."""
    cfg = runner.get_default_cfg()
    cfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
    _common_shrink(cfg, iters, lr, canvas)
    cfg.MODEL.FCOS.NUM_CLASSES = 3           # base classes only
    cfg.MODEL.PROPOSAL_GENERATOR.OWD = True
    cfg.MODEL.FCOS.BOX_QUALITY = ["iou"]
    cfg.MODEL.FCOS.IOU_MASK = True
    cfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
    cfg.DATASETS.TEST = ["coco_pretrain_val_all"]
    return cfg


def run_owd(args):
    runner = MetaFCOSRunner(device=args.device)
    cfg = build_owd_cfg(runner, args.iters, args.lr,
                        getattr(args, "canvas", 128))
    if args.hard:
        cfg.MODEL.FCOS.NUM_CLASSES = len(HARD_BASE_IDS)
    _apply_overrides(cfg, args)
    cfg.OUTPUT_DIR = args.output_dir
    cfg.freeze()
    return _train_and_test(runner, cfg, args, "train")[0]


def build_lvis_cfg(runner, iters, lr, canvas=128):
    cfg = runner.get_default_cfg()
    cfg.merge_from_file(
        "sylph://LVISv1-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml")
    _common_shrink(cfg, iters, lr, canvas)
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = False
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 5
    cfg.MODEL.META_LEARN.CLASS = 3
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS = [["GN", "ReLU"]]
    # chunked all-GT accumulation for the frequent (base) classes; rare
    # classes keep their few-shot codes
    cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES = True
    cfg.DATASETS.TRAIN = ["lvis_meta_train_all"]
    cfg.DATASETS.TEST = ["lvis_meta_val_all"]
    return cfg


def _lvis_data(args, heldout: bool) -> None:
    """The family's synthetic LVIS set under ``{data_root}/lvis``: the
    18-class hue wheel (12 frequent + 6 rare) held out, 3 + 3 classes
    otherwise. A leftover json of the other family is rebuilt, not reused:
    it would train NUM_CLASSES 12 against a 3-class set and score APr ~0
    with no error."""
    lvis_root = os.path.join(args.data_root, "lvis")
    train_json = os.path.join(lvis_root, "lvis_v1_train.json")
    want_cats = 18 if heldout else 6
    have_cats = None
    if os.path.exists(train_json):
        with open(train_json) as f:
            have_cats = len(json.load(f)["categories"])
    if have_cats != want_cats:
        if have_cats is not None:
            print(f"[lvis] rebuilding synthetic set: existing json has "
                  f"{have_cats} categories, this family needs {want_cats}")
        if heldout:
            make_learnable_lvis(lvis_root, args.data_root, n_train=180,
                                n_val=45, wheel=True)
        else:
            make_learnable_lvis(lvis_root, args.data_root)
    register_all_lvis(lvis_root, args.data_root)


def run_lvis(args, heldout=False):
    _lvis_data(args, heldout)
    runner = MetaFCOSRunner(device=args.device)
    cfg = build_lvis_cfg(runner, args.iters, args.lr,
                         getattr(args, "canvas", 128))
    if heldout:
        # meta-train on the frequent classes only (LVISv1
        # Meta-FCOS-finetune.yaml:63 `lvis_meta_train_basefc`) from a base
        # pretrain, then the federated eval over every class: rare classes
        # never give a gradient
        pre = MetaFCOSRunner(device=args.device)
        pcfg = pre.get_default_cfg()
        pcfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
        _common_shrink(pcfg, args.iters, args.lr,
                       getattr(args, "canvas", 128))
        pcfg.MODEL.FCOS.NUM_CLASSES = 12      # wheel frequent classes
        pcfg.DATASETS.TRAIN = ["lvis_pretrain_train_basefc"]
        pcfg.DATASETS.TEST = ["lvis_pretrain_val_basefc"]
        pcfg.OUTPUT_DIR = os.path.join(args.output_dir, "pretrain")
        pcfg.freeze()
        pres, pmodel = _train_and_test(pre, pcfg, args, "pretrain")
        ckpt = save_flat_npz(
            os.path.join(args.output_dir, "base_pretrain.npz"),
            pmodel.state_dict())
        print(f"[lvis-heldout] base pretrain AP: "
              f"{pres['lvis_pretrain_val_basefc']['bbox'].get('AP')}")
        cfg.MODEL.WEIGHTS = ckpt
        cfg.MODEL.BACKBONE.FREEZE = True
        cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = True
        cfg.DATASETS.TRAIN = ["lvis_meta_train_basefc"]
        cfg.DATASETS.TEST = ["lvis_meta_val_all"]
        cfg.MODEL.META_LEARN.CLASS = 3   # 3-way episodes on 12 classes
        cfg.TEST.REPEAT_TEST = 5
    _apply_overrides(cfg, args)
    cfg.OUTPUT_DIR = args.output_dir
    cfg.freeze()
    return _train_and_test(runner, cfg, args,
                           "finetune" if heldout else "train")[0]


def run_roi_encoder(args):
    runner = MetaFCOSROIEncoderRunner(device=args.device)
    cfg = build_roi_encoder_cfg(runner, args.iters, args.lr,
                                getattr(args, "canvas", 128))
    if getattr(args, "ref_depth", False):
        # the stack the shipped configs use (LVISv1 Meta-FCOS-ROI-Encoder-
        # finetune.yaml:45-52) instead of the thinned LAYERS=1 chain
        cg = cfg.MODEL.META_LEARN.CODE_GENERATOR
        cg.TRANSFORMER_ENCODER.LAYERS = 2
        cg.TRANSFORMER_ENCODER.DROPOUT = 0.1
        cg.TOKENIZER.NUM_CONV = 2
        cg.TOKENIZER.NUM_FC = 2
        cg.HEAD.NUM_FC = 2
    _apply_overrides(cfg, args)
    cfg.OUTPUT_DIR = args.output_dir
    cfg.freeze()
    return _train_and_test(runner, cfg, args, "train")[0]


def run_tfa(args):
    # ---- stage 1: base pretrain
    pre = MetaFCOSRunner(device=args.device)
    pcfg = build_tfa_pretrain_cfg(pre, args.iters, args.lr,
                                  getattr(args, "canvas", 128))
    pcfg.OUTPUT_DIR = os.path.join(args.output_dir, "pretrain")
    pcfg.freeze()
    base_results, model = _train_and_test(pre, pcfg, args, "pretrain")
    ckpt = save_flat_npz(os.path.join(args.output_dir, "base_pretrain.npz"),
                         model.state_dict())
    print(f"[tfa] base pretrain AP: "
          f"{base_results['coco_pretrain_val_base']['bbox'].get('AP')}")

    # ---- stage 2: surgery + finetune over all classes
    ft = TFAFewShotDetectionRunner(device=args.device)
    fcfg = build_tfa_finetune_cfg(ft, args.iters, args.lr * 0.5, ckpt,
                                  getattr(args, "canvas", 128))
    _apply_overrides(fcfg, args)
    fcfg.OUTPUT_DIR = os.path.join(args.output_dir, "finetune")
    fcfg.freeze()
    results = _train_and_test(ft, fcfg, args, "finetune")[0]
    results["base_pretrain"] = base_results["coco_pretrain_val_base"]
    return results


def build_cfg(runner, iters, lr):
    """The ``rcnn`` family (the JAX package's tools/quality_loop_rcnn.py
    ``build_cfg``): Meta Faster R-CNN meta-trained on every class."""
    cfg = runner.get_default_cfg()
    cfg.merge_from_file(
        "sylph://LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-finetune.yaml")
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.BACKBONE.FREEZE = False
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 6
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 5
    cfg.MODEL.META_LEARN.CLASS = 3
    cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES = False
    cfg.MODEL.META_LEARN.CODE_GENERATOR.OUT_CHANNEL = 128
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS = [["GN", "ReLU"]]
    cfg.TPU.TRAIN_CANVAS = [128, 128]
    cfg.TPU.EVAL_CANVAS = [128, 128]
    cfg.TPU.SUPPORT_CANVAS = [64, 64]
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_BATCH = 4
    cfg.INPUT.MIN_SIZE_TRAIN = [128]
    cfg.INPUT.MIN_SIZE_TEST = 128
    cfg.INPUT.MAX_SIZE_TEST = 128
    cfg.INPUT.USE_SCALE_JITTER = False
    cfg.INPUT.RAND_AUGMENT = False
    # modest proposal budgets: plenty for <= 2 GT boxes per 128px image
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    cfg.TEST.REPEAT_TEST = 1
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.BASE_LR = lr
    cfg.SOLVER.WARMUP_ITERS = min(50, iters // 4)
    cfg.SOLVER.STEPS = [int(iters * 0.8)]
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.DATASETS.TRAIN = ["coco_meta_train_all"]
    cfg.DATASETS.TEST = ["coco_meta_val_all"]
    return cfg


def run_rcnn(args):
    runner = MetaFasterRCNNRunner(device=args.device)
    cfg = build_cfg(runner, args.iters, args.lr)
    cfg.OUTPUT_DIR = args.output_dir
    cfg.freeze()
    return _train_and_test(runner, cfg, args, "train")[0]


RUNS = {"fcos": run_fcos,
        "fcos_heldout": lambda a: run_fcos(a, heldout=True),
        "roi_encoder": run_roi_encoder, "tfa": run_tfa,
        "tfa_rcnn": run_tfa_rcnn, "lvis": run_lvis,
        "lvis_heldout": lambda a: run_lvis(a, heldout=True),
        "owd": run_owd, "rcnn": run_rcnn}


# ------------------------------------------------------------ one stage
class _StageClock:
    """Times one stage's training around the step function, which it wraps
    on the runner instance: when the first step is called and, on a card,
    one ``torch.profiler`` window over ``steps`` whole iterations from
    iteration ``first``. ``close(wall_s, loop_times)`` unwraps it and splits
    ``do_train``'s wall time into parts; the profiler's own time (its start,
    its stop and the parse of its events, and what the traced steps took
    beyond the median step) is one part, kept out of ``train_s``."""

    def __init__(self, runner, first: Optional[int] = None, steps: int = 0):
        self.first, self.steps = first, steps
        self.prof, self.t0, self.wall_ms = None, None, None
        self.busy_ms = None
        self.t_do_train = None   # set by the caller before do_train
        self.t_first_call = None
        self.profiler_s = 0.0   # in _start and _stop
        self.runner = runner
        make = runner.make_train_step

        def make_timed(cfg, model):
            step = make(cfg, model)
            calls = [0]

            def timed(state, batch):
                i = calls[0]
                calls[0] += 1
                if self.t_first_call is None:
                    self.t_first_call = time.perf_counter()
                if i == self.first:
                    self._start()
                elif self.first is not None and i == self.first + self.steps:
                    self._stop()
                return step(state, batch)
            return timed

        runner.make_train_step = make_timed

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.profiler_s += self.t0 - t

    def _stop(self):
        if self.prof is None or self.wall_ms is not None:
            return
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.wall_ms = (t - self.t0) * 1e3
        self.prof.stop()
        from torch.autograd import DeviceType
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in self.prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for s, e in spans:           # the union of the kernels' spans, us
            if e > end:
                busy += e - max(s, end)
                end = e
        self.busy_ms = busy / 1e3 if spans else None
        self.profiler_s += time.perf_counter() - t

    def close(self, wall_s: Optional[float],
              loop_times: List[tuple]) -> Dict:
        """-> ``train_s`` (``wall_s`` less the profiler's part), its parts
        (they add up to it) and the profiled window; None for the times
        when training failed."""
        self._stop()
        del self.runner.make_train_step   # the class's method again
        profile = None
        if self.wall_ms is not None:
            profile = {"first_step": self.first, "steps": self.steps,
                       "wall_ms": self.wall_ms,
                       "device_busy_ms": self.busy_ms,
                       "idle_share": (None if self.busy_ms is None else
                                      1.0 - self.busy_ms / self.wall_ms)}
        if wall_s is None or not loop_times:
            return {"train_s": None, "parts": None, "profiler_s": None,
                    "profile": profile}
        steps = [d + s for d, s in loop_times]
        median = statistics.median(steps)
        # the traced steps' time beyond the median step's
        traced_s = (0.0 if self.wall_ms is None else
                    max(0.0, self.wall_ms / 1e3 - self.steps * median))
        profiler_s = self.profiler_s + traced_s
        # _start and _stop run inside a step's time, the traced steps too
        steps_s = sum(steps) - profiler_s
        before_s = self.t_first_call - self.t_do_train - loop_times[0][0]
        parts = {
            "setup_s": before_s,           # optimizer, restore, loaders
            "first_batch_s": loop_times[0][0],
            "median_steps_s": len(steps) * median,
            "steps_over_median_s": (steps_s - loop_times[0][0]
                                    - len(steps) * median),
            # metrics, periodic hooks, the final checkpoint, the closes
            "outside_steps_s": wall_s - before_s - sum(steps)}
        return {"train_s": wall_s - profiler_s, "parts": parts,
                "profiler_s": profiler_s, "profile": profile}


def _total_losses(metrics: List[Dict[str, float]]) -> List[float]:
    return [sum(v for k, v in m.items() if k.startswith("loss"))
            for m in metrics]


def _train_and_test(runner, cfg, args, stage: str):
    """One stage: the launch files, the model from the flax initializers'
    distributions with MODEL.WEIGHTS over it, ``do_train``, then
    ``do_test`` with the weights the config evaluates (the EMA's when
    MODEL_EMA is on). ``args.seed``, when set, is every stage's SEED.
    -> (results, model); the stage's numbers go to ``args.stages`` when
    the caller keeps that list."""
    if getattr(args, "seed", None) is not None:
        cfg.defrost()
        cfg.SEED = args.seed
        cfg.freeze()
    setup_after_launch(cfg, cfg.OUTPUT_DIR,
                       default_cfg=runner.get_default_cfg())
    model = runner.build_model(cfg, init="train")
    audit: Optional[NMSAudit] = getattr(args, "audit", None)
    first = min(50, cfg.SOLVER.MAX_ITER // 2)
    clock = (_StageClock(runner, first, max(1, min(
        PROFILE_STEPS, cfg.SOLVER.MAX_ITER - first - 1)))
        if runner.device.type == "cuda" else _StageClock(runner))
    wall_s = None
    t0 = clock.t_do_train = time.perf_counter()
    try:
        model, state = runner.do_train(cfg, model)
        wall_s = time.perf_counter() - t0
    finally:
        timed = clock.close(wall_s, runner.loop_times)
    train_launches = audit.flush(f"{stage}:train") if audit else None
    model.load_state_dict(runner.eval_params(cfg, state), strict=False)
    t0 = time.perf_counter()
    results = runner.do_test(cfg, model, step=state.step)
    test_s = time.perf_counter() - t0
    test_launches = audit.flush(f"{stage}:test") if audit else None
    if getattr(args, "stages", None) is not None:
        steps = [d + s for d, s in runner.loop_times]
        losses = _total_losses(runner.train_metrics)
        head = max(1, min(10, len(losses) // 4))
        args.stages.append({
            "stage": stage, "runner": type(runner).__name__,
            "iters": len(steps), "train_s": timed["train_s"],
            "train_wall_s": wall_s, "train_parts": timed["parts"],
            "profiler_s": timed["profiler_s"], "test_s": test_s,
            "median_step_ms": (1e3 * statistics.median(steps)
                               if steps else None),
            "median_data_wait_ms": (1e3 * statistics.median(
                d for d, _ in runner.loop_times) if steps else None),
            "loss_first": (statistics.fmean(losses[:head])
                           if losses else None),
            "loss_last": (statistics.fmean(losses[-head:])
                          if losses else None),
            "ap": {name: res["bbox"].get("AP")
                   for name, res in results.items()},
            "profile": timed["profile"], "nms_launches_train": train_launches,
            "nms_launches_test": test_launches})
    return results, model


# ------------------------------------------------------------------ main
def prepare_data(args) -> None:
    """The learnable synthetic COCO set at ``--data-root`` when it has no
    annotations (the hard 18-class set with ``--hard``), registered in a
    freshly cleared catalog."""
    if not os.path.exists(os.path.join(args.data_root, "annotations")):
        if args.hard:
            # 18 classes need more train supports + val GT for stable AP;
            # images stay small so the 128-canvas recipe applies
            make_learnable_coco(args.data_root, n_train=180, n_val=45,
                                img_hw=(128, 128), n_empty_val=2, hard=True)
        else:
            make_learnable_coco(args.data_root, n_train=80, n_val=16,
                                img_hw=(128, 128), n_empty_val=2)
    DatasetCatalog.clear()
    MetadataCatalog.clear()
    register_all_coco(args.data_root)


def card_line() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def summarize(family: str, results: Dict) -> Dict:
    """The family's key metrics from its results (and the base stage's AP
    where it has one)."""
    summary = {}
    for key in KEYS[family]:
        bbox = results[key]["bbox"]
        summary[key] = {k: bbox[k] for k in METRICS if k in bbox}
    if "base_pretrain" in results:
        summary["base_pretrain"] = {
            "AP": results["base_pretrain"]["bbox"].get("AP")}
    return summary


def train_and_score(args) -> Dict:
    """The main path: ``args.family`` trained and scored; on a card every
    NMS launch held against the twin (``args.audit``, left installed for
    ``report``). -> its results; ``args.wall_s`` and ``args.stages`` hold
    the run's times."""
    device = resolve_device(args.device)
    args.device = str(device)
    if args.output_dir is None:
        args.output_dir = f"output/quality_loop_{args.family}"
    os.makedirs(args.output_dir, exist_ok=True)
    args.stages = []
    args.audit = NMSAudit().install() if device.type == "cuda" else None
    t0 = time.perf_counter()
    try:
        prepare_data(args)
        results = RUNS[args.family](args)
    except BaseException:
        if args.audit is not None:
            args.audit.uninstall()
        raise
    args.wall_s = time.perf_counter() - t0
    return results


def report(args, results: Dict) -> Dict:
    """After ``train_and_score``: on a card the kernel timed at each shape
    the run gave it (launches that add to the kernel's counts after the
    run), then ``eval_results.json``, ``run_stats.json``, the family's key
    lines and one ``quality_loop`` JSON line. -> the results."""
    check = args.audit is not None
    try:
        shapes = args.audit.time_shapes() if check else []
    finally:
        if check:
            args.audit.uninstall()
    with open(os.path.join(args.output_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    summary = summarize(args.family, results)
    for key in KEYS[args.family]:
        print(key, json.dumps(summary[key], indent=2, default=float))
    stats = {"family": args.family, "iters": args.iters, "lr": args.lr,
             "hard": bool(args.hard), "seed": getattr(args, "seed", None),
             "device": args.device, "card": card_line() if check else None,
             "wall_s": args.wall_s, "stages": args.stages,
             "nms": {"launches_by_label": (args.audit.by_label
                                           if check else None),
                     "all_equal_to_twin": check, "shapes": shapes},
             "metrics": summary}
    with open(os.path.join(args.output_dir, "run_stats.json"), "w") as f:
        json.dump(stats, f, indent=2, default=float)
    print(json.dumps({"quality_loop": args.family, "wall_s": args.wall_s,
                      "metrics": summary,
                      "stages": [{k: s[k] for k in (
                          "stage", "train_s", "test_s", "median_step_ms",
                          "loss_first", "loss_last")} for s in args.stages],
                      "nms_launches": (sum(args.audit.by_label.values())
                                       if check else None),
                      "card": stats["card"]}, default=float), flush=True)
    return results


def run(args) -> Dict:
    """Run ``args.family`` end to end; -> its results. Writes
    ``eval_results.json`` and ``run_stats.json`` into ``args.output_dir``
    and prints the family's key lines and one ``quality_loop`` JSON
    line."""
    return report(args, train_and_score(args))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", choices=FAMILIES, required=True)
    p.add_argument("--hard", action="store_true",
                   help="the discriminative 18-class hard synthetic set "
                        "(distractors, overlap, confusable hues)")
    p.add_argument("--repeat-test", type=int, default=0,
                   help="override TEST.REPEAT_TEST (the reference protocol "
                        "is 5 seeds, mean±std)")
    p.add_argument("--ref-depth", action="store_true",
                   help="roi_encoder only: the transformer stack the "
                        "shipped configs use (LAYERS=2, dropout 0.1, deep "
                        "tokenizer and head)")
    p.add_argument("--grad-accum", type=int, default=0,
                   help="fcos only: set TPU.GRAD_ACCUM")
    p.add_argument("--ref-world", type=int, default=0,
                   help="fcos only: set SOLVER.REFERENCE_WORLD_SIZE and "
                        "apply auto_scale_world_size")
    p.add_argument("--data-root", required=True)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
