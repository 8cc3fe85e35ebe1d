"""Model construction and the runner (port of
sylph_tpu/runner/meta_fcos_runner.py): ``build_model_from_cfg``,
``_codegen_kwargs``, ``_decode_cfg``, ``_freeze_cfg``, ``_loss_cfg``,
``_mapper``, ``MetaFCOSRunner`` (``get_default_cfg``, ``build_model`` with
MODEL.WEIGHTS loading, ``do_train`` in both modes, ``get_evaluator``,
``do_test``), its variants ``MetaFCOSROIEncoderRunner`` (the ROIEncoder code
generator) and ``TFAFewShotDetectionRunner`` (the TFA finetune through the
plain path, with the base-class ``cls_logits`` surgery) and
``create_runner`` (which also builds the two-stage runners of
``meta_faster_rcnn_runner.py``).

The repo ships no checkpoint, so weights start from an explicit
``torch.Generator`` seed in one of two ways:
  * ``init_random_weights`` (serving and meta-test checks): detectron2-style
    fan-in scaled convs and random frozen-BN statistics, so activations stay
    O(1) through the full-depth network and random codes give detections;
  * ``init_train_weights`` (a training run from scratch): the flax
    initializers' distributions (lecun-normal backbone and FPN, normal(0.01)
    heads, the focal prior on ``cls_logits``, unit norms and scales).
MODEL.WEIGHTS overlays a flat ``.npz`` of flax params (the JAX package's
layout), one of the port's own checkpoints, or a detectron2 ``.pth`` /
``.pkl`` file (``utils/convert_d2.py``).

A runner given a data-parallel ``group`` (``parallel/mesh.py``, one process
per rank) trains on its rank's slice of every batch, averages gradients
across the ranks each step, and shards the meta-test's registration over
them; rank 0 alone writes checkpoints, metrics and TensorBoard events, and
every rank restores behind a barrier. Every rank holds the same parameters
after every step.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from .config import CfgNode, get_default_cfg
from .data.catalog import DatasetCatalog, MetadataCatalog
from .data.loader import (_POOL, build_episodic_train_loader,
                          build_pretrain_loader)
from .data.mapper import EpisodicMapper
from .data.meta_dataset import MetaDataset, temp_seed
from .evaluation.evaluators import (AREvaluator, COCOMetaEvaluator,
                                    COCOOWDEvaluator, FewshotLVISEvaluator)
from .evaluation.postprocess import detections_to_coco_results
from .models.fcos_head import FCOSHead
from .models.layers import Conv2d, GroupNorm, Scale
from .models.meta_arch import MetaOneStageDetector
from .models.rcnn import ROIBoxHead
from .models.resnet import FrozenBatchNorm
from .models.roi_encoder import ROIEncoder
from .ops.deform_conv import DFConv2d
from .ops.decode import DecodeCfg, decode_proposals
from .ops.fcos_losses import FCOSLossCfg
from .ops.locations import build_location_grid
from .parallel.mesh import DataGroup
from .train.checkpoint import (CheckpointManager, filter_params_by_module,
                               load_params_any, merge_state_dict)
from .train.optimizer import build_freeze_mask, build_optimizer
from .train.steps import make_episodic_train_step, make_pretrain_train_step
from .train.train_state import TrainState
from .utils.convert_d2 import (convert_detectron2_checkpoint,
                               load_torch_state_dict)
from .utils.convert_weights import state_dict_from_jax
from .utils.events import AbnormalLossChecker, MetricsWriter
from .utils.tb_writer import write_eval_results_tb

BN_EPS = 1e-5


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is
    none raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def _codegen_kwargs(cfg) -> Dict:
    cg = cfg.MODEL.META_LEARN.CODE_GENERATOR
    if cg.NAME == "ROIEncoder":
        return dict(
            pooler_resolution=cg.ROI_BOX.POOLER_RESOLUTION,
            tokenizer_num_conv=cg.TOKENIZER.NUM_CONV,
            tokenizer_conv_dim=cg.TOKENIZER.CONV_DIM,
            tokenizer_norm=cg.TOKENIZER.NORM,
            tokenizer_num_fc=cg.TOKENIZER.NUM_FC,
            tokenizer_fc_dim=cg.TOKENIZER.FC_DIM,
            transformer_layers=cg.TRANSFORMER_ENCODER.LAYERS,
            transformer_heads=cg.TRANSFORMER_ENCODER.HEADS,
            transformer_dropout=cg.TRANSFORMER_ENCODER.DROPOUT,
            head_num_fc=cg.HEAD.NUM_FC, head_fc_dim=cg.HEAD.FC_DIM,
            head_output_dim=cg.HEAD.OUTPUT_DIM)
    return dict(
        pooler_resolution=cg.ROI_BOX.POOLER_RESOLUTION,
        out_channel=cg.OUT_CHANNEL,
        tower_layers=tuple(tuple(t) for t in cg.TOWER_LAYERS),
        cls_layer=tuple(cg.CLS_LAYER), bias_layer=tuple(cg.BIAS_LAYER),
        weight_layer=tuple(cg.WEIGHT_LAYER),
        scale_layer=tuple(cg.SCALE_LAYER), conv_l2_norm=cg.CONV_L2_NORM,
        bias_l2_norm=cg.BIAS_L2_NORM,
        post_norm=cg.POST_NORM, use_weight_scale=cg.USE_WEIGHT_SCALE,
        compress_code_w_max=cg.COMPRESS_CODE_W_MAX,
        meta_bias=cg.META_BIAS, contrastive_loss=cg.CONTRASTIVE_LOSS)


def _decode_cfg(cfg, train: bool = False) -> DecodeCfg:
    f = cfg.MODEL.FCOS
    return DecodeCfg(
        pre_nms_thresh=(f.INFERENCE_TH_TRAIN if train else
                        f.INFERENCE_TH_TEST),
        pre_nms_topk=(f.PRE_NMS_TOPK_TRAIN if train else
                      f.PRE_NMS_TOPK_TEST),
        post_nms_topk=(f.POST_NMS_TOPK_TRAIN if train else
                       f.POST_NMS_TOPK_TEST),
        nms_thresh=f.NMS_TH, thresh_with_ctr=f.THRESH_WITH_CTR,
        box_quality=tuple(sorted(f.BOX_QUALITY)),
        owd=cfg.MODEL.PROPOSAL_GENERATOR.OWD)


# Random frozen-BN statistics leave the R-50 FPN maps of 0-255 pixels at a
# standard deviation of ~80-230 (P6-P2, measured on the CPU at 128x128). The
# two-stage heads have no normalization, so the layers that read those maps
# are scaled down to give O(1) objectness and class logits, and the box
# regressions to give deltas of ~0.1: proposals stay near their anchors and
# the class softmax stays spread, as a run of random weights needs.
_RANDOM_GAIN = {"rpn_head.conv": 0.01, "rpn_head.anchor_deltas": 0.1,
                "box_head.fc1": 0.01, "box_head.bbox_pred": 0.1}


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer from a CPU ``torch.Generator``:
    fan-in scaled conv and linear weights (times ``_RANDOM_GAIN`` on the
    two-stage heads), random frozen-BN statistics, GroupNorm and scales
    near their identity, the two-stage box head's rows at unit scale.

    The draws happen on the CPU and are copied to the model's device, so a
    model built on ``cuda`` and one built on ``cpu`` from the same seed hold
    the same weights.
    """
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    for name, module in model.named_modules():
        if isinstance(module, (Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.copy_(randn(*module.weight.shape)
                                * _RANDOM_GAIN.get(name, 1.0)
                                / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.copy_(0.1 * randn(*module.bias.shape))
        elif isinstance(module, ROIBoxHead):
            _init_box_head_params(module, randn, 1.0 / math.sqrt(
                module.fc_dim))
        elif isinstance(module, DFConv2d):
            module.weight.copy_(randn(*module.weight.shape)
                                / math.sqrt(module.weight[0].numel()))
            module.bias.copy_(0.1 * randn(*module.bias.shape))
        elif isinstance(module, FCOSHead) and module.l2_norm_cls_weight:
            c = module.cosine_gn_scale.numel()
            module.cosine_weight.copy_(randn(*module.cosine_weight.shape))
            module.cosine_bias.copy_(0.1 * randn(*module.cosine_bias.shape))
            module.cosine_scale.copy_(0.1 * randn())
            module.cosine_gn_scale.copy_(1.0 + 0.1 * randn(c))
            module.cosine_gn_bias.copy_(0.1 * randn(c))
        elif isinstance(module, FrozenBatchNorm):
            c = module.scale.numel()
            gamma = 1.0 + 0.1 * randn(c)
            beta = 0.1 * randn(c)
            mean = 0.1 * randn(c)
            var = 0.8 + 0.4 * torch.rand((c,), generator=gen)
            scale = gamma / torch.sqrt(var + BN_EPS)
            module.scale.copy_(scale)
            module.bias.copy_(beta - mean * scale)
        elif isinstance(module, (GroupNorm, nn.LayerNorm)):
            c = module.weight.numel()
            module.weight.copy_(1.0 + 0.1 * randn(c))
            module.bias.copy_(0.1 * randn(c))
        elif isinstance(module, Scale):
            module.scale.copy_(module.init_value * (1.0 + 0.1 * randn()))
    cg = getattr(model, "code_generator", None)
    if getattr(cg, "meta_bias", False):
        cg.meta_bias_value.fill_(cg.prior)
    return model


# flax lecun_normal: a normal truncated at +-2 std, scaled so its std is
# sqrt(1 / fan_in) (jax.nn.initializers.variance_scaling)
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_train_weights(model: nn.Module, seed: int,
                       prior_prob: float = 0.01) -> nn.Module:
    """Fill every parameter and buffer from the JAX package's initializers
    (their distributions, not their draws), drawn on the CPU from a
    ``torch.Generator`` and copied to the model's device:

      * backbone and FPN convs: lecun normal (flax ``nn.Conv`` default),
        biases 0; FrozenBN scale 1, bias 0;
      * FCOS head and CodeGenerator convs: normal(0.01), biases 0, with
        ``cls_logits``'s bias at the focal prior -log((1 - p) / p)
        (fcos_head.py:49-50, 126-137; code_generator.py:56); the cosine
        classifier's weight normal(0.01), bias at the prior, scale 0;
        a ``DFConv2d``'s kernel normal(0.01) and its ``offset`` conv 0;
      * the ROIEncoder's convs and Dense layers lecun normal (flax's
        defaults), biases 0;
      * GroupNorm and LayerNorm scale 1, bias 0; every ``Scale`` at its init
        value; ``meta_bias_value`` at the prior (code_generator.py:217).
    """
    gen = torch.Generator().manual_seed(seed)
    prior = -math.log((1 - prior_prob) / prior_prob)
    roi_encoder = isinstance(getattr(model, "code_generator", None),
                             ROIEncoder)
    offsets = {f"{n}.offset" for n, m in model.named_modules()
               if isinstance(m, DFConv2d)}

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen)

    for name, module in model.named_modules():
        if isinstance(module, (Conv2d, nn.Linear)):
            shape = module.weight.shape
            std = {"box_head.cls_score": 0.01,
                   "box_head.bbox_pred": 0.001}.get(name)
            small = name.startswith(("fcos_head.", "rpn_head.")) or (
                name.startswith("code_generator.") and not roi_encoder)
            if name in offsets:
                w = torch.zeros(shape)
            elif std is not None or small:
                w = normal(shape, 0.01 if std is None else std)
            else:
                std = math.sqrt(1.0 / module.weight[0].numel()) \
                    / _TRUNC_NORMAL_STD
                w = torch.nn.init.trunc_normal_(
                    torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                    generator=gen) * std
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.fill_(prior if name == "fcos_head.cls_logits"
                                  else 0.0)
        elif isinstance(module, ROIBoxHead):
            _init_box_head_params(module, lambda *shape: normal(shape, 1.0),
                                  0.01)
        elif isinstance(module, DFConv2d):
            module.weight.copy_(normal(module.weight.shape, 0.01))
            module.bias.fill_(0.0)
        elif isinstance(module, FCOSHead) and module.l2_norm_cls_weight:
            module.cosine_weight.copy_(normal(module.cosine_weight.shape,
                                              0.01))
            module.cosine_bias.fill_(prior)
            module.cosine_scale.fill_(0.0)
            module.cosine_gn_scale.fill_(1.0)
            module.cosine_gn_bias.fill_(0.0)
        elif isinstance(module, FrozenBatchNorm):
            module.scale.fill_(1.0)
            module.bias.fill_(0.0)
        elif isinstance(module, (GroupNorm, nn.LayerNorm)):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
        elif isinstance(module, Scale):
            module.scale.fill_(module.init_value)
    cg = getattr(model, "code_generator", None)
    if getattr(cg, "meta_bias", False):
        cg.meta_bias_value.fill_(cg.prior)
    return model


def _init_box_head_params(head: ROIBoxHead, randn, std: float) -> None:
    """The two-stage box head's own parameters: ``cosine_weight`` and
    ``bg_weight`` normal(std), ``bg_bias`` 0, ``cosine_scale_param`` 20."""
    for name in ("cosine_weight", "bg_weight"):
        if hasattr(head, name):
            p = getattr(head, name)
            p.copy_(std * randn(*p.shape))
    if hasattr(head, "bg_bias"):
        head.bg_bias.fill_(0.0)
    if hasattr(head, "cosine_scale_param"):
        head.cosine_scale_param.fill_(20.0)


def build_model_from_cfg(cfg, device: Union[str, torch.device] = "cuda",
                         seed: int = None, init: str = "random"
                         ) -> MetaOneStageDetector:
    """MetaOneStageDetector for ``cfg`` on ``device``, initialized from
    ``seed`` (default ``max(cfg.SEED, 0)``) by ``init_random_weights``
    (``init="random"``) or ``init_train_weights`` (``init="train"``), in
    eval mode (the port has no train-mode layers: FrozenBN, GroupNorm).

    Parameters are float32; activations run in ``TPU.COMPUTE_DTYPE``, with
    GroupNorm and logits in float32.
    """
    dev = resolve_device(device)
    episodic = cfg.MODEL.META_LEARN.EPISODIC_LEARNING
    with torch.device("meta"):
        model = MetaOneStageDetector(
            depth=cfg.MODEL.RESNETS.DEPTH,
            backbone_out_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
            fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            fpn_top_levels=cfg.MODEL.FPN.TOP_LEVELS,
            num_classes=cfg.MODEL.FCOS.NUM_CLASSES,
            num_cls_convs=cfg.MODEL.FCOS.NUM_CLS_CONVS,
            num_box_convs=cfg.MODEL.FCOS.NUM_BOX_CONVS,
            num_share_convs=cfg.MODEL.FCOS.NUM_SHARE_CONVS,
            fcos_norm=cfg.MODEL.FCOS.NORM,
            use_scale=cfg.MODEL.FCOS.USE_SCALE,
            prior_prob=cfg.MODEL.FCOS.PRIOR_PROB,
            cls_kernel_size=cfg.MODEL.FCOS.CLS_LOGITS_KERNEL_SIZE,
            l2_norm_cls_weight=cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT,
            use_deformable=cfg.MODEL.FCOS.USE_DEFORMABLE,
            fpn_strides=tuple(cfg.MODEL.FCOS.FPN_STRIDES),
            code_generator_name=(cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME
                                 if episodic else "none"),
            code_generator_kwargs=_codegen_kwargs(cfg) if episodic else None,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            s2d_stem=cfg.TPU.S2D_STEM,
            remat_backbone=cfg.TPU.REMAT_BACKBONE,
            stop_backbone_grad=cfg.MODEL.BACKBONE.FREEZE,
            compute_dtype=(torch.bfloat16
                           if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32))
    model = model.to_empty(device=dev)
    seed = max(cfg.SEED, 0) if seed is None else seed
    if init == "train":
        init_train_weights(model, seed, cfg.MODEL.FCOS.PRIOR_PROB)
    elif init == "random":
        init_random_weights(model, seed)
    else:
        raise ValueError(f"init {init!r}: 'random' or 'train'")
    return model.eval()


def _freeze_cfg(cfg) -> Dict:
    pg = cfg.MODEL.PROPOSAL_GENERATOR
    return {
        "backbone": cfg.MODEL.BACKBONE.FREEZE,
        "backbone_exclude": list(cfg.MODEL.BACKBONE.FREEZE_EXCLUDE),
        "proposal_generator": pg.FREEZE,
        "cls_tower": pg.FREEZE_CLS_TOWER,
        "cls_logits": pg.FREEZE_CLS_LOGITS,
        "bbox_branch": pg.FREEZE_BBOX_BRANCH,
        "bbox_tower": pg.FREEZE_BBOX_TOWER,
        "owd": pg.OWD,
        "code_generator": cfg.MODEL.META_LEARN.CODE_GENERATOR.FREEZE,
        "episodic": cfg.MODEL.META_LEARN.EPISODIC_LEARNING,
        "roi_heads": ("ROI_HEADS" in cfg.MODEL
                      and cfg.MODEL.ROI_HEADS.get("FREEZE", False)),
        "roi_heads_feat": ("ROI_HEADS" in cfg.MODEL
                           and cfg.MODEL.ROI_HEADS.get("FREEZE_FEAT",
                                                       False)),
    }


def _loss_cfg(cfg) -> FCOSLossCfg:
    pg = cfg.MODEL.PROPOSAL_GENERATOR
    return FCOSLossCfg(
        focal_alpha=cfg.MODEL.FCOS.LOSS_ALPHA,
        focal_gamma=cfg.MODEL.FCOS.LOSS_GAMMA,
        loc_loss_type=cfg.MODEL.FCOS.LOC_LOSS_TYPE,
        box_quality=tuple(sorted(cfg.MODEL.FCOS.BOX_QUALITY)),
        iou_mask=cfg.MODEL.FCOS.IOU_MASK,
        owd=pg.OWD,
        freeze_cls_logits=pg.FREEZE_CLS_LOGITS,
        box_branch_loss_on=not (pg.FREEZE_BBOX_BRANCH or pg.FREEZE),
        distill_weight=cfg.MODEL.META_LEARN.CODE_GENERATOR
        .DISTILLATION_LOSS_WEIGHT)


def _mapper(cfg) -> EpisodicMapper:
    return EpisodicMapper(
        train_canvas=tuple(cfg.TPU.TRAIN_CANVAS),
        eval_canvas=tuple(cfg.TPU.EVAL_CANVAS),
        support_canvas=tuple(cfg.TPU.SUPPORT_CANVAS),
        max_gt_boxes=cfg.TPU.MAX_GT_BOXES,
        min_size_train=tuple(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size_train=cfg.INPUT.MAX_SIZE_TRAIN,
        min_size_test=cfg.INPUT.MIN_SIZE_TEST,
        max_size_test=cfg.INPUT.MAX_SIZE_TEST,
        use_scale_jitter=cfg.INPUT.USE_SCALE_JITTER,
        rand_augment=("device" if cfg.INPUT.RAND_AUGMENT
                      and cfg.TPU.get("DEVICE_RANDAUG", False)
                      else cfg.INPUT.RAND_AUGMENT),
        fmt=cfg.INPUT.FORMAT)


def _eval_grid(cfg):
    return build_location_grid(
        tuple(cfg.TPU.EVAL_CANVAS), tuple(cfg.MODEL.FCOS.FPN_STRIDES),
        list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))


def _print_memory_report(device: torch.device) -> bool:
    """Print one train step's peak memory (SYLPH_MEMORY_REPORT=1): the
    allocator's peaks since ``reset_peak_memory_stats`` at the step's start.
    Returns False (report done) so the loop clears the flag. Without a card
    it prints the "report unavailable" form; it never breaks training."""
    try:
        if device.type != "cuda":
            raise RuntimeError(f"no allocator statistics on {device}")
        rep = {"max_memory_allocated_gb": torch.cuda.max_memory_allocated(
                   device) / 1e9,
               "max_memory_reserved_gb": torch.cuda.max_memory_reserved(
                   device) / 1e9}
        print("[memory] train-step peak (torch.cuda): "
              + "  ".join(f"{k}={v:.3f}" for k, v in rep.items()))
    except Exception as e:  # noqa: BLE001 — never break training over it
        print(f"[memory] report unavailable: {e}")
    return False


class MetaFCOSRunner:
    """Config, model, ``do_train`` (pretraining or episodic meta-training),
    evaluator dispatch and ``do_test`` on ``device`` (default ``"cuda"``,
    which raises without a card), or on ``group.device`` as one rank of a
    data-parallel ``group``."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 group: Optional[DataGroup] = None):
        self.device = (group.device if group is not None
                       else resolve_device(device))
        self.group = group
        self.drivers: Dict[str, object] = {}
        # per iteration of the last do_train: (data wait s, step wait s)
        self.loop_times: list = []

    @classmethod
    def get_default_cfg(cls) -> CfgNode:
        return get_default_cfg()

    @property
    def is_main(self) -> bool:
        """Whether this process writes files: rank 0, or the only one."""
        return self.group is None or self.group.is_main

    def build_model(self, cfg, init: str = "random") -> MetaOneStageDetector:
        """``build_model_from_cfg`` on the runner's device from ``cfg.SEED``
        (``init="train"``: the flax initializers' distributions), then
        MODEL.WEIGHTS over it."""
        model = build_model_from_cfg(cfg, device=self.device, init=init)
        model = self._load_weights(cfg, model)
        self._log_model_stats(cfg, model)
        return model

    @staticmethod
    def _log_model_stats(cfg, model: nn.Module) -> None:
        """The JAX package's parameter-count line at build time: every leaf
        of its parameter tree (the port's parameters and the FrozenBN
        buffers, which are flax params there) and the trainable ones under
        the port's freeze rule. That rule keeps FrozenBN constant, where the
        JAX rule trains the bottleneck FrozenBN with the backbone, so the
        trainable counts agree wherever the backbone is frozen."""
        total = sum(v.numel() for v in model.state_dict().values())
        mask = build_freeze_mask(model, _freeze_cfg(cfg))
        trainable = sum(p.numel() for n, p in model.named_parameters()
                        if mask[n])
        print(f"[model] params: {total / 1e6:.2f}M total, "
              f"{trainable / 1e6:.2f}M trainable")

    @staticmethod
    def _load_weights(cfg, model: MetaOneStageDetector):
        """MODEL.WEIGHTS with WEIGHTS_FILTER_BY_MODULE (reference
        _weight_preprocess, meta_fcos_runner.py:232-288): a flat ``.npz`` of
        flax params, a port checkpoint, or a detectron2 ``.pth``/``.pkl``
        converted as the JAX package converts it; leaves whose shapes
        differ are skipped, a mostly mismatched file is refused."""
        path = cfg.MODEL.WEIGHTS
        if not path:
            return model
        if path.endswith((".pth", ".pkl")):
            loaded = convert_detectron2_checkpoint(
                load_torch_state_dict(path),
                num_tower_convs=max(cfg.MODEL.FCOS.NUM_CLS_CONVS,
                                    cfg.MODEL.FCOS.NUM_BOX_CONVS),
                num_attention_heads=cfg.MODEL.META_LEARN.CODE_GENERATOR
                .TRANSFORMER_ENCODER.HEADS)
        else:
            loaded = load_params_any(path)
        loaded = filter_params_by_module(
            loaded, list(cfg.MODEL.WEIGHTS_FILTER_BY_MODULE))
        if path.endswith((".npz", ".pth", ".pkl")):   # flax-layout trees
            loaded = state_dict_from_jax(loaded)
        return merge_state_dict(model, loaded)

    # ------------------------------------------------------------ training
    def do_train(self, cfg, model: MetaOneStageDetector = None):
        """Train ``model`` (built from scratch when None) for
        SOLVER.MAX_ITER iterations, resuming from
        ``{OUTPUT_DIR}/ckpt``; returns ``(model, state)``."""
        if model is None:
            model = self.build_model(cfg, init="train")
        if cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
            return model, self._train_episodic(cfg, model)
        return model, self._train_pretrain(cfg, model)

    def _common_train_setup(self, cfg, model):
        sc = cfg.SOLVER
        tx, schedule = build_optimizer(
            model, base_lr=sc.BASE_LR, momentum=sc.MOMENTUM,
            weight_decay=sc.WEIGHT_DECAY,
            weight_decay_norm=sc.WEIGHT_DECAY_NORM, steps=tuple(sc.STEPS),
            gamma=sc.GAMMA, warmup_iters=sc.WARMUP_ITERS,
            warmup_factor=sc.WARMUP_FACTOR,
            clip_grad_norm=(sc.CLIP_GRADIENTS.CLIP_VALUE
                            if sc.CLIP_GRADIENTS.ENABLED else 0.0),
            freeze_cfg=_freeze_cfg(cfg))
        state = TrainState(model, tx, use_ema=cfg.MODEL_EMA.ENABLED,
                           ema_decay=cfg.MODEL_EMA.DECAY)
        ckpt = (CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
                if cfg.OUTPUT_DIR else None)
        if ckpt is not None:
            if self.group is not None:
                self.group.barrier()  # rank 0's last save is complete
            state, _ = ckpt.restore(state)
        return state, schedule, ckpt

    def _train_loop(self, cfg, state, step_fn, batches, schedule, ckpt,
                    eval_fn=None):
        """Host loop: one step per batch, metrics, the abnormal-loss check,
        checkpoints every SOLVER.CHECKPOINT_PERIOD and at the end, and the
        TEST.EVAL_PERIOD hook; metrics and checkpoints on rank 0 alone.
        ``self.loop_times`` keeps each iteration's data wait and step wait
        (printed with SYLPH_TIME_LOOP=1). SYLPH_MEMORY_REPORT=1 prints the
        first step's peak memory once."""
        max_iter = cfg.SOLVER.MAX_ITER
        eval_period = cfg.TEST.EVAL_PERIOD
        writer = MetricsWriter(cfg.OUTPUT_DIR if self.is_main else None)
        checker = AbnormalLossChecker()
        mem_report = bool(os.environ.get("SYLPH_MEMORY_REPORT"))
        time_loop = bool(os.environ.get("SYLPH_TIME_LOOP"))
        self.loop_times = []
        self.train_metrics = []
        it = state.step
        try:
            while it < max_iter:
                t_loop = time.perf_counter()
                batch = next(batches)
                t_data = time.perf_counter()
                if mem_report and self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                state, metrics = step_fn(state, batch)
                m = {k: float(v) for k, v in metrics.items()}
                t_step = time.perf_counter()
                if mem_report:
                    mem_report = _print_memory_report(self.device)
                self.loop_times.append((t_data - t_loop, t_step - t_data))
                self.train_metrics.append(m)
                if time_loop:
                    print(f"[loop-timing] data_wait {t_data - t_loop:.2f}s  "
                          f"step_wait {t_step - t_data:.2f}s")
                it += 1
                for key, msg in checker.check(m).items():
                    print(f"[abnormal-loss] {key}: {msg}")
                writer.write(it, m, lr=schedule(it))
                if ckpt is not None and self.is_main and (
                        it % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                        or it >= max_iter):
                    ckpt.save(it, state)
                if (eval_fn is not None and eval_period > 0
                        and it % eval_period == 0 and it < max_iter):
                    eval_fn(state, it)
        finally:
            writer.close()
            batches.close()
        return state

    def make_train_step(self, cfg, model):
        """The train step of the config's mode (episodic or pretraining) for
        ``model``: ``step(state, batch) -> (state, losses)``."""
        grid = build_location_grid(
            tuple(cfg.TPU.TRAIN_CANVAS), tuple(cfg.MODEL.FCOS.FPN_STRIDES),
            list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))
        lc = _loss_cfg(cfg)
        kw = dict(center_sample=cfg.MODEL.FCOS.CENTER_SAMPLE,
                  radius=cfg.MODEL.FCOS.POS_RADIUS,
                  steps_per_call=cfg.TPU.STEPS_PER_CALL,
                  grad_accum=max(1, cfg.TPU.GRAD_ACCUM), group=self.group)
        if not cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
            return make_pretrain_train_step(model, grid, lc, **kw)
        return make_episodic_train_step(
            model, grid, lc, num_shots=cfg.MODEL.META_LEARN.SHOT,
            seed=max(cfg.SEED, 0),
            pretrained_kernel=(self._cls_logits_kernel(model)
                               if lc.distill_weight > 0 else None), **kw)

    def _train_pretrain(self, cfg, model):
        state, schedule, ckpt = self._common_train_setup(cfg, model)
        return self._train_loop(cfg, state, self.make_train_step(cfg, model),
                                self._pretrain_loader(cfg), schedule, ckpt)

    def _train_episodic(self, cfg, model):
        state, schedule, ckpt = self._common_train_setup(cfg, model)

        def eval_fn(state, it):
            print(f"[eval @ iter {it}]")
            with _weights(model, self.eval_params(cfg, state)):
                results = self.do_test(cfg, model, step=it)
            for name, res in results.items():
                print(name, {k: round(v, 3) for k, v in res["bbox"].items()
                             if isinstance(v, float)})

        return self._train_loop(cfg, state, self.make_train_step(cfg, model),
                                self._episodic_loader(cfg), schedule, ckpt,
                                eval_fn=eval_fn)

    @staticmethod
    def _cls_logits_kernel(model):
        """(C_base, 256) weight and (C_base,) bias of the pretrained 1x1
        ``cls_logits`` conv: the distillation target (fcos.py:219-227)."""
        conv = model.fcos_head.cls_logits
        w = conv.weight.detach()
        return w.reshape(w.shape[0], -1).clone(), conv.bias.detach().clone()

    @staticmethod
    def eval_params(cfg, state) -> Dict[str, torch.Tensor]:
        """The EMA weights when MODEL_EMA is on (reference
        meta_fcos_runner.py:692-699), else the live parameters."""
        if cfg.MODEL_EMA.ENABLED and state.ema is not None:
            return state.ema
        return state.params

    # ------------------------------------------------------------- loaders
    def _episodic_loader(self, cfg):
        """Episodic batches (this rank's slice of each)."""
        name = cfg.DATASETS.TRAIN[0]
        ds = MetaDataset(self._dataset(cfg, name), "episodic_train_both",
                         num_shot=cfg.MODEL.META_LEARN.SHOT,
                         num_query_shot=cfg.MODEL.META_LEARN.QUERY_SHOT)
        return build_episodic_train_loader(
            ds, _mapper(cfg), episodes_per_batch=cfg.SOLVER.IMS_PER_BATCH,
            seed=max(cfg.SEED, 0), sampler=cfg.DATALOADER.SAMPLER_TRAIN,
            repeat_thresh=cfg.DATALOADER.REPEAT_THRESHOLD,
            device=self.device, **self._loader_ranks())

    def _dataset(self, cfg, name: str, **kwargs):
        """``DatasetCatalog.get``; with several ranks under one numpy seed,
        so that what a dataset draws from the global RNG as it loads (the
        coco_meta_*_all splits' novel support) is the same on every rank."""
        if self.group is None or self.group.world == 1:
            return DatasetCatalog.get(name, **kwargs)
        with temp_seed(max(cfg.SEED, 0)):
            return DatasetCatalog.get(name, **kwargs)

    def _loader_ranks(self) -> Dict[str, int]:
        g = self.group
        return {"rank": g.rank, "world_size": g.world} if g else {}

    def _pretrain_loader(self, cfg):
        """Plain detection batches from the pretrain dataset (few-shot
        subsets honor MODEL.TFA.TRAIN_SHOT), this rank's slice of each."""
        name = cfg.DATASETS.TRAIN[0]
        try:
            data = self._dataset(cfg, name, shot=cfg.MODEL.TFA.TRAIN_SHOT)
        except TypeError:
            data = self._dataset(cfg, name)
        if isinstance(data, dict) and "records" not in data:
            raise ValueError(
                f"{name} is an episodic meta-dataset; the non-episodic "
                "pretrain loader needs a *_pretrain_* dataset (or set "
                "MODEL.META_LEARN.EPISODIC_LEARNING: true)")
        records = data["records"] if isinstance(data, dict) else data
        return build_pretrain_loader(
            records, _mapper(cfg), batch_size=cfg.SOLVER.IMS_PER_BATCH,
            seed=max(cfg.SEED, 0), sampler=cfg.DATALOADER.SAMPLER_TRAIN,
            repeat_thresh=cfg.DATALOADER.REPEAT_THRESHOLD,
            device=self.device, **self._loader_ranks())

    def get_evaluator(self, cfg, dataset_name: str, query_records, metadata):
        """Evaluator dispatch on the dataset's evaluator_type (reference
        meta_fcos_runner.py:116-149): OWD first, then lvis/tao ->
        FewshotLVISEvaluator, coco_meta_learn -> COCOMetaEvaluator,
        anything else -> the AP + AR table."""
        etype = metadata.get("evaluator_type") or (
            "lvis_meta_learn" if dataset_name.startswith("lvis")
            else "coco_meta_learn" if "_meta_" in dataset_name
            else "coco")
        novel = None
        if metadata.get("split") == "all":
            novel = metadata.get("novel_dataset_ids")
        if cfg.MODEL.PROPOSAL_GENERATOR.OWD:
            return COCOOWDEvaluator(query_records, metadata)
        if etype in ("lvis", "lvis_meta_learn", "tao_meta_learn"):
            return FewshotLVISEvaluator(
                query_records, metadata,
                categories=metadata.get("categories"),
                max_dets=cfg.TEST.DETECTIONS_PER_IMAGE)
        if etype == "coco_meta_learn":
            return COCOMetaEvaluator(query_records, metadata,
                                     novel_dataset_ids=novel)
        return AREvaluator(query_records, metadata,
                           novel_dataset_ids=novel)

    def _do_test_plain(self, cfg, model) -> Dict[str, Dict]:
        """Non-episodic evaluation (pretrain / TFA finetune path)."""
        infer = _make_plain_fcos_infer(model, _eval_grid(cfg),
                                       _decode_cfg(cfg), self.device)
        results = {}
        for name in cfg.DATASETS.TEST:
            data = DatasetCatalog.get(name)
            if isinstance(data, dict) and "records" in data:
                records, meta = data["records"], data["metadata"]
            else:  # meta-format dict: evaluate on its query list
                records, meta = data[-1], data["metadata"]
            evaluator = self.get_evaluator(cfg, name, records, meta)
            results[name] = _plain_eval_loop(
                infer, records, _mapper(cfg),
                meta["thing_dataset_id_to_contiguous_id"], evaluator,
                batch_size=cfg.TPU.EVAL_BATCH, device=self.device)
        return results

    def do_test(self, cfg, model, step: int = 0) -> Dict[str, Dict]:
        """The two-phase meta-test on every ``DATASETS.TEST`` entry, with
        REPEAT_TEST aggregation (reference :451-672); the plain base
        detector evaluation when the config is not episodic. Scalars go to
        ``{OUTPUT_DIR}/tb`` and raw codes to
        ``{OUTPUT_DIR}/class_codes/{dataset}/`` when OUTPUT_DIR is set.
        The drivers stay in ``self.drivers`` (bank and phase times). With a
        group of several ranks, registration is sharded over them and every
        rank scores the whole query set; rank 0 writes the files."""
        from .evaluation.meta_eval import MetaTestDriver

        if not cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
            results = self._do_test_plain(cfg, model)
            self._write_tb(results, cfg, step)
            return results
        results = {}
        grid = _eval_grid(cfg)
        for name in cfg.DATASETS.TEST:
            dataset_dict = self._dataset(cfg, name)
            # all-GT base-class codes only make sense on splits that
            # contain base classes (reference meta_fcos_runner.py:520-532)
            split = dataset_dict["metadata"].get("split", "")
            use_base = (cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES
                        and split in ("all", "base"))
            driver = MetaTestDriver(
                model, dataset_dict, _mapper(cfg), grid, _decode_cfg(cfg),
                eval_shot=cfg.MODEL.META_LEARN.EVAL_SHOT,
                evaluator_factory=lambda recs, meta, n=name:
                    self.get_evaluator(cfg, n, recs, meta),
                save_dir=(os.path.join(cfg.OUTPUT_DIR, "class_codes", name)
                          if cfg.OUTPUT_DIR else None),
                use_all_gts_in_base=use_base,
                base_max_records=cfg.MODEL.META_LEARN.BASE_EVAL_SHOT * 10,
                eval_batch=cfg.TPU.EVAL_BATCH,
                class_batch=cfg.TPU.CLASS_BATCH, device=self.device,
                mesh=self.group)
            self.drivers[name] = driver
            results[name] = driver.run_repeated(cfg.TEST.REPEAT_TEST)
        self._write_tb(results, cfg, step)
        return results

    def _write_tb(self, results, cfg, step: int) -> None:
        if self.is_main:
            write_eval_results_tb(results, cfg.OUTPUT_DIR, step)


class _weights:
    """Context: ``model`` holds ``params`` (a name -> tensor dict) inside,
    its own parameters again after."""

    def __init__(self, model, params: Dict[str, torch.Tensor]):
        self.model, self.params = model, params

    def __enter__(self):
        self.saved = {k: v.detach().clone()
                      for k, v in self.model.named_parameters()}
        self.model.load_state_dict(self.params, strict=False)
        return self.model

    def __exit__(self, *exc):
        self.model.load_state_dict(self.saved, strict=False)


def _make_plain_fcos_infer(model, grid, dcfg: DecodeCfg,
                           device: torch.device):
    """Base-detector inference (trained cls_logits, no bank)."""
    locations = torch.as_tensor(grid.locations, device=device)
    strides = torch.as_tensor(grid.strides, device=device)
    splits = tuple(h * w for h, w in grid.level_sizes)

    @torch.inference_mode()
    def infer(images, sizes):
        out = model.forward_base(images)
        return decode_proposals(out.logits, out.reg, out.ctrness, out.iou,
                                locations, strides, sizes, dcfg, splits)

    return infer


def _plain_eval_loop(infer, records, mapper, id_map, evaluator,
                     batch_size: int, device: torch.device):
    """Base-detector evaluation: each batch of records is mapped on the
    thread pool just before its model call; the tail batch repeats its
    last image and is masked out."""
    contiguous_to_dataset = {v: k for k, v in id_map.items()}
    for i in range(0, len(records), batch_size):
        chunk = list(_POOL.map(mapper.map_query_eval,
                               records[i:i + batch_size]))
        n = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
        sizes = np.stack([m["image_size"] for m in chunk])
        det = infer(torch.as_tensor(np.stack([m["image"] for m in chunk]),
                                    device=device),
                    torch.as_tensor(sizes, device=device)).numpy()
        evaluator.process(detections_to_coco_results(
            det, [m["image_id"] for m in chunk], sizes,
            np.stack([np.asarray([m["orig_height"], m["orig_width"]])
                      for m in chunk]),
            contiguous_to_dataset,
            batch_valid=np.arange(batch_size) < n))
    return evaluator.evaluate()


class MetaFCOSROIEncoderRunner(MetaFCOSRunner):
    """The ROIEncoder code generator variant (reference
    meta_fcos_roi_encoder_runner.py:24-37)."""

    @classmethod
    def get_default_cfg(cls) -> CfgNode:
        cfg = super().get_default_cfg()
        cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"
        return cfg


class TFAFewShotDetectionRunner(MetaFCOSRunner):
    """The TFA finetune baseline: non-episodic training through the plain
    path with the config's freezing (reference tfa_runner.py:23-39), the
    cosine head under MODEL.FCOS.L2_NORM_CLS_WEIGHT, and the base-class
    ``cls_logits`` surgery at build time."""

    @classmethod
    def get_default_cfg(cls) -> CfgNode:
        cfg = super().get_default_cfg()
        cfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
        cfg.MODEL.TFA.FINETINE = True
        return cfg

    def build_model(self, cfg, init: str = "random") -> MetaOneStageDetector:
        model = super().build_model(cfg, init=init)
        if (cfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS
                and cfg.MODEL.WEIGHTS
                and cfg.DATASETS.BASE_CLASSES_SPLIT
                and cfg.DATASETS.TRAIN):
            self._preload_cls_logits(cfg, model)
        return model

    @torch.no_grad()
    def _preload_cls_logits(self, cfg, model: MetaOneStageDetector) -> bool:
        """TFA surgery (JAX ``_preload_cls_logits``, reference
        _preload_cls_logits_weights, fcos.py:344-380): copy the base-class
        rows of the 1x1 ``cls_logits`` in MODEL.WEIGHTS (a base-classes
        model: a flat ``.npz``, a port checkpoint or a detectron2
        ``.pth``/``.pkl``) into the model's all-classes head, at the
        contiguous ids the current dataset gives those classes. A surgery
        that cannot be made warns loudly and returns False.

        A cosine head (MODEL.FCOS.L2_NORM_CLS_WEIGHT) has no ``cls_logits``
        to write into: when the checkpoint does have one, the JAX package
        fails with a KeyError at its ``params["fcos_head"]["cls_logits"]``,
        and the port raises a ValueError that says so."""
        log = logging.getLogger(__name__)
        path = cfg.MODEL.WEIGHTS
        if path.endswith((".pth", ".pkl")):
            loaded = state_dict_from_jax(convert_detectron2_checkpoint(
                load_torch_state_dict(path)))
        else:
            try:
                loaded = load_params_any(path)
            except Exception as e:  # noqa: BLE001 — surfaced below
                log.warning(
                    "[TFA] cls-logits surgery REQUESTED "
                    "(MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS) but "
                    "MODEL.WEIGHTS=%r could not be read natively (%s) — "
                    "surgery SKIPPED, base rows stay at random init", path, e)
                return False
            if path.endswith(".npz"):
                loaded = state_dict_from_jax(loaded)
        key = "fcos_head.cls_logits"
        if f"{key}.weight" not in loaded or f"{key}.bias" not in loaded:
            log.warning(
                "[TFA] cls-logits surgery REQUESTED but checkpoint %r has "
                "no fcos_head/cls_logits (cosine head or headless "
                "checkpoint?) — surgery SKIPPED", path)
            return False
        head = model.fcos_head
        if head.l2_norm_cls_weight:
            raise ValueError(
                "[TFA] cls-logits surgery: the model's head is the cosine "
                "classifier (MODEL.FCOS.L2_NORM_CLS_WEIGHT), which has no "
                "fcos_head/cls_logits to copy the base rows of "
                f"{path!r} into; set MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS"
                " to false")
        base_w = torch.as_tensor(loaded[f"{key}.weight"])  # (C_base, C, k, k)
        base_b = torch.as_tensor(loaded[f"{key}.bias"])
        base_ids = MetadataCatalog.get(cfg.DATASETS.BASE_CLASSES_SPLIT).get(
            "thing_dataset_id_to_contiguous_id")
        if base_ids is None:  # lazily registered: load the dataset
            base_ids = DatasetCatalog.get(cfg.DATASETS.BASE_CLASSES_SPLIT)[
                "metadata"]["thing_dataset_id_to_contiguous_id"]
        cur_ids = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])["metadata"][
            "thing_dataset_id_to_contiguous_id"]
        w, b = head.cls_logits.weight, head.cls_logits.bias
        for did, bi in base_ids.items():
            if did in cur_ids:
                w[cur_ids[did]] = base_w[bi].to(w)
                b[cur_ids[did]] = base_b[bi].to(b)
        print(f"[TFA] preloaded {len(base_ids)} base cls_logits rows")
        return True


def create_runner(name: str, device: Union[str, torch.device] = "cuda",
                  group: Optional[DataGroup] = None) -> MetaFCOSRunner:
    """A runner by name (reference-style dotted names accepted):
    ``MetaFCOSRunner``, ``MetaFCOSROIEncoderRunner``,
    ``TFAFewShotDetectionRunner``, ``MetaFasterRCNNRunner``,
    ``TFAFasterRCNNRunner``; ``group``: this process's data-parallel
    group."""
    from .meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                          TFAFasterRCNNRunner)

    table = {"MetaFCOSRunner": MetaFCOSRunner,
             "MetaFCOSROIEncoderRunner": MetaFCOSROIEncoderRunner,
             "TFAFewShotDetectionRunner": TFAFewShotDetectionRunner,
             "MetaFasterRCNNRunner": MetaFasterRCNNRunner,
             "TFAFasterRCNNRunner": TFAFasterRCNNRunner}
    return table[name.split(".")[-1]](device=device, group=group)
