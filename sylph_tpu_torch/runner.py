"""Model construction from a config (port of the serving part of
sylph_tpu/runner/meta_fcos_runner.py: ``build_model_from_cfg``,
``_codegen_kwargs``, ``_decode_cfg``).

The repo ships no checkpoint, so ``build_model_from_cfg`` initializes the
weights from an explicit ``torch.Generator`` seed, detectron2-style
(fan-in scaled convs, random frozen-BN statistics) so that activations stay
O(1) through the full-depth network. Pretrained weights come in through
``load_state_dict`` (the port's own) or ``utils.convert_weights``
(the JAX package's).
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch
import torch.nn as nn

from .models.layers import Conv2d, GroupNorm, Scale
from .models.meta_arch import MetaOneStageDetector
from .models.resnet import FrozenBatchNorm
from .ops.decode import DecodeCfg

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
        raise NotImplementedError("the ROIEncoder is not ported yet")
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


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer from a CPU ``torch.Generator``.

    The draws happen on the CPU and are copied to the model's device, so a
    model built on ``cuda`` and one built on ``cpu`` from the same seed hold
    the same weights.
    """
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    for module in model.modules():
        if isinstance(module, Conv2d):
            fan_in = module.weight[0].numel()
            module.weight.copy_(randn(*module.weight.shape)
                                / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.copy_(0.1 * randn(*module.bias.shape))
        elif isinstance(module, FrozenBatchNorm):
            c = module.scale.numel()
            gamma = 1.0 + 0.1 * randn(c)
            beta = 0.1 * randn(c)
            mean = 0.1 * randn(c)
            var = 0.8 + 0.4 * torch.rand((c,), generator=gen)
            scale = gamma / torch.sqrt(var + BN_EPS)
            module.scale.copy_(scale)
            module.bias.copy_(beta - mean * scale)
        elif isinstance(module, GroupNorm):
            module.weight.copy_(1.0 + 0.1 * randn(module.num_channels))
            module.bias.copy_(0.1 * randn(module.num_channels))
        elif isinstance(module, Scale):
            module.scale.copy_(module.init_value * (1.0 + 0.1 * randn()))
    cg = getattr(model, "code_generator", None)
    if cg is not None and cg.meta_bias:
        cg.meta_bias_value.fill_(cg.prior)
    return model


def build_model_from_cfg(cfg, device: Union[str, torch.device] = "cuda",
                         seed: int = None) -> MetaOneStageDetector:
    """MetaOneStageDetector for ``cfg`` on ``device``, randomly initialized
    from ``seed`` (default ``max(cfg.SEED, 0)``), in eval mode.

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
            compute_dtype=(torch.bfloat16
                           if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32))
    model = model.to_empty(device=dev)
    init_random_weights(model, max(cfg.SEED, 0) if seed is None else seed)
    return model.eval()
