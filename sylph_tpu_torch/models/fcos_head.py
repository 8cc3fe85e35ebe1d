"""FCOS detection head with the Sylph conditional classifier, NCHW (port of
sylph_tpu/models/fcos_head.py).

  * towers shared across levels: NUM_CLS_CONVS x [conv3x3 + bias,
    GroupNorm(32, eps 1e-5) in float32, relu];
  * ``cls_logits``, ``bbox_pred``, ``ctrness``, ``iou_overlap``; per-level
    ``Scale`` *then* relu on the regression;
  * conditional classification: with 1x1 class codes the conditional conv is
    one matmul of the flattened cls tower over the code bank plus the bias,
    with operands in the compute dtype and float32 accumulation and output
    (the JAX package's ``preferred_element_type=float32``);
  * the TFA cosine classifier (MODEL.FCOS.L2_NORM_CLS_WEIGHT) in place of
    ``cls_logits``: each row of ``cosine_weight`` is group-normalized (32
    groups, eps 1e-5), scaled by ``cosine_gn_scale`` plus ``cosine_gn_bias``
    and L2-normalized; the logits are ``exp(cosine_scale) * (tower . w) +
    cosine_bias``. As under flax ``nn.compact``, where ``cls_logits`` is
    declared but never called on this path, the head then has no
    ``cls_logits`` parameters;
  * MODEL.FCOS.USE_DEFORMABLE: the last conv of every tower is a DCNv2
    ``DFConv2d`` (``ops/deform_conv.py``).

Outputs are flattened level-major, then row-major over (h, w), exactly as
the JAX package's NHWC ``reshape(b, -1, C)`` orders them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import DFConv2d
from .layers import Conv2d, GroupNorm, Scale, flatten_nchw


class HeadOutputs(NamedTuple):
    logits: torch.Tensor        # (B, K, C) float32
    reg: torch.Tensor           # (B, K, 4) stride-normalized (post relu)
    ctrness: torch.Tensor       # (B, K)
    iou: torch.Tensor           # (B, K)


class _Tower(nn.Module):
    """num_convs x [conv3x3(bias), GN(32), relu]; modules ``conv{i}``/``gn{i}``.
    With ``use_deformable`` the last conv is a ``DFConv2d``."""

    def __init__(self, num_convs: int, channels: int = 256, norm: str = "GN",
                 use_deformable: bool = False):
        super().__init__()
        if norm not in ("GN", "", "none", None):
            raise NotImplementedError(f"FCOS norm {norm}")
        self.num_convs = num_convs
        self.use_gn = norm == "GN"
        for i in range(num_convs):
            last = i == num_convs - 1
            self.add_module(f"conv{i}", DFConv2d(channels, channels)
                            if use_deformable and last
                            else Conv2d(channels, channels, 3))
            if self.use_gn:
                self.add_module(f"gn{i}", GroupNorm(32, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
            if self.use_gn:
                x = getattr(self, f"gn{i}")(x)
            x = F.relu(x)
        return x


class FCOSHead(nn.Module):
    """``forward(features)`` runs the base ``cls_logits``;
    ``forward(features, class_code={'cls_conv': (N,256), 'cls_bias': (N,)})``
    the conditional classifier with N output channels."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_cls_convs: int = 4, num_box_convs: int = 4,
                 num_share_convs: int = 0, norm: str = "GN",
                 use_scale: bool = True, cls_kernel_size: int = 1,
                 num_levels: int = 5,
                 l2_norm_cls_weight: bool = False,
                 use_deformable: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        c = in_channels
        self.share_tower = (_Tower(num_share_convs, c, norm, use_deformable)
                            if num_share_convs else None)
        self.cls_tower = _Tower(num_cls_convs, c, norm, use_deformable)
        self.bbox_tower = _Tower(num_box_convs, c, norm, use_deformable)
        self.l2_norm_cls_weight = l2_norm_cls_weight
        if l2_norm_cls_weight:
            self.cosine_weight = nn.Parameter(torch.empty(num_classes, c))
            self.cosine_bias = nn.Parameter(torch.empty(num_classes))
            self.cosine_scale = nn.Parameter(torch.empty(()))
            self.cosine_gn_scale = nn.Parameter(torch.empty(c))
            self.cosine_gn_bias = nn.Parameter(torch.empty(c))
        else:
            self.cls_logits = Conv2d(c, num_classes, cls_kernel_size)
        self.bbox_pred = Conv2d(c, 4, 3)
        self.ctrness = Conv2d(c, 1, 3)
        self.iou_overlap = Conv2d(c, 1, 3)
        self.use_scale = use_scale
        if use_scale:
            for i in range(num_levels):
                self.add_module(f"scale_l{i}", Scale(1.0))

    def forward(self, features: Sequence[torch.Tensor],
                class_code: Optional[Dict[str, torch.Tensor]] = None
                ) -> HeadOutputs:
        if class_code is not None:
            code_w = class_code["cls_conv"]
            # (N, 256) rounded to the compute dtype: a float32 product of
            # bf16 operands is exact, so the float32 matmul below
            # accumulates the bf16 products in float32
            code_w = code_w.reshape(code_w.shape[0], -1) \
                .to(self.compute_dtype).float()
            code_b = class_code["cls_bias"].reshape(-1).float()    # (N,)
        elif self.l2_norm_cls_weight:
            cos_w = self.cosine_rows().to(self.compute_dtype).float()

        logits_l, reg_l, ctr_l, iou_l = [], [], [], []
        for li, feat in enumerate(features):
            x = feat.to(self.compute_dtype)
            if self.share_tower is not None:
                x = self.share_tower(x)
            ct = self.cls_tower(x)
            bt = self.bbox_tower(x)

            if class_code is not None:
                logit = torch.matmul(flatten_nchw(ct).float(), code_w.t()) \
                    + code_b
            elif self.l2_norm_cls_weight:
                logit = torch.exp(self.cosine_scale) * torch.matmul(
                    flatten_nchw(ct).float(), cos_w.t()) + self.cosine_bias
            else:
                logit = flatten_nchw(self.cls_logits(ct).float())

            reg = self.bbox_pred(bt)
            if self.use_scale:
                reg = getattr(self, f"scale_l{li}")(reg)
            reg = F.relu(reg).float()

            b = feat.shape[0]
            logits_l.append(logit)
            reg_l.append(flatten_nchw(reg))
            ctr_l.append(self.ctrness(bt).float().reshape(b, -1))
            iou_l.append(self.iou_overlap(bt).float().reshape(b, -1))

        return HeadOutputs(
            logits=torch.cat(logits_l, dim=1),
            reg=torch.cat(reg_l, dim=1),
            ctrness=torch.cat(ctr_l, dim=1),
            iou=torch.cat(iou_l, dim=1),
        )

    def cosine_rows(self) -> torch.Tensor:
        """The cosine classifier's (N, C) unit rows: GroupNorm over each
        weight row (32 groups when C allows, eps 1e-5, float32), the affine,
        then L2 with a 1e-12 floor (reference head_utils.py:188-194)."""
        w = self.cosine_weight.float()
        n, c = w.shape
        groups = 32 if c % 32 == 0 else 1
        wg = w.reshape(n, groups, -1)
        mu = wg.mean(-1, keepdim=True)
        var = wg.var(-1, unbiased=False, keepdim=True)
        w = ((wg - mu) / torch.sqrt(var + 1e-5)).reshape(n, c)
        w = w * self.cosine_gn_scale + self.cosine_gn_bias
        return w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                        keepdim=True),
                               min=1e-12)
