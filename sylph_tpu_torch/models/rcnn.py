"""Two-stage few-shot detector, Meta Faster R-CNN, inference (port of
sylph_tpu/models/rcnn.py).

An FPN Faster R-CNN whose RPN is class-agnostic and whose ROI box head
classifies against class codes from the code generator (the conditional
linear layer, with a learned background row appended), against a trained
linear ``cls_score`` (base detector), or with the TFA cosine layer:

  * ``build_anchor_grid``: detectron2 anchors on the host, offset 0, in
    (h, w, a) order per level, levels concatenated;
  * ``RPNHead``: shared 3x3 conv, 1x1 ``objectness`` and ``anchor_deltas``,
    computed in float32 (flax promotes the bf16 features against float32
    kernels);
  * ``rpn_proposals``: per-level top-k with ties to the lower index, decode,
    clip, ``min_size``, sigmoid, level-aware NMS (the CUDA kernel on the
    card);
  * ``ROIBoxHead``: two FC layers over the NHWC flatten of the pooled
    (P, P, C) features, in float32, then the classifier and a
    class-agnostic ``bbox_pred``;
  * ``FewShotRCNN``: backbone res2-res5, FPN P2-P6 (max-pool top), RPN,
    multilevel ROIAlign over P2-P5, box head, code generator; inference
    modes ``forward_instances`` (conditioned on a code bank) and
    ``forward_base_instances`` (the trained classifier).

The ROI stage flattens (proposals x classes) into one candidate axis per
image and ends in one NMS launch for the whole batch (the picks are per
image, as in the JAX package's one launch per image). Submodules carry the
flax names so converted weights load by name. Training (RPN and ROI losses,
sampling) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import decode_deltas
from ..ops.decode import _topk_lower_index_first
from ..ops.nms import batched_multiclass_nms
from ..ops.roi_align import multilevel_roi_align
from ..structures import Detections
from .code_generator import CodeGeneratorHead
from .fpn import FPN
from .layers import Conv2d, flatten_nchw
from .resnet import ResNet, resnet_feature_channels

ROI_DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


# ----------------------------------------------------------------- anchors
@dataclasses.dataclass(frozen=True)
class AnchorGrid:
    anchors: np.ndarray          # (K, 4) XYXY, concat over levels
    level_splits: Tuple[int, ...]
    num_anchors_per_loc: int


def build_anchor_grid(canvas_hw, strides=(4, 8, 16, 32, 64),
                      sizes=(32, 64, 128, 256, 512),
                      aspect_ratios=(0.5, 1.0, 2.0)) -> AnchorGrid:
    """detectron2 DefaultAnchorGenerator: one size per level, shared aspect
    ratios, anchor centres at i * stride (offset 0), base boxes of area
    size^2 with w = sqrt(area / r), h = w * r."""
    all_anchors, splits = [], []
    for stride, size in zip(strides, sizes):
        h = -(-canvas_hw[0] // stride)
        w = -(-canvas_hw[1] // stride)
        base = []
        area = float(size) ** 2
        for ar in aspect_ratios:
            bw = math.sqrt(area / ar)
            bh = bw * ar
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base, np.float32)  # (A, 4)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        centers = np.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4) * stride
        anchors = (centers + base[None]).reshape(-1, 4).astype(np.float32)
        all_anchors.append(anchors)
        splits.append(anchors.shape[0])
    return AnchorGrid(np.concatenate(all_anchors, 0), tuple(splits),
                      len(aspect_ratios))


# --------------------------------------------------------------------- RPN
class RPNHead(nn.Module):
    """StandardRPNHead: shared conv3x3 + 1x1 objectness and deltas."""

    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3)
        self.objectness = Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level (B, C, H, W) -> logits (B, sum H*W*A) and deltas
        (B, sum H*W*A, 4), in (h, w, a) order like the anchors."""
        logits, regs = [], []
        for f in features:
            t = F.relu(self.conv(f.float()))
            b = f.shape[0]
            logits.append(flatten_nchw(self.objectness(t)).reshape(b, -1))
            regs.append(flatten_nchw(self.anchor_deltas(t)).reshape(b, -1, 4))
        return torch.cat(logits, 1), torch.cat(regs, 1)


def rpn_proposals(obj_logits: torch.Tensor, deltas: torch.Tensor,
                  anchors: torch.Tensor, level_splits: Sequence[int],
                  image_sizes: torch.Tensor, pre_nms_topk: int = 1000,
                  post_nms_topk: int = 1000, nms_thresh: float = 0.7,
                  min_size: float = 0.0):
    """Per-level top-k, decode, clip, level-aware NMS -> proposals
    (B, post_nms_topk, 4), their scores and valid flags."""
    hw = image_sizes.float()
    wh = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)
    boxes_all, scores_all, level_all, valid_all = [], [], [], []
    start = 0
    for li, count in enumerate(level_splits):
        k = min(pre_nms_topk, count)
        scores, idx = _topk_lower_index_first(
            obj_logits[:, start:start + count], k)
        a = anchors[start:start + count][idx]                    # (B, k, 4)
        d = deltas[:, start:start + count].gather(
            1, idx[..., None].expand(-1, -1, 4))
        bx = decode_deltas(a, d)
        bx = torch.minimum(torch.clamp(bx, min=0.0), wh[:, None, :])
        ok = ((bx[..., 2] - bx[..., 0] > min_size)
              & (bx[..., 3] - bx[..., 1] > min_size))
        boxes_all.append(bx)
        scores_all.append(torch.sigmoid(scores))
        level_all.append(torch.full(scores.shape, li, dtype=torch.int64,
                                    device=scores.device))
        valid_all.append(ok)
        start += count
    nb, ns, _, nv, _ = batched_multiclass_nms(
        torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
        torch.cat(level_all, 1), torch.cat(valid_all, 1), nms_thresh,
        post_nms_topk)
    return nb, ns, nv


# ----------------------------------------------------------------- ROI head
class ROIBoxHead(nn.Module):
    """FastRCNNConvFCHead (``num_fc`` FC layers) and its predictors.

    The classifier is one of three, fixed at construction as the flax
    parameter tree is: ``conditional`` (class codes at call time, plus the
    learned background row ``bg_weight``/``bg_bias``), ``cosine_sim`` (TFA
    CosineSimOutputLayers: ``cosine_weight`` rows and the features L2-
    normalized with +1e-5, scaled by ``cosine_scale``, or by the learnable
    ``cosine_scale_param`` when it is -1), or the linear ``cls_score``.
    """

    def __init__(self, in_features: int, fc_dim: int = 1024,
                 num_fc: int = 2, num_classes: int = 80,
                 conditional: bool = False, cosine_sim: bool = False,
                 cosine_scale: float = -1.0):
        super().__init__()
        self.fc_dim = fc_dim
        self.num_fc = num_fc
        self.conditional = conditional
        self.cosine_sim = cosine_sim and not conditional
        self.cosine_scale = cosine_scale
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(
                in_features if i == 0 else fc_dim, fc_dim))
        if conditional:
            self.bg_weight = nn.Parameter(torch.zeros(fc_dim))
            self.bg_bias = nn.Parameter(torch.zeros(()))
        elif self.cosine_sim:
            self.cosine_weight = nn.Parameter(
                torch.zeros(num_classes + 1, fc_dim))
            if cosine_scale == -1.0:
                self.cosine_scale_param = nn.Parameter(torch.tensor(20.0))
        else:
            self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, 4)

    def features(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(N, C, P, P) pooled features -> (N, fc_dim), flattened in the
        NHWC order of the flax Dense kernels."""
        x = roi_feats.float().permute(0, 2, 3, 1).reshape(
            roi_feats.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x

    def forward(self, roi_feats: torch.Tensor,
                class_code: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> scores (N, classes + 1), background last, and deltas (N, 4)."""
        x = self.features(roi_feats)
        if self.conditional:
            if class_code is None:
                raise ValueError("a conditional box head needs class codes")
            w = class_code["cls_conv"].reshape(-1, self.fc_dim)   # (E, D)
            bias = class_code["cls_bias"].reshape(-1)
            cond = x @ w.to(x.dtype).t() + bias
            bg = (x @ self.bg_weight + self.bg_bias)[:, None]
            scores = torch.cat([cond, bg], dim=-1)
        elif self.cosine_sim:
            scale = (self.cosine_scale_param if self.cosine_scale == -1.0
                     else self.cosine_scale)
            xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                      + 1e-5)
            w = self.cosine_weight
            wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True)
                      + 1e-5)
            scores = scale * (xn @ wn.t())
        else:
            scores = self.cls_score(x)
        return scores, self.bbox_pred(x)


# --------------------------------------------------------------- meta-arch
class FewShotRCNN(nn.Module):
    """Two-stage few-shot detector (FewShotDetector analog), inference."""

    RPN_STRIDES = (4, 8, 16, 32, 64)   # P2..P6
    ROI_STRIDES = (4, 8, 16, 32)       # P2..P5

    def __init__(self, depth: int = 50,
                 backbone_out_features: Sequence[str] = ("res2", "res3",
                                                         "res4", "res5"),
                 fpn_out_channels: int = 256, roi_in_levels: int = 4,
                 num_classes: int = 80, fc_dim: int = 1024, num_fc: int = 2,
                 pooler_resolution: int = 7, cosine_sim: bool = False,
                 cosine_scale: float = -1.0,
                 code_generator_name: Optional[str] = "CodeGenerator",
                 code_generator_kwargs: Optional[Dict[str, Any]] = None,
                 pixel_mean: Sequence[float] = (103.530, 116.280, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 stop_backbone_grad: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 s2d_stem: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.roi_in_levels = roi_in_levels
        self.pooler_resolution = pooler_resolution
        # inference runs no autograd graph, so this changes nothing here
        self.stop_backbone_grad = stop_backbone_grad
        self.backbone = ResNet(depth=depth,
                               out_features=tuple(backbone_out_features),
                               compute_dtype=compute_dtype,
                               s2d_stem=s2d_stem)
        self.fpn = FPN(resnet_feature_channels(),
                       in_features=tuple(backbone_out_features),
                       out_channels=fpn_out_channels, top_levels=1,
                       top_block="maxpool", compute_dtype=compute_dtype)
        self.rpn_head = RPNHead(num_anchors=len(anchor_ratios),
                                channels=fpn_out_channels)
        if code_generator_name in ("none", None, ""):
            # TFA-RCNN: a plain Faster R-CNN, no hypernetwork
            self.code_generator = None
            self.code_generator_name = "none"
        elif code_generator_name == "CodeGenerator":
            kwargs = dict(code_generator_kwargs or {})
            kwargs.setdefault("strides", self.ROI_STRIDES)
            kwargs.setdefault("out_channel", fc_dim)
            kwargs.setdefault("compute_dtype", compute_dtype)
            self.code_generator = CodeGeneratorHead(
                in_channels=fpn_out_channels, **kwargs)
            self.code_generator_name = code_generator_name
        else:
            raise NotImplementedError(
                f"two-stage code generator {code_generator_name}")
        self.box_head = ROIBoxHead(
            fpn_out_channels * pooler_resolution ** 2, fc_dim=fc_dim,
            num_fc=num_fc, num_classes=num_classes,
            conditional=self.code_generator is not None,
            cosine_sim=cosine_sim, cosine_scale=cosine_scale)
        self.pixel_mean = tuple(float(m) for m in pixel_mean)
        self.pixel_std = tuple(float(s) for s in pixel_std)
        self._mean_std: Dict[torch.device, tuple] = {}

    # -------------------------------------------------------------- plumbing
    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) BGR canvas -> normalized (B, 3, H, W) compute dtype."""
        dev = images.device
        if dev not in self._mean_std:
            self._mean_std[dev] = (torch.tensor(self.pixel_mean, device=dev),
                                   torch.tensor(self.pixel_std, device=dev))
        mean, std = self._mean_std[dev]
        x = (images.float() - mean) / std
        return x.to(self.compute_dtype).permute(0, 3, 1, 2)

    def extract_features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images (B, H, W, 3) BGR canvas -> P2..P6 (NCHW)."""
        return self.fpn(self.backbone(self._normalize(images)))

    def forward_rpn(self, images: torch.Tensor):
        feats = self.extract_features(images)
        logits, deltas = self.rpn_head(feats)
        return feats, logits, deltas

    def roi_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                    rois_valid: torch.Tensor,
                    class_code: Optional[Dict[str, torch.Tensor]] = None):
        """ROIAlign over P2-P5 of one image ((1, C, H, W) maps) and the box
        head for its (P, 4) rois."""
        pooled = multilevel_roi_align(
            feats[:self.roi_in_levels], self.ROI_STRIDES, rois, rois_valid,
            torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device),
            output_size=self.pooler_resolution)
        return self.box_head(pooled, class_code)

    def forward_class_code(self, support_images: torch.Tensor,
                           support_boxes: torch.Tensor,
                           support_box_valid: torch.Tensor, num_shots: int,
                           training: bool = False) -> Dict[str, torch.Tensor]:
        feats = self.extract_features(support_images)
        return self.code_generator(feats[:self.roi_in_levels], support_boxes,
                                   support_box_valid, num_shots=num_shots,
                                   training=training)

    def normalize_code(self, codes: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        return self.code_generator.normalize(codes)

    def forward(self, images: torch.Tensor):
        _, logits, deltas = self.forward_rpn(images)
        return logits, deltas

    # ------------------------------------------------------------ inference
    def forward_base_instances(
        self, images: torch.Tensor, anchors: torch.Tensor,
        level_splits: Sequence[int], image_sizes: torch.Tensor,
        rpn_post_nms: int = 1000, score_thresh: float = 0.05,
        nms_thresh: float = 0.5, max_dets: int = 100,
        rpn_pre_nms: int = 1000) -> Detections:
        """Plain two-stage inference with the trained classifier (base
        detector and TFA-RCNN evaluation)."""
        return self._two_stage_infer(
            images, None, anchors, level_splits, image_sizes, rpn_post_nms,
            score_thresh, nms_thresh, max_dets, None, rpn_pre_nms)

    def forward_instances(
        self, images: torch.Tensor, class_code: Dict[str, torch.Tensor],
        anchors: torch.Tensor, level_splits: Sequence[int],
        image_sizes: torch.Tensor, rpn_post_nms: int = 1000,
        score_thresh: float = 0.05, nms_thresh: float = 0.5,
        max_dets: int = 100, class_valid: Optional[torch.Tensor] = None,
        rpn_pre_nms: int = 1000) -> Detections:
        """Conditioned two-stage inference against a code bank
        (FewShotDetector "meta_learn_test_instance")."""
        return self._two_stage_infer(
            images, class_code, anchors, level_splits, image_sizes,
            rpn_post_nms, score_thresh, nms_thresh, max_dets, class_valid,
            rpn_pre_nms)

    def roi_candidates(self, feats, props, props_valid, image_sizes,
                       class_code, score_thresh: float,
                       class_valid: Optional[torch.Tensor] = None):
        """The ROI stage up to its NMS: per image, softmax without the
        background column, class-agnostic decode, clip, and the (P, E) grid
        flattened row-major into candidates -> boxes (B, P*E, 4), scores,
        classes and valid (B, P*E)."""
        b, p = props.shape[:2]
        n_codes = (class_code["cls_conv"].shape[0]
                   if class_code is not None else self.num_classes)
        if class_valid is None:
            class_valid = torch.ones((n_codes,), dtype=torch.bool,
                                     device=props.device)
        hw = image_sizes.float()
        out = []
        for i in range(b):
            scores, rdeltas = self.roi_forward(
                [f[i:i + 1] for f in feats], props[i], props_valid[i],
                class_code)
            probs = torch.softmax(scores, dim=-1)[:, :-1]  # drop background
            e = probs.shape[1]
            boxes = decode_deltas(props[i], rdeltas, ROI_DELTA_WEIGHTS)
            lim = torch.stack([hw[i, 1], hw[i, 0], hw[i, 1], hw[i, 0]])
            boxes = torch.minimum(torch.clamp(boxes, min=0.0), lim)
            flat = probs.reshape(-1)
            valid = (props_valid[i].repeat_interleave(e)
                     & (flat > score_thresh) & class_valid[:e].repeat(p))
            out.append((boxes.repeat_interleave(e, dim=0), flat,
                        torch.arange(e, device=flat.device).repeat(p),
                        valid))
        return [torch.stack(parts) for parts in zip(*out)]

    def _two_stage_infer(self, images, class_code, anchors, level_splits,
                         image_sizes, rpn_post_nms, score_thresh, nms_thresh,
                         max_dets, class_valid, rpn_pre_nms) -> Detections:
        feats, obj_logits, deltas = self.forward_rpn(images)
        props, _, props_valid = rpn_proposals(
            obj_logits, deltas, anchors, level_splits, image_sizes,
            pre_nms_topk=rpn_pre_nms, post_nms_topk=rpn_post_nms)
        boxes, scores, classes, valid = self.roi_candidates(
            feats, props, props_valid, image_sizes, class_code, score_thresh,
            class_valid)
        nb, ns, nc, nv, _ = batched_multiclass_nms(
            boxes, scores, classes, valid, nms_thresh, max_dets)
        return Detections(
            boxes=nb, scores=ns, classes=nc.to(torch.int32), valid=nv,
            locations=torch.zeros((*nb.shape[:2], 2), dtype=torch.float32,
                                  device=nb.device),
            fpn_levels=torch.zeros(nb.shape[:2], dtype=torch.int32,
                                   device=nb.device))
