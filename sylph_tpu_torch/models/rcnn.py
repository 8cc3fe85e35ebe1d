"""Two-stage few-shot detector, Meta Faster R-CNN (port of
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
flax names so converted weights load by name.

Training (``forward_episodic_train``, ``forward_pretrain_train``):

  * ``match_anchors``: detectron2's Matcher (0.3, 0.7) with low-quality
    matches by exact equality on the one IoU tensor;
  * ``subsample_labels``: static-shape subsampling by random priorities,
    thresholds read from sorted values;
  * ``rpn_losses``: objectness BCE on the sampled anchors and L1 on the
    positives, both over B x 256;
  * ``rpn_proposals`` on the detached RPN outputs (the NMS kernel on every
    step on the card), then ``sample_rois`` (proposals and GT, IoU 0.5,
    512 at 25% positives, picked by a stable sort) and ``roi_losses``
    (softmax CE with the background last, class-agnostic L1).

The sampling priorities come from a draw source (``SampleDraws``, or any
object with its two methods): the functions here take uniforms as tensors
and never draw themselves. ROIAlign runs per image (its lattice of samples
at 512 ROIs fits one image at a time); the box head runs once over every
image's ROIs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import decode_deltas, encode_deltas
from ..ops.decode import _topk_lower_index_first
from ..ops.losses import bce_with_logits, smooth_l1
from ..ops.nms import batched_multiclass_nms
from ..ops.roi_align import multilevel_roi_align
from ..structures import Detections, GTBoxes, pairwise_iou
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


# ---------------------------------------------------------------- sampling
class SampleDraws:
    """The uniforms in [0, 1) that anchor and ROI sampling rank by, from one
    CPU ``torch.Generator`` seeded by ``seed`` (one source per micro-group
    of a step: ``for_step``), moved to ``device``: a seed gives the same
    values on every device, as the ROIEncoder's dropout masks do."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)

    @staticmethod
    def step_seed(seed: int, iteration: int, group: int) -> int:
        """The generator seed of micro-group ``group`` at ``iteration``."""
        s = np.random.SeedSequence([seed, iteration, group]).generate_state(
            1, np.uint64)[0]
        return int(s) & (2 ** 63 - 1)

    @classmethod
    def for_step(cls, seed: int, iteration: int, group: int,
                 device) -> "SampleDraws":
        """The source of micro-group ``group`` at ``iteration``: a resumed run
        draws what an uninterrupted one draws."""
        return cls(cls.step_seed(seed, iteration, group), device)

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen).to(self.device)

    def rpn(self, b: int, k: int) -> torch.Tensor:
        """(B, K): each image's anchor priorities."""
        return self._uniform((b, k))

    def roi(self, b: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N) twice: each image's subsampling priorities and its tie
        breaks, over its proposals and GT slots."""
        u = self._uniform((b, 2, n))
        return u[:, 0], u[:, 1]


def match_anchors(anchors: torch.Tensor, gt: GTBoxes, lo: float = 0.3,
                  hi: float = 0.7) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher((0.3, 0.7), allow_low_quality_matches) for one
    image: -> (matched GT index (K,), label (K,) in {-1 ignore, 0 negative,
    1 positive}). An anchor whose IoU equals, exactly, the best IoU of some
    valid GT (ties included) is positive; an image without valid GT gets
    all zeros."""
    iou = pairwise_iou(anchors, gt.boxes)
    iou = torch.where(gt.valid[None, :], iou, -1.0)
    best = iou.amax(dim=1)
    idx = iou.argmax(dim=1)  # the first maximum
    label = torch.where(best >= hi, 1, torch.where(best < lo, 0, -1))
    gt_best = iou.amax(dim=0)
    is_best_for_gt = ((iou == gt_best[None, :]) & (iou > 0)
                      & gt.valid[None, :]).any(dim=1)
    label = torch.where(is_best_for_gt, 1, label)
    return idx, torch.where(gt.valid.any(), label, 0)


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    s = torch.sort(x, dim=-1, descending=True).values
    return torch.clamp(s[..., min(max(k - 1, 0), x.shape[-1] - 1)], min=0.0)


def subsample_labels(label: torch.Tensor, num_samples: int,
                     pos_fraction: float, r: torch.Tensor) -> torch.Tensor:
    """Keep ``num_samples`` per row of ``label`` (..., K) at most
    ``pos_fraction`` positive, by the priorities ``r`` (uniforms of the same
    shape): the positives at or above the k-th largest positive priority,
    then the negatives at or above the n-th largest negative one, n what
    the positives leave. -> float weights, 1 kept and 0 not."""
    k_pos = int(num_samples * pos_fraction)
    pos = label == 1
    neg = label == 0
    pos_rank = torch.where(pos, r, -1.0)
    keep_pos = pos & (pos_rank >= _kth_largest(pos_rank, k_pos)[..., None])
    num_neg = num_samples - torch.clamp(keep_pos.sum(-1), max=k_pos)
    neg_rank = torch.where(neg, r, -1.0)
    sorted_neg = torch.sort(neg_rank, dim=-1, descending=True).values
    at = torch.clamp(num_neg - 1, 0, label.shape[-1] - 1)
    neg_th = torch.clamp(sorted_neg.gather(-1, at[..., None]), min=0.0)
    keep_neg = neg & (neg_rank >= neg_th)
    return (keep_pos | keep_neg).float()


def rpn_losses(obj_logits: torch.Tensor, deltas: torch.Tensor,
               anchors: torch.Tensor, gt: GTBoxes, priorities: torch.Tensor,
               batch_per_image: int = 256, pos_fraction: float = 0.5
               ) -> Dict[str, torch.Tensor]:
    """RPN objectness BCE on each image's sampled anchors and L1 (smooth L1
    with beta 0) on its sampled positives, both summed over the batch and
    divided by B x ``batch_per_image`` (detectron2's normalization).
    ``priorities``: (B, K) uniforms. Anchors are matched one image at a
    time: a (K, M) IoU table per image."""
    b = obj_logits.shape[0]
    idx, label = (torch.stack(t) for t in zip(
        *(match_anchors(anchors, gt[i]) for i in range(b))))
    w = subsample_labels(label, batch_per_image, pos_fraction, priorities)
    pos = (label == 1) & (w > 0)
    target = encode_deltas(anchors[None], gt.boxes.gather(
        1, idx[..., None].expand(-1, -1, 4)))
    loc = torch.where(pos[..., None], smooth_l1(deltas, target, beta=0.0),
                      0.0).sum()
    obj = (w * bce_with_logits(obj_logits, label == 1)).sum()
    denom = b * batch_per_image
    return {"loss_rpn_cls": obj / denom, "loss_rpn_loc": loc / denom}


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


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, C) at the rows idx (..., S) -> (..., S, C)."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def sample_rois(proposals: torch.Tensor, prop_valid: torch.Tensor,
                gt: GTBoxes, u_sub: torch.Tensor, u_tie: torch.Tensor,
                batch_size: int = 512, pos_fraction: float = 0.25,
                iou_thresh: float = 0.5):
    """Match the proposals and the GT boxes (P + M) to the GT at
    ``iou_thresh``, subsample by ``u_sub``, then take the first
    ``batch_size`` of a stable sort by -(weight + ``u_tie`` x 1e-3): the kept
    ones first. Leading batch axes are allowed throughout. -> rois (..., S,
    4), matched GT index (..., S), positive (..., S), sampled (..., S)."""
    boxes = torch.cat([proposals, gt.boxes], -2)
    valid = torch.cat([prop_valid, gt.valid], -1)
    iou = pairwise_iou(boxes, gt.boxes)
    iou = torch.where(gt.valid[..., None, :] & valid[..., :, None], iou, -1.0)
    best = iou.amax(dim=-1)
    idx = iou.argmax(dim=-1)
    is_pos = (best >= iou_thresh) & valid
    is_neg = (best < iou_thresh) & valid
    label = torch.where(is_pos, 1, torch.where(is_neg, 0, -1))
    w = subsample_labels(label, batch_size, pos_fraction, u_sub)
    sel = torch.sort(-(w + u_tie * 1e-3), dim=-1,
                     stable=True).indices[..., :batch_size]
    w_sel = w.gather(-1, sel)
    return (_take(boxes, sel), idx.gather(-1, sel),
            (label.gather(-1, sel) == 1) & (w_sel > 0), w_sel > 0)


def roi_losses(scores: torch.Tensor, deltas: torch.Tensor,
               rois: torch.Tensor, gt: GTBoxes, matched_idx: torch.Tensor,
               is_pos: torch.Tensor, is_sampled: torch.Tensor,
               class_targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Softmax CE (the target column for positives, the last column for the
    rest) over the sampled ROIs and class-agnostic L1 on ``ROI_DELTA_WEIGHTS``
    deltas over the positives, each divided by the sampled count (detectron2
    FastRCNNOutputs). Per image: leading batch axes give per-image losses.
    ``class_targets`` (..., S): each ROI's matched GT as a score column."""
    bg = scores.shape[-1] - 1
    tgt = torch.where(is_pos, class_targets, bg)
    logp = torch.log_softmax(scores, dim=-1)
    ce = -logp.gather(-1, tgt[..., None])[..., 0]
    n_sampled = torch.clamp(is_sampled.sum(-1).float(), min=1.0)
    cls_loss = torch.where(is_sampled, ce, 0.0).sum(-1) / n_sampled
    target = encode_deltas(rois, _take(gt.boxes, matched_idx),
                           ROI_DELTA_WEIGHTS)
    loc = torch.where(is_pos[..., None], smooth_l1(deltas, target, beta=0.0),
                      0.0).sum((-2, -1)) / n_sampled
    return {"loss_cls": cls_loss, "loss_box_reg": loc}


def class_to_episode(labels: torch.Tensor, episode_class_ids: torch.Tensor
                     ) -> torch.Tensor:
    """Contiguous dataset ids -> the episode's score column (the first equal
    id), or E, past the last one, for a class not in the episode."""
    eq = labels[..., None] == episode_class_ids
    return torch.where(eq.any(-1), eq.int().argmax(-1),
                       episode_class_ids.shape[0])


# --------------------------------------------------------------- meta-arch
class FewShotRCNN(nn.Module):
    """Two-stage few-shot detector (FewShotDetector analog)."""

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
        # MODEL.BACKBONE.FREEZE: the backbone and FPN run without a graph
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
        """images (B, H, W, 3) BGR canvas -> P2..P6 (NCHW). With
        ``stop_backbone_grad`` no autograd graph is built (the JAX package's
        stop_gradient after the FPN), so no activation is kept."""
        if self.stop_backbone_grad:
            with torch.no_grad():
                return self.fpn(self.backbone(self._normalize(images)))
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

    # ------------------------------------------------------------- training
    def forward_episodic_train(
        self, support_images: torch.Tensor, support_boxes: torch.Tensor,
        support_box_valid: torch.Tensor, query_images: torch.Tensor,
        query_gt: GTBoxes, episode_class_ids: torch.Tensor, draws,
        anchors: torch.Tensor, level_splits: Sequence[int],
        image_sizes: torch.Tensor, num_shots: int, rpn_post_nms: int = 256,
        roi_batch: int = 128, rpn_pre_nms: int = 1000
    ) -> Dict[str, torch.Tensor]:
        """One episodic two-stage training forward -> loss dict (reference
        forward_few_shot_detector_training): codes from the supports, then
        the RPN and ROI losses with the ROIs classified against the
        episode's codes. ``query_gt`` is already filtered to the episode's
        classes; ``draws`` gives the sampling priorities (``SampleDraws``)."""
        sfeats = self.extract_features(support_images)
        codes = self.code_generator(
            sfeats[:self.roi_in_levels], support_boxes, support_box_valid,
            num_shots=num_shots, training=True)
        losses = self._two_stage_losses(
            query_images, query_gt, draws, anchors, level_splits,
            image_sizes, rpn_post_nms, roi_batch, rpn_pre_nms, codes,
            lambda labels: class_to_episode(labels, episode_class_ids))
        if "snnl" in codes:
            losses["loss_snnl"] = codes["snnl"]
        return losses

    def forward_pretrain_train(
        self, query_images: torch.Tensor, query_gt: GTBoxes, draws,
        anchors: torch.Tensor, level_splits: Sequence[int],
        image_sizes: torch.Tensor, rpn_post_nms: int = 256,
        roi_batch: int = 128, rpn_pre_nms: int = 1000
    ) -> Dict[str, torch.Tensor]:
        """Plain Faster R-CNN training forward (base pretraining and the
        TFA-RCNN finetune; freezing is the optimizer's mask): the classifier
        columns are the contiguous dataset labels, background last."""
        return self._two_stage_losses(
            query_images, query_gt, draws, anchors, level_splits,
            image_sizes, rpn_post_nms, roi_batch, rpn_pre_nms, None,
            lambda labels: labels)

    def _two_stage_losses(self, images, gt: GTBoxes, draws, anchors,
                          level_splits, image_sizes, rpn_post_nms: int,
                          roi_batch: int, rpn_pre_nms: int, class_code,
                          class_targets: Callable) -> Dict[str, torch.Tensor]:
        """RPN losses; proposals from the detached RPN outputs; per image
        ROI sampling and ROIAlign; one box-head pass over every image's
        ROIs; the ROI losses averaged over the images."""
        feats, obj_logits, deltas = self.forward_rpn(images)
        b, k = obj_logits.shape
        losses = rpn_losses(obj_logits, deltas, anchors, gt,
                            draws.rpn(b, k))
        props, _, props_valid = rpn_proposals(
            obj_logits.detach(), deltas.detach(), anchors, level_splits,
            image_sizes, pre_nms_topk=rpn_pre_nms,
            post_nms_topk=rpn_post_nms)
        u_sub, u_tie = draws.roi(b, props.shape[1] + gt.boxes.shape[1])
        rois, midx, is_pos, is_sampled = sample_rois(
            props, props_valid, gt, u_sub, u_tie, batch_size=roi_batch)
        ones = torch.ones(roi_batch, dtype=torch.bool, device=rois.device)
        zeros = torch.zeros(roi_batch, dtype=torch.long, device=rois.device)
        pooled = torch.cat([multilevel_roi_align(
            [f[i:i + 1] for f in feats[:self.roi_in_levels]],
            self.ROI_STRIDES, rois[i], ones, zeros,
            output_size=self.pooler_resolution) for i in range(b)])
        scores, rdeltas = self.box_head(pooled, class_code)
        rl = roi_losses(scores.view(b, roi_batch, -1),
                        rdeltas.view(b, roi_batch, -1), rois, gt, midx,
                        is_pos, is_sampled,
                        class_targets(gt.labels.gather(1, midx)))
        losses["loss_cls"] = rl["loss_cls"].mean()
        losses["loss_box_reg"] = rl["loss_box_reg"].mean()
        return losses

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
