"""FCOS losses for pretraining and episodic meta-learning (port of
sylph_tpu/ops/fcos_losses.py).

Pure functions over the flat ``(B, K, ...)`` head outputs:
  * ``fcos_pretrain_losses`` (reference fcos_outputs.py:639-741) with the
    ``BOX_QUALITY`` dispatch, the OWD/freeze rules for which keys appear and
    the optional IOU_MASK;
  * ``fcos_episodic_losses`` (:496-637) with the per-episode one-hot class
    target and the optional distillation toward the pretrained cls_logits.

Without normalizers given, the losses normalize by the batch's own
positives. The train steps pass ``loss_normalizers``: the mean over every
micro-group of every rank (``TPU.GRAD_ACCUM`` groups on each rank of a
``DataGroup``) as ``num_pos_avg``/``loss_denorm`` (train/steps.py).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..parallel.mesh import DataGroup, cross_rank_mean
from .assigner import FCOSTargets, compute_ctrness_targets
from .losses import (bce_with_logits, compute_ious_ltrb, iou_loss_ltrb,
                     sigmoid_focal_loss)


class FCOSLossCfg(NamedTuple):
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    loc_loss_type: str = "giou"
    box_quality: Tuple[str, ...] = ("ctrness",)   # sorted, as reference
    iou_mask: bool = False
    owd: bool = False
    freeze_cls_logits: bool = False
    box_branch_loss_on: bool = True
    distill_weight: float = 0.0


def _ious_gious(reg_pred, reg_targets, pos=None):
    """IoU and GIoU at every location. Negative locations can carry
    negative ltrb targets that make ``area_union + 1`` exactly 0; the NaN
    would survive the outer mask through the backward pass (NaN * 0), so a
    benign all-ones target replaces them first (the double-where guard)."""
    if pos is not None:
        reg_targets = torch.where(pos[..., None], reg_targets,
                                  torch.ones_like(reg_targets))
    ious = compute_ious_ltrb(reg_pred, reg_targets)
    gious = 1.0 - iou_loss_ltrb(reg_pred, reg_targets, "giou")
    return ious, gious


def _loc_loss(ious, gious, loss_type: str):
    if loss_type == "iou":
        return -torch.log(torch.clamp(ious, min=1e-9))
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        return 1.0 - gious
    raise ValueError(loss_type)


def _masked_sum(pos, x):
    return torch.where(pos, x, torch.zeros_like(x)).sum()


def loss_normalizers(targets: FCOSTargets, m: int = 1,
                     group: Optional[DataGroup] = None):
    """``(num_pos_avg, loss_denorm)`` over ``m`` micro-groups on each rank of
    ``group``, every group treated as a rank: the positive count and the
    ctrness-target sum divided by m, averaged over the ranks, then clamped
    (train/steps.py:52-80). Clamping before the mean would floor each rank
    on its own, a different result on a batch with few positives."""
    pos = targets.labels >= 0
    ctr_t = compute_ctrness_targets(targets.reg_targets)
    ctr_t = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    sums = cross_rank_mean(torch.stack([pos.float().sum(), ctr_t.sum()]) / m,
                           group)
    return torch.clamp(sums[0], min=1.0), torch.clamp(sums[1], min=1e-6)


def fcos_pretrain_losses(
    logits: torch.Tensor,        # (B, K, C)
    reg_pred: torch.Tensor,      # (B, K, 4) stride-normalized
    ctrness_pred: torch.Tensor,  # (B, K)
    iou_pred: torch.Tensor,      # (B, K)
    targets: FCOSTargets,
    cfg: FCOSLossCfg,
    num_pos_avg: Optional[torch.Tensor] = None,
    loss_denorm: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    num_classes = logits.shape[-1]
    labels = targets.labels
    pos = labels >= 0
    if num_pos_avg is None:
        num_pos_avg = torch.clamp(pos.float().sum(), min=1.0)

    classes = torch.arange(num_classes, device=labels.device)
    class_target = (labels[..., None] == classes).float()
    cls_loss = sigmoid_focal_loss(logits, class_target, cfg.focal_alpha,
                                  cfg.focal_gamma).sum() / num_pos_avg

    ious, gious = _ious_gious(reg_pred, targets.reg_targets, pos)
    iou_fg = ious
    if cfg.iou_mask:
        iou_fg = torch.where(iou_fg < 0.3, torch.zeros_like(iou_fg), iou_fg)

    ctr_t = compute_ctrness_targets(targets.reg_targets)
    ctr_t = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    if loss_denorm is None:
        loss_denorm = torch.clamp(ctr_t.sum(), min=1e-6)

    ctr_loss = _masked_sum(pos, bce_with_logits(ctrness_pred, ctr_t)) \
        / num_pos_avg
    iou_loss_q = _masked_sum(pos, bce_with_logits(iou_pred,
                                                  iou_fg.detach())) \
        / num_pos_avg

    per_loc = _loc_loss(ious, gious, cfg.loc_loss_type)

    losses: Dict[str, torch.Tensor] = {}
    if not (cfg.owd or cfg.freeze_cls_logits):
        losses["loss_fcos_cls"] = cls_loss

    bq = tuple(sorted(cfg.box_quality))
    if bq == ("ctrness", "iou"):
        reg_loss = _masked_sum(pos, per_loc * ctr_t) / loss_denorm
        if cfg.box_branch_loss_on:
            losses["loss_fcos_iou"] = iou_loss_q
            losses["loss_fcos_ctr"] = ctr_loss
            losses["loss_fcos_loc"] = reg_loss
    elif bq == ("ctrness",):
        reg_loss = _masked_sum(pos, per_loc * ctr_t) / loss_denorm
        if cfg.box_branch_loss_on:
            losses["loss_fcos_ctr"] = ctr_loss
            losses["loss_fcos_loc"] = reg_loss
    elif bq == ("iou",):
        reg_loss = _masked_sum(pos, per_loc) / num_pos_avg
        if cfg.box_branch_loss_on:
            losses["loss_fcos_iou"] = iou_loss_q
            losses["loss_fcos_loc"] = reg_loss
    else:
        raise NotImplementedError(f"BOX_QUALITY {bq}")
    return losses


def fcos_episodic_losses(
    logits: torch.Tensor,          # (B, K, N_way)
    reg_pred: torch.Tensor,        # (B, K, 4)
    ctrness_pred: torch.Tensor,    # (B, K)
    targets: FCOSTargets,
    episode_class_ids: torch.Tensor,   # (N_way,) contiguous dataset ids
    cfg: FCOSLossCfg,
    class_code: Optional[Dict[str, torch.Tensor]] = None,
    pretrained_kernel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    num_pos_avg: Optional[torch.Tensor] = None,
    loss_denorm: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The class target is ``episode_class_ids[c] == labels[b, k]``;
    background (-1) matches nothing."""
    labels = targets.labels
    pos = labels >= 0
    if num_pos_avg is None:
        num_pos_avg = torch.clamp(pos.float().sum(), min=1.0)

    class_target = (labels[..., None]
                    == episode_class_ids[None, None, :]).float()
    cls_loss = sigmoid_focal_loss(logits, class_target, cfg.focal_alpha,
                                  cfg.focal_gamma).sum() / num_pos_avg

    ctr_t = compute_ctrness_targets(targets.reg_targets)
    ctr_t = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    if loss_denorm is None:
        loss_denorm = torch.clamp(ctr_t.sum(), min=1e-6)

    ious, gious = _ious_gious(reg_pred, targets.reg_targets, pos)
    per_loc = _loc_loss(ious, gious, cfg.loc_loss_type)
    reg_loss = _masked_sum(pos, per_loc * ctr_t) / loss_denorm
    ctr_loss = _masked_sum(pos, bce_with_logits(ctrness_pred, ctr_t)) \
        / num_pos_avg

    losses = {"loss_fcos_cls": cls_loss}

    if (pretrained_kernel is not None and class_code is not None
            and cfg.distill_weight > 0):
        # L1 toward the pretrained cls_logits rows of the episode classes
        # (fcos_outputs.py:595-626), mean reduction
        w, b = pretrained_kernel            # (C_base, 256), (C_base,)
        ids = episode_class_ids.long()
        target_w, target_b = w[ids], b[ids]
        gen_w = class_code["cls_conv"].reshape(target_w.shape)
        gen_b = class_code["cls_bias"].reshape(target_b.shape)
        losses["loss_gen_distill"] = (
            torch.abs(gen_w - target_w).mean()
            + torch.abs(gen_b - target_b).mean()) * cfg.distill_weight

    if cfg.box_branch_loss_on:
        losses["loss_fcos_loc"] = reg_loss
        losses["loss_fcos_ctr"] = ctr_loss
    return losses
