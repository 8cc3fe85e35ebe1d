"""Loss primitives (port of sylph_tpu/ops/losses.py).

Plain float32 torch expressions in the JAX package's order of operations;
autograd gives their backward passes. ``torch.maximum``/``torch.minimum``
split the gradient of a tie as ``jnp.maximum``/``jnp.minimum`` do.
"""

from __future__ import annotations

import torch


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # numerically stable: max(x, 0) - x * t + log(1 + exp(-|x|)); -|x| is
    # written so that its gradient at 0 is -1, as jnp.abs's is 1 there
    neg_abs = torch.where(x >= 0, -x, x)
    return (torch.maximum(x, torch.zeros_like(x)) - x * t
            + torch.log1p(torch.exp(neg_abs)))


def bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(x.float(), t.float())


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Element-wise sigmoid focal loss (fvcore ``sigmoid_focal_loss`` with
    reduction "none")."""
    logits = logits.float()
    targets = targets.float()
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def iou_loss_ltrb(pred: torch.Tensor, target: torch.Tensor,
                  loss_type: str = "giou") -> torch.Tensor:
    """IoU-family losses on FCOS (l, t, r, b) distances; element-wise over
    the leading axes (reference IOULoss, iou_loss.py:26-86)."""
    pred = pred.float()
    target = target.float()
    pl_, pt_, pr_, pb_ = pred.unbind(-1)
    tl_, tt_, tr_, tb_ = target.unbind(-1)

    target_area = (tl_ + tr_) * (tt_ + tb_)
    pred_area = (pl_ + pr_) * (pt_ + pb_)

    w_intersect = torch.minimum(pl_, tl_) + torch.minimum(pr_, tr_)
    h_intersect = torch.minimum(pb_, tb_) + torch.minimum(pt_, tt_)
    g_w = torch.maximum(pl_, tl_) + torch.maximum(pr_, tr_)
    g_h = torch.maximum(pb_, tb_) + torch.maximum(pt_, tt_)

    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect
    ac_union = g_w * g_h

    ious = (area_intersect + 1.0) / (area_union + 1.0)
    gious = ious - (ac_union - area_union) / torch.clamp(ac_union, min=1e-9)

    if loss_type == "iou":
        return -torch.log(ious)
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        return 1.0 - gious
    raise ValueError(f"unknown iou loss type {loss_type}")


def compute_ious_ltrb(pred: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
    """Plain IoU between ltrb encodings (the BOX_QUALITY='iou' target)."""
    pred = pred.float()
    target = target.float()
    target_area = ((target[..., 0] + target[..., 2])
                   * (target[..., 1] + target[..., 3]))
    pred_area = (pred[..., 0] + pred[..., 2]) * (pred[..., 1] + pred[..., 3])
    w_i = (torch.minimum(pred[..., 0], target[..., 0])
           + torch.minimum(pred[..., 2], target[..., 2]))
    h_i = (torch.minimum(pred[..., 3], target[..., 3])
           + torch.minimum(pred[..., 1], target[..., 1]))
    area_i = w_i * h_i
    area_u = target_area + pred_area - area_i
    return (area_i + 1.0) / (area_u + 1.0)
