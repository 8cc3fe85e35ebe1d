"""FCOS target assignment, batched over images (port of
sylph_tpu/ops/assigner.py, which vmaps a per-image function; here the batch
axis is carried directly).

  * ltrb regression targets per (location, gt) pair;
  * optional center sampling: positives lie inside a radius-scaled sub-box
    around the gt center, clamped to the gt box, the radius proportional to
    the location's stride (fcos_outputs.py:196-252);
  * size-of-interest gating on max(ltrb) (fcos_outputs.py:306-311);
  * minimum-area tie-break among the remaining candidates, the first gt of
    equal area winning (``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does);
  * background is label -1; reg targets are divided by the stride.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = 100000000.0


class FCOSTargets(NamedTuple):
    """labels (B, K) int32, -1 = background; reg_targets (B, K, 4) float32
    (ltrb / stride); target_inds (B, K) int32, -1 where unassigned."""

    labels: torch.Tensor
    reg_targets: torch.Tensor
    target_inds: torch.Tensor


def assign_fcos_targets(locations: torch.Tensor, strides: torch.Tensor,
                        size_ranges: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_labels: torch.Tensor, gt_valid: torch.Tensor, *,
                        center_sample: bool = True,
                        radius: float = 1.5) -> FCOSTargets:
    """locations (K, 2) (x, y); strides (K,); size_ranges (K, 2); padded gt
    boxes (B, M, 4), labels (B, M), valid (B, M)."""
    xs = locations[:, 0][None, :, None]             # (1, K, 1)
    ys = locations[:, 1][None, :, None]
    boxes = gt_boxes.float()
    bx0, by0 = boxes[:, None, :, 0], boxes[:, None, :, 1]  # (B, 1, M)
    bx1, by1 = boxes[:, None, :, 2], boxes[:, None, :, 3]

    ltrb = torch.stack([xs - bx0, ys - by0, bx1 - xs, by1 - ys],
                       dim=-1)                       # (B, K, M, 4)

    if center_sample:
        cx = (boxes[..., 0] + boxes[..., 2]) * 0.5    # (B, M)
        cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
        rad = (strides * radius)[None, :, None]       # (1, K, 1)
        x1 = torch.maximum(cx[:, None, :] - rad, bx0)
        y1 = torch.maximum(cy[:, None, :] - rad, by0)
        x2 = torch.minimum(cx[:, None, :] + rad, bx1)
        y2 = torch.minimum(cy[:, None, :] + rad, by1)
        inside = ((xs - x1 > 0) & (ys - y1 > 0)
                  & (x2 - xs > 0) & (y2 - ys > 0))
    else:
        inside = ltrb.amin(dim=-1) > 0                # (B, K, M)

    max_ltrb = ltrb.amax(dim=-1)
    cared = ((max_ltrb >= size_ranges[None, :, 0:1])
             & (max_ltrb <= size_ranges[None, :, 1:2]))

    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    cand = inside & cared & gt_valid[:, None, :]
    cand_area = torch.where(cand, area[:, None, :],
                            torch.full_like(max_ltrb, INF))

    min_area = cand_area.amin(dim=2)
    inds = cand_area.argmin(dim=2)                    # first minimum
    is_fg = min_area < INF

    labels = torch.where(is_fg, torch.gather(gt_labels.to(torch.int32), 1,
                                             inds), -1).to(torch.int32)
    target_inds = torch.where(is_fg, inds, -1).to(torch.int32)
    reg = torch.gather(ltrb, 2, inds[:, :, None, None].expand(
        -1, -1, 1, 4))[:, :, 0, :]
    reg = reg / strides[None, :, None]
    return FCOSTargets(labels=labels, reg_targets=reg,
                       target_inds=target_inds)


def compute_ctrness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """Centerness target sqrt((min_lr / max_lr) * (min_tb / max_tb))."""
    lr = reg_targets[..., [0, 2]]
    tb = reg_targets[..., [1, 3]]
    ctr = ((lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-9))
           * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-9)))
    return torch.sqrt(torch.clamp(ctr, min=0.0))
