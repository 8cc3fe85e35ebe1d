"""Greedy multi-class non-maximum suppression, one image at a time.

Take the highest-scoring live candidate (the lowest index among equal
scores), keep it, and retire it and every live candidate of its class whose
IoU with it exceeds the threshold; stop after ``max_outputs`` picks or when
none is live.
"""

from __future__ import annotations

import torch


def iou_one(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one (4,) XYXY box with (K, 4) boxes; 0 where the union is 0."""
    iw = (torch.minimum(boxes[:, 2], box[2])
          - torch.maximum(boxes[:, 0], box[0])).clamp(min=0)
    ih = (torch.minimum(boxes[:, 3], box[3])
          - torch.maximum(boxes[:, 1], box[1])).clamp(min=0)
    inter = iw * ih
    area = ((boxes[:, 2] - boxes[:, 0]).clamp(min=0)
            * (boxes[:, 3] - boxes[:, 1]).clamp(min=0))
    a0 = (box[2] - box[0]).clamp(min=0) * (box[3] - box[1]).clamp(min=0)
    union = area + a0 - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float, max_outputs: int) -> torch.Tensor:
    """(K, 4), (K,), (K,), (K,) -> the picked indices in pick order."""
    boxes = boxes.float()
    live = scores.float().masked_fill(~valid, float("-inf"))
    picks = []
    for _ in range(max_outputs):
        i = int(torch.argmax(live))
        if live[i] == float("-inf"):
            break
        picks.append(i)
        gone = ((iou_one(boxes[i], boxes) > iou_threshold)
                & (classes == classes[i]))
        gone[i] = True
        live = live.masked_fill(gone, float("-inf"))
    return torch.tensor(picks, dtype=torch.long, device=boxes.device)
