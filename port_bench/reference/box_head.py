"""Faster R-CNN's box head and the test-time candidates of the ROI stage.

The pooled (C, 7, 7) features of each proposal are flattened in (y, x, c)
order (the converted weights' layout) into two fully connected layers with
ReLU (``fc1``, ``fc2``); the conditional classifier gives the class logits
(background last) and ``bbox_pred`` one class-agnostic set of deltas.
Candidates: softmax over every column, the background dropped; each
proposal's box decoded with weights (10, 10, 5, 5) and clipped to the
image; every (proposal, class) pair whose probability exceeds the
threshold, flattened proposal-major.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from .arith import Arith
from .boxes import decode
from .conditional import rcnn_logits

DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class ROIOutputs(NamedTuple):
    probs: torch.Tensor  # (P, N) class probabilities, background dropped
    boxes: torch.Tensor  # (P, 4) decoded and clipped


def box_head(sd, pooled: torch.Tensor, proposals: torch.Tensor,
             bank: Dict[str, torch.Tensor], image_hw: Sequence[float],
             arith: Arith, prefix: str = "box_head.") -> ROIOutputs:
    p = prefix
    x = pooled.float().permute(0, 2, 3, 1).reshape(pooled.shape[0], -1)
    x = F.relu(arith.linear(x, sd[f"{p}fc1.weight"], sd[f"{p}fc1.bias"]))
    x = F.relu(arith.linear(x, sd[f"{p}fc2.weight"], sd[f"{p}fc2.bias"]))
    logits = rcnn_logits(x, bank, sd[f"{p}bg_weight"], sd[f"{p}bg_bias"],
                         arith)
    deltas = arith.linear(x, sd[f"{p}bbox_pred.weight"],
                          sd[f"{p}bbox_pred.bias"])
    boxes = decode(proposals.float(), deltas, DELTA_WEIGHTS)
    h, w = float(image_hw[0]), float(image_hw[1])
    lim = torch.tensor([w, h, w, h], device=boxes.device)
    return ROIOutputs(torch.softmax(logits, -1)[:, :-1],
                      torch.minimum(boxes.clamp(min=0), lim))
