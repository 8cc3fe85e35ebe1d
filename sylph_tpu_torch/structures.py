"""Fixed-shape, mask-validated ground truth and detector outputs (port of
sylph_tpu/structures.py).

Every tensor has a static leading box axis plus an explicit validity mask;
box coordinates are XYXY in absolute pixels of the network input canvas.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GTBoxes:
    """Padded ground truth for one image, or a batch with leading axes (JAX
    ``structures.GTBoxes``).

    boxes:  (..., M, 4) float32 XYXY
    labels: (..., M)    int contiguous category ids
    valid:  (..., M)    bool
    """

    boxes: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor

    def __getitem__(self, i) -> "GTBoxes":
        """The ground truth of image (or images) ``i`` of a batch."""
        return GTBoxes(self.boxes[i], self.labels[i], self.valid[i])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between two XYXY box sets: (..., N, 4), (..., M, 4) -> (..., N, M);
    0 where the union is empty."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)


@dataclasses.dataclass(frozen=True)
class Detections:
    """Padded detector output (JAX ``structures.Detections``).

    boxes:      (..., K, 4) float32 XYXY on the network input canvas
    scores:     (..., K)    float32
    classes:    (..., K)    int32
    valid:      (..., K)    bool
    locations:  (..., K, 2) float32 — the FCOS location that produced the box
    fpn_levels: (..., K)    int32
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    locations: torch.Tensor
    fpn_levels: torch.Tensor

    @property
    def max_detections(self) -> int:
        return self.scores.shape[-1]

    def numpy(self) -> "Detections":
        """The same fields as host numpy arrays."""
        return Detections(**{f.name: getattr(self, f.name).cpu().numpy()
                             for f in dataclasses.fields(self)})


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))


def clip_boxes(boxes: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Clip XYXY boxes to [0,W]x[0,H] (detectron2 Boxes.clip semantics)."""
    h, w = size_hw
    x1 = torch.clamp(boxes[..., 0], 0.0, w)
    y1 = torch.clamp(boxes[..., 1], 0.0, h)
    x2 = torch.clamp(boxes[..., 2], 0.0, w)
    y2 = torch.clamp(boxes[..., 3], 0.0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
