"""Faster R-CNN's box transform (detectron2's Box2BoxTransform.apply_deltas).

A box of width w and height h centred at (x, y) moves to centre
(x + dx/wx * w, y + dy/wy * h) with width w * exp(dw/ww) and height
h * exp(dh/wh); dw/ww and dh/wh are clamped to log(1000 / 16).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

SCALE_CLAMP = math.log(1000.0 / 16)


def decode(src: torch.Tensor, deltas: torch.Tensor,
           weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(..., 4) XYXY boxes and (..., 4) deltas -> (..., 4) XYXY boxes."""
    w = (src[..., 2] - src[..., 0]).clamp(min=1e-6)
    h = (src[..., 3] - src[..., 1]).clamp(min=1e-6)
    x = src[..., 0] + 0.5 * w
    y = src[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    cx = x + deltas[..., 0] / wx * w
    cy = y + deltas[..., 1] / wy * h
    nw = w * torch.exp((deltas[..., 2] / ww).clamp(-SCALE_CLAMP, SCALE_CLAMP))
    nh = h * torch.exp((deltas[..., 3] / wh).clamp(-SCALE_CLAMP, SCALE_CLAMP))
    return torch.stack([cx - 0.5 * nw, cy - 0.5 * nh,
                        cx + 0.5 * nw, cy + 0.5 * nh], -1)
