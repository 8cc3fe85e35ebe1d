"""Box delta encoding and decoding, Faster R-CNN's Box2BoxTransform (port of
sylph_tpu/ops/boxes.py)."""

from __future__ import annotations

import torch

# log(1000 / 16), detectron2's clamp on the width and height deltas
DELTA_CLAMP = 4.135166556742356


def encode_deltas(src: torch.Tensor, target: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Deltas that map src boxes (anchors or proposals) onto target boxes."""
    sw = torch.clamp(src[..., 2] - src[..., 0], min=1e-6)
    sh = torch.clamp(src[..., 3] - src[..., 1], min=1e-6)
    sx = src[..., 0] + 0.5 * sw
    sy = src[..., 1] + 0.5 * sh
    tw = torch.clamp(target[..., 2] - target[..., 0], min=1e-6)
    th = torch.clamp(target[..., 3] - target[..., 1], min=1e-6)
    tx = target[..., 0] + 0.5 * tw
    ty = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    return torch.stack([wx * (tx - sx) / sw, wy * (ty - sy) / sh,
                        ww * torch.log(tw / sw), wh * torch.log(th / sh)],
                       dim=-1)


def decode_deltas(src: torch.Tensor, deltas: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0),
                  clamp: float = DELTA_CLAMP) -> torch.Tensor:
    """Apply deltas to src boxes; the scale deltas are clamped to
    [-clamp, clamp] after the weights divide them."""
    sw = torch.clamp(src[..., 2] - src[..., 0], min=1e-6)
    sh = torch.clamp(src[..., 3] - src[..., 1], min=1e-6)
    sx = src[..., 0] + 0.5 * sw
    sy = src[..., 1] + 0.5 * sh
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, -clamp, clamp)
    dh = torch.clamp(deltas[..., 3] / wh, -clamp, clamp)
    cx = sx + dx * sw
    cy = sy + dy * sh
    w = sw * torch.exp(dw)
    h = sh * torch.exp(dh)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)
