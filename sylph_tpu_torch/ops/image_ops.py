"""Device-side image front-end: shortest-edge resize and pad on the card
(port of sylph_tpu/ops/image_ops.py).

  host:   copy the raw uint8 frame into a fixed staging canvas (no
          resample) and upload it;
  device: bilinear shortest-edge resize by gathers, content masking, cast
          to float32 -- ready for the backbone, which applies mean/std.

The JAX functions are XLA gathers, not Pallas kernels, so plain torch
indexing on whatever device the staging tensor lives on is the
counterpart. The scale and the content size are computed on the host in
float32 with round-half-to-even, as ``jnp.round`` does on the JAX side: a
float64 computation can land one pixel off at .5 boundaries.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _content_size(h: int, w: int, out_hw: Tuple[int, int], short: int,
                  max_size: int) -> Tuple[np.float32, np.float32]:
    """Resized (nh, nw) in float32, with the JAX package's operations."""
    f32 = np.float32
    h, w = f32(h), f32(w)
    oh, ow = out_hw
    scale = f32(short) / min(h, w)
    if max(h, w) * scale > f32(max_size):
        scale = f32(max_size) / max(h, w)
    # clamp so the result fits the output canvas
    scale = min(scale, min(f32(oh) / h, f32(ow) / w))
    return np.round(h * scale), np.round(w * scale)


def resize_shortest_edge_device(
    staging: torch.Tensor, src_hw: Sequence[int], *,
    out_hw: Tuple[int, int], short: int, max_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 ResizeShortestEdge on the staging tensor's device.

    staging: (Hs, Ws, 3) uint8 or float, the raw frame at the top-left;
      anything beyond ``src_hw`` is ignored.
    src_hw: the frame's (h, w) as two ints (a host value).

    Returns (canvas (outH, outW, 3) float32 on the staging device, the
    resized content at the top-left and zeros elsewhere; content_hw (2,)
    int32 on the host).
    """
    h, w = int(src_hw[0]), int(src_hw[1])
    oh, ow = out_hw
    nh, nw = _content_size(h, w, out_hw, short, max_size)
    dev = staging.device
    f32 = torch.float32

    # bilinear sample grid over the OUTPUT canvas; pixels beyond the
    # resized content are masked to zero
    ys = (torch.arange(oh, dtype=f32, device=dev) + 0.5) \
        * float(np.float32(h) / nh) - 0.5
    xs = (torch.arange(ow, dtype=f32, device=dev) + 0.5) \
        * float(np.float32(w) / nw) - 0.5
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]

    img = staging.to(f32)
    y0i, y1i = y0.long(), y1.long()
    x0i, x1i = x0.long(), x1.long()

    def g(yi, xi):
        return img[yi[:, None], xi[None, :]]

    out = (g(y0i, x0i) * (1 - wy) * (1 - wx) + g(y0i, x1i) * (1 - wy) * wx
           + g(y1i, x0i) * wy * (1 - wx) + g(y1i, x1i) * wy * wx)
    row_ok = torch.arange(oh, device=dev)[:, None, None] < int(nh)
    col_ok = torch.arange(ow, device=dev)[None, :, None] < int(nw)
    out = torch.where(row_ok & col_ok, out, 0.0)
    return out, torch.tensor([int(nh), int(nw)], dtype=torch.int32)


def preprocess_batch_device(staging: torch.Tensor, src_hw, *,
                            out_hw: Tuple[int, int], short: int,
                            max_size: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The front-end for a batch of staged frames: staging (B, Hs, Ws, 3),
    src_hw (B, 2) -> canvases (B, outH, outW, 3) float32, content (B, 2)
    int32 on the host."""
    outs = [resize_shortest_edge_device(im, hw, out_hw=out_hw, short=short,
                                        max_size=max_size)
            for im, hw in zip(staging, np.asarray(src_hw).tolist())]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
