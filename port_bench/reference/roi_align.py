"""ROIAlign with detectron2's ``aligned=True`` (ROIAlignV2) semantics and
the FPN level assignment of its ROIPooler.

A box is scaled by the level's 1/stride and shifted by -0.5; each of the
P x P bins averages g_h x g_w bilinear samples at the centres of an even
sub-grid, where g = ceil(bin size) capped at ``max_grid`` (the adaptive
sampling ratio, capped as the configurations state: a static lattice of
``max_grid`` samples a bin edge); a bin whose g is 0 is 0. A sample with y
or x beyond (-1, size) reads 0; otherwise y and x are clamped at 0 and the
last row or column, and the four neighbours are blended. Boxes go to level
floor(4 + log2(sqrt(area) / 224 + 1e-8)), clamped to the levels given.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

CHUNK = 128  # boxes pooled at a time, to bound the sample lattice's memory


def _axis(lo: torch.Tensor, bins: torch.Tensor, g: torch.Tensor, p: int,
          s: int, size: int):
    """Sample coordinates (N, P, S) along one axis, their mask (N, S), the
    low and high neighbour indices and the weight of the high one."""
    steps = torch.arange(s, device=lo.device, dtype=torch.float32)
    bins_at = torch.arange(p, device=lo.device, dtype=torch.float32)
    frac = (bins_at[None, :, None]
            + (steps[None, None, :] + 0.5) / g.clamp(min=1)[:, None, None])
    c = lo[:, None, None] + frac * bins[:, None, None]
    inside = (c >= -1.0) & (c <= size)
    c = c.clamp(min=0.0)
    low = torch.floor(c).long()
    edge = low >= size - 1
    low = torch.where(edge, torch.full_like(low, size - 1), low)
    high = torch.where(edge, low, low + 1)
    c = torch.where(edge, low.float(), c)
    return inside, steps[None] < g[:, None], low, high, c - low.float()


def roi_align(feature: torch.Tensor, boxes: torch.Tensor, stride: int,
              output: int = 7, max_grid: int = 4) -> torch.Tensor:
    """One level's map (C, H, W) and boxes (N, 4) in image pixels ->
    (N, C, P, P) float32."""
    c, h, w = feature.shape
    n = boxes.shape[0]
    p, s = output, max_grid
    out = feature.new_zeros((n, c, p, p), dtype=torch.float32)
    fmap = feature.float().permute(1, 2, 0).reshape(h * w, c)
    for i in range(0, n, CHUNK):
        b = boxes[i:i + CHUNK].float() / stride - 0.5
        m = b.shape[0]
        bin_w = (b[:, 2] - b[:, 0]) / p
        bin_h = (b[:, 3] - b[:, 1]) / p
        g_w = torch.ceil(bin_w).clamp(0, s).long()
        g_h = torch.ceil(bin_h).clamp(0, s).long()
        in_y, ok_y, y0, y1, ly = _axis(b[:, 1], bin_h, g_h, p, s, h)
        in_x, ok_x, x0, x1, lx = _axis(b[:, 0], bin_w, g_w, p, s, w)
        # (m, Py, Sy, Px, Sx) lattice
        yy0, yy1 = y0[:, :, :, None, None], y1[:, :, :, None, None]
        xx0, xx1 = x0[:, None, None], x1[:, None, None]
        wy = ly[:, :, :, None, None, None]
        wx = lx[:, None, None, :, :, None]

        def tap(yi, xi):
            return fmap[(yi * w + xi).reshape(-1)].reshape(
                m, p, s, p, s, c)
        val = ((1 - wy) * (1 - wx) * tap(yy0, xx0)
               + (1 - wy) * wx * tap(yy0, xx1)
               + wy * (1 - wx) * tap(yy1, xx0)
               + wy * wx * tap(yy1, xx1))
        keep = (in_y[:, :, :, None, None] & in_x[:, None, None]
                & ok_y[:, None, :, None, None] & ok_x[:, None, None, None, :])
        val = torch.where(keep[..., None], val, torch.zeros_like(val))
        count = (g_h * g_w).clamp(min=1).float()[:, None, None, None]
        pooled = val.sum(dim=(2, 4)) / count                  # (m, P, P, C)
        out[i:i + m] = pooled.permute(0, 3, 1, 2)
    return out


def level_of(boxes: torch.Tensor, strides: Sequence[int]) -> torch.Tensor:
    """The index into ``strides`` each box pools from."""
    lo = int(math.log2(strides[0]))
    area = ((boxes[:, 2] - boxes[:, 0])
            * (boxes[:, 3] - boxes[:, 1])).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8))
    return (lvl.clamp(lo, lo + len(strides) - 1) - lo).long()


def multilevel_roi_align(features: Sequence[torch.Tensor], image: int,
                         boxes: torch.Tensor, strides: Sequence[int],
                         output: int = 7, max_grid: int = 4) -> torch.Tensor:
    """Image ``image`` of (B, C, H, W) maps, boxes (N, 4) -> (N, C, P, P)."""
    lvl = level_of(boxes.float(), strides)
    out = boxes.new_zeros((boxes.shape[0], features[0].shape[1], output,
                           output), dtype=torch.float32)
    for li, (f, s) in enumerate(zip(features, strides)):
        sel = torch.nonzero(lvl == li).flatten()
        if sel.numel():
            out[sel] = roi_align(f[image], boxes[sel], s, output, max_grid)
    return out
