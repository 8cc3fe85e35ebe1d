"""ROIAlign (V2 / "aligned" semantics) in plain PyTorch indexing (port of
sylph_tpu/ops/roi_align.py).

The JAX package builds this from XLA gathers, not from a Pallas kernel, so
the port's version is tensor code too. Every detail is kept:

  * ``aligned=True``: continuous coordinate c maps to index c*scale - 0.5;
  * ``sampling_ratio == 0``: adaptive grids ``ceil(roi / P)`` per bin edge,
    **capped at ``max_grid``** (a static lattice of ``max_grid`` slots per
    edge, slots beyond the ROI's grid masked);
  * samples outside (-1, H) x (-1, W) contribute zero but still count in
    the bin average (count = max(grid_h * grid_w, 1));
  * a degenerate ROI edge (grid 0) gives zeros;
  * multilevel assignment ``floor(4 + log2(sqrt(area) / 224 + 1e-8))``,
    clamped to the levels present; invalid boxes give zeros.

Dispatch follows the device: on CUDA tensors ``roi_align`` and
``multilevel_roi_align`` launch the hand-written kernel
(``ops/roi_align_kernel.py``, ``csrc/roi_align.cu``), which pools each ROI
at its assigned level only, or raise; on CPU tensors they run the plain
twins ``roi_align_plain`` and ``multilevel_roi_align_plain``. The kernel's
gradient with respect to the maps is the twin's (``KernelROIAlign``).

The bilinear taps read the map through ``_Gather``, whose backward sums
each pixel's gradients in the order the taps name it, on either device, so
a run repeats its bits. Autograd's own backward of the indexing
(``index_put_`` with ``accumulate``) sorts the indices on the card and
sums each run in order, but on the CPU it sums across threads in a
varying order; ``_Gather`` keeps it on the card and uses ``index_add_``,
which sums in index order, on the CPU.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import roi_align_kernel
from ..structures import box_area


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              batch_idx: torch.Tensor, *, spatial_scale: float,
              output_size: int, sampling_ratio: int = 0,
              max_grid: int = 4) -> torch.Tensor:
    """Pool ROIs from one feature level: ``roi_align_plain``'s arguments
    and result; on CUDA tensors the kernel with one level."""
    opts = dict(output_size=output_size, sampling_ratio=sampling_ratio,
                max_grid=max_grid)

    def twin(maps, bx):
        return roi_align_plain(maps[0], bx, batch_idx,
                               spatial_scale=spatial_scale, **opts)
    if not (features.is_cuda or boxes.is_cuda):
        return twin([features], boxes)
    n = boxes.shape[0]

    def kernel(maps, bx):
        return roi_align_kernel.roi_align_cuda(
            maps, bx, batch_idx,
            torch.zeros(n, dtype=torch.long, device=bx.device),
            torch.ones(n, dtype=torch.bool, device=bx.device),
            [spatial_scale], **opts)
    return roi_align_kernel.KernelROIAlign.apply(kernel, twin, boxes,
                                                 features)


def roi_align_plain(features: torch.Tensor, boxes: torch.Tensor,
                    batch_idx: torch.Tensor, *, spatial_scale: float,
                    output_size: int, sampling_ratio: int = 0,
                    max_grid: int = 4) -> torch.Tensor:
    """Pool ROIs from one feature level (the plain twin).

    Args:
      features: (B, C, H, W).
      boxes: (N, 4) XYXY in input image coordinates.
      batch_idx: (N,) int64 — the image each box pools from.
      spatial_scale: 1/stride of this level.
      output_size: P — output is P x P.
      sampling_ratio: sub-samples per bin edge; 0 = adaptive.
      max_grid: static lattice size per bin edge for the adaptive mode.

    Returns:
      (N, C, P, P) pooled features in float32 whatever the features' dtype:
      the samples are weighted by float32 factors, as in the JAX op.
    """
    h, w = features.shape[-2:]
    n = boxes.shape[0]
    p = output_size
    s = sampling_ratio if sampling_ratio > 0 else max_grid
    dev = features.device

    boxes = boxes.float() * spatial_scale
    x1, y1, x2, y2 = (boxes[:, 0] - 0.5, boxes[:, 1] - 0.5,
                      boxes[:, 2] - 0.5, boxes[:, 3] - 0.5)
    bin_w = (x2 - x1) / p  # (N,)
    bin_h = (y2 - y1) / p

    if sampling_ratio > 0:
        g_h = torch.full((n,), s, dtype=torch.int32, device=dev)
        g_w = torch.full((n,), s, dtype=torch.int32, device=dev)
    else:
        g_h = torch.clamp(torch.clamp(torch.ceil(bin_h), max=s).to(torch.int32),
                          min=0)
        g_w = torch.clamp(torch.clamp(torch.ceil(bin_w), max=s).to(torch.int32),
                          min=0)

    # Sample positions: pos[n, pi, si] = start + (pi + (si+0.5)/g) * bin
    grid_p = torch.arange(p, dtype=torch.float32, device=dev)
    grid_s = torch.arange(s, dtype=torch.float32, device=dev)
    offs_y = (grid_s[None] + 0.5) / torch.clamp(g_h, min=1)[:, None].float()
    offs_x = (grid_s[None] + 0.5) / torch.clamp(g_w, min=1)[:, None].float()
    frac_y = grid_p[None, :, None] + offs_y[:, None, :]  # (N, P, S)
    frac_x = grid_p[None, :, None] + offs_x[:, None, :]
    ys = y1[:, None, None] + frac_y * bin_h[:, None, None]
    xs = x1[:, None, None] + frac_x * bin_w[:, None, None]
    valid_y = grid_s[None] < g_h[:, None]  # (N, S)
    valid_x = grid_s[None] < g_w[:, None]
    count = torch.clamp(g_h * g_w, min=1).float()  # (N,)

    out = _bilinear_pool(features, batch_idx, ys, xs, valid_y, valid_x,
                         count, h, w)
    return out.reshape(n, p, p, -1).permute(0, 3, 1, 2)


class _Gather(torch.autograd.Function):
    """``feat[b, y, x]`` of a (B, H, W, C) map with broadcast index
    tensors; the backward sums each pixel's gradients in tap order."""

    @staticmethod
    def forward(ctx, feat, b, y, x):
        ctx.save_for_backward(b, y, x)
        ctx.shape = feat.shape
        return feat[b, y, x]

    @staticmethod
    def backward(ctx, grad):
        b, y, x = ctx.saved_tensors
        _, h, w, c = ctx.shape
        out = grad.new_zeros(ctx.shape)
        if grad.is_cuda:   # sorts the indices, sums each run in order
            out.index_put_((b.expand_as(y), y, x), grad, accumulate=True)
        else:
            out.view(-1, c).index_add_(0, ((b * h + y) * w + x).reshape(-1),
                                       grad.reshape(-1, c))
        return out, None, None, None


def _bilinear_pool(features, batch_idx, ys, xs, valid_y, valid_x, count,
                   h, w):
    """Masked-average bilinear samples: ys/xs (N,P,S) -> (N, P*P, C)."""
    n, p, s = ys.shape
    yf = ys[:, :, :, None, None].expand(n, p, s, p, s).reshape(n, -1)
    xf = xs[:, None, None, :, :].expand(n, p, s, p, s).reshape(n, -1)

    inside = (yf > -1.0) & (yf < h) & (xf > -1.0) & (xf < w)
    yf = torch.clamp(yf, 0.0, h - 1)
    xf = torch.clamp(xf, 0.0, w - 1)
    y0 = torch.floor(yf)
    x0 = torch.floor(xf)
    y1i = torch.clamp(y0 + 1, max=h - 1).long()
    x1i = torch.clamp(x0 + 1, max=w - 1).long()
    ly = yf - y0
    lx = xf - x0
    y0i = y0.long()
    x0i = x0.long()

    feat = features.permute(0, 2, 3, 1)  # (B, H, W, C)
    b = batch_idx[:, None]

    def gather(yi, xi):
        return _Gather.apply(feat, b, yi, xi)  # (N, PPSS, C)

    wy1, wx1 = ly[..., None], lx[..., None]
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    val = (gather(y0i, x0i) * wy0 * wx0 + gather(y0i, x1i) * wy0 * wx1
           + gather(y1i, x0i) * wy1 * wx0 + gather(y1i, x1i) * wy1 * wx1)
    val = torch.where(inside[..., None], val, 0.0)

    c = val.shape[-1]
    val = val.reshape(n, p, s, p, s, c)
    lattice = (valid_y[:, None, :, None, None, None]
               & valid_x[:, None, None, None, :, None])
    val = torch.where(lattice, val, 0.0)
    out = val.sum(dim=(2, 4)) / count[:, None, None, None]
    return out.reshape(n, p * p, c)


def assign_levels(boxes: torch.Tensor, strides: Sequence[int],
                  num_levels: int, canonical_level: int = 4,
                  canonical_box_size: int = 224) -> torch.Tensor:
    """(N,) int64 index into the levels: ``floor(canonical_level +
    log2(sqrt(area) / canonical_box_size + 1e-8))``, clamped to the levels
    present."""
    min_level = int(math.log2(strides[0]))
    area = box_area(boxes.float())
    target = torch.floor(canonical_level + torch.log2(
        torch.sqrt(torch.clamp(area, min=1e-6)) / canonical_box_size + 1e-8))
    target = torch.clamp(target, min_level, min_level + num_levels - 1)
    return target.long() - min_level


def multilevel_roi_align(features: Sequence[torch.Tensor],
                         strides: Sequence[int], boxes: torch.Tensor,
                         valid: torch.Tensor, batch_idx: torch.Tensor, *,
                         output_size: int, sampling_ratio: int = 0,
                         max_grid: int = 4, canonical_level: int = 4,
                         canonical_box_size: int = 224) -> torch.Tensor:
    """FPN-level-assigned ROIAlign (detectron2 ROIPooler semantics):
    ``multilevel_roi_align_plain``'s arguments and result. On CUDA tensors
    one kernel launch pools each ROI at its level; the levels are assigned
    on the card by ``assign_levels``."""
    opts = dict(output_size=output_size, sampling_ratio=sampling_ratio,
                max_grid=max_grid)
    levels = dict(canonical_level=canonical_level,
                  canonical_box_size=canonical_box_size)

    def twin(maps, bx):
        return multilevel_roi_align_plain(maps, strides, bx, valid,
                                          batch_idx, **opts, **levels)
    if not (boxes.is_cuda or any(f.is_cuda for f in features)):
        return twin(features, boxes)

    def kernel(maps, bx):
        return roi_align_kernel.roi_align_cuda(
            maps, bx, batch_idx,
            assign_levels(bx, strides, len(maps), **levels), valid,
            [1.0 / s for s in strides[:len(maps)]], **opts)
    return roi_align_kernel.KernelROIAlign.apply(kernel, twin, boxes,
                                                 *features)


def multilevel_roi_align_plain(features: Sequence[torch.Tensor],
                               strides: Sequence[int], boxes: torch.Tensor,
                               valid: torch.Tensor, batch_idx: torch.Tensor,
                               *, output_size: int, sampling_ratio: int = 0,
                               max_grid: int = 4, canonical_level: int = 4,
                               canonical_box_size: int = 224) -> torch.Tensor:
    """FPN-level-assigned ROIAlign, the plain twin: every ROI pooled at
    every level, then its own level kept.

    Args:
      features: list of (B, C, H_l, W_l) maps, one per level.
      strides: per-level strides.
      boxes: (N, 4) XYXY image coords; valid: (N,) bool; batch_idx: (N,).

    Returns:
      (N, C, P, P) float32 pooled features (zeros for invalid boxes).
    """
    level_idx = assign_levels(boxes, strides, len(features), canonical_level,
                              canonical_box_size)
    pooled = torch.stack([
        roi_align_plain(f, boxes, batch_idx, spatial_scale=1.0 / s,
                        output_size=output_size,
                        sampling_ratio=sampling_ratio, max_grid=max_grid)
        for f, s in zip(features, strides)
    ])  # (L, N, C, P, P)
    out = pooled[level_idx, torch.arange(boxes.shape[0],
                                         device=boxes.device)]
    return out * valid[:, None, None, None].to(out.dtype)
