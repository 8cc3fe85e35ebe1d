"""Modulated deformable convolution (DCNv2), NCHW (port of
sylph_tpu/ops/deform_conv.py).

Each kernel tap samples the input at a learned fractional offset from its
integer position, bilinearly, with the DCN CUDA kernel's semantics: a corner
outside the map reads zero (a per-corner mask on the blend weight), however
far outside the sample lies. The taps are then one product
``(B*H*W, K*Cin) x (K*Cin, Cout)``, the contraction a dense conv lowers to.

Everything is plain torch indexing, so autograd gives the gradients with
respect to the input, the offsets, the mask and the kernel (``floor`` has a
zero gradient, as in JAX). The JAX package's version is XLA gathers and an
einsum, not a Pallas kernel; this is its counterpart.

Offset channels: per tap t (row-major over the kernel window) ``[2t] = dy``
and ``[2t + 1] = dx``; the mask has one channel per tap.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..models.layers import Conv2d


def _bilinear_sample(x: torch.Tensor, py: torch.Tensor,
                     px: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) channels-last; py, px (B, H', W') fractional positions
    -> (B, H', W', C) in x's dtype, zero outside the border. The corners are
    blended in the JAX order (0,0), (0,1), (1,0), (1,1)."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy1 = py - y0
    wx1 = px - x0
    out = torch.zeros((*py.shape, c), dtype=x.dtype, device=x.device)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy, xx = y0 + dy, x0 + dx
            valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            corner = torch.gather(
                flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
            wgt = (wy * wx * valid).to(x.dtype)
            out = out + corner.reshape(*py.shape, c) * wgt[..., None]
    return out


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  dilation: int = 1) -> torch.Tensor:
    """Modulated deformable conv, stride 1, SAME padding.

    x (B, Cin, H, W); offset (B, 2K, H, W) float32; mask (B, K, H, W) in
    [0, 1] or None (DCNv1); weight (Cout, Cin, kh, kw); bias (Cout,).
    Returns (B, Cout, H, W) in x's dtype; the product sums in float32.
    """
    b, c, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    xl = x.permute(0, 2, 3, 1)                     # (B, H, W, C)
    base_y = torch.arange(h, dtype=offset.dtype,
                          device=x.device)[None, :, None]
    base_x = torch.arange(w, dtype=offset.dtype,
                          device=x.device)[None, None, :]
    taps = []
    for t in range(k):
        ki, kj = t // kw, t % kw
        py = base_y + (ki - (kh - 1) // 2) * dilation + offset[:, 2 * t]
        px = base_x + (kj - (kw - 1) // 2) * dilation + offset[:, 2 * t + 1]
        val = _bilinear_sample(xl, py, px)
        if mask is not None:
            val = val * mask[:, t, :, :, None].to(val.dtype)
        taps.append(val)
    # tap-major, then input channel: the order of the (kh, kw, Cin) rows
    stacked = torch.cat(taps, dim=-1).reshape(-1, k * c)
    kernel = weight.permute(2, 3, 1, 0).reshape(k * c, cout)
    out = torch.matmul(stacked.float(), kernel.to(x.dtype).float())
    if bias is not None:
        out = out + bias.float()
    return out.reshape(b, h, w, cout).permute(0, 3, 1, 2).to(x.dtype)


class DFConv2d(nn.Module):
    """The deformable tower conv: ``offset`` (a conv, dilated as the layer
    is, predicting 2K offsets and, modulated, K mask logits; zero-initialized,
    so the layer starts as a plain conv scaled by sigmoid(0) = 0.5), then
    ``deform_conv2d`` with ``weight`` (Cout, Cin, k, k), ``bias`` and
    ``dilation``. It runs in its input's dtype;
    the offsets and the mask are float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dilation: int = 1,
                 with_modulated_dcn: bool = True, bias: bool = True):
        super().__init__()
        self.k = kernel_size * kernel_size
        self.dilation = dilation
        self.with_modulated_dcn = with_modulated_dcn
        self.offset = Conv2d(in_channels,
                             self.k * (3 if with_modulated_dcn else 2),
                             kernel_size, dilation=dilation)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.offset(x).float()
        offset = om[:, :2 * self.k]
        mask = (torch.sigmoid(om[:, 2 * self.k:])
                if self.with_modulated_dcn else None)
        return deform_conv2d(x, offset, mask, self.weight, self.bias,
                             self.dilation)

