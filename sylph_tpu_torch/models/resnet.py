"""Caffe-style ResNet backbone with frozen BN, NCHW (port of
sylph_tpu/models/resnet.py).

  * caffe bottlenecks: the spatial stride sits in the 1x1 ``conv1``;
  * FrozenBatchNorm: y = x * scale + bias with (scale, bias) as buffers;
  * stem: 7x7/2 conv + frozen BN + relu + 3x3/2 max pool (pads with -inf);
    with ``s2d_stem`` (TPU.S2D_STEM) the conv is its exact rewrite, a 4x4/1
    conv over 2x2 space-to-depth input (``SpaceToDepthStem``), whose weight
    (O, 4C, 4, 4) ``stem_kernel_to_s2d`` and ``stem_kernel_from_s2d`` carry
    to and from the 7x7 one;
  * symmetric torch padding k // 2 on every other conv.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d

# block counts per stage for each depth
RESNET_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenBatchNorm(nn.Module):
    """BN with statistics folded into constant buffers (scale, bias)."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.scale.to(x.dtype)[None, :, None, None]
                + self.bias.to(x.dtype)[None, :, None, None])


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, b*b*C, H/b, W/b), channels in (row phase, column
    phase, channel) order, as the JAX package's NHWC ``space_to_depth``."""
    b, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: a {h}x{w} canvas is not a "
                         f"multiple of {block} on each side (TPU.S2D_STEM "
                         "needs even canvases)")
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, block * block * c,
                                               h // block, w // block)


def _s2d_taps():
    """(d, p, e, q) -> (u, v): the 4x4 tap (d, e) at row phase p and column
    phase q reads the 7x7 tap (u, v); taps off the 7x7 support are left
    out (the scatter is a pure reindexing, injective on that support)."""
    for d in range(4):
        for p in range(2):
            u = 2 * (d - 2) + p + 3
            for e in range(4):
                for q in range(2):
                    v = 2 * (e - 2) + q + 3
                    if 0 <= u < 7 and 0 <= v < 7:
                        yield d, p, e, q, u, v


def stem_kernel_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """A (O, C, 7, 7) stride-2 stem kernel scattered into the equivalent
    (O, 4C, 4, 4) stride-1 kernel over 2x2 space-to-depth input (JAX's
    ``stem_kernel_to_s2d`` in OIHW)."""
    o, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem_kernel_to_s2d: a {tuple(w7.shape)} kernel")
    w4 = w7.new_zeros((o, 4 * c, 4, 4))
    for d, p, e, q, u, v in _s2d_taps():
        ph = (p * 2 + q) * c
        w4[:, ph:ph + c, d, e] = w7[:, :, u, v]
    return w4


def stem_kernel_from_s2d(w4: torch.Tensor) -> torch.Tensor:
    """The inverse of ``stem_kernel_to_s2d``: (O, 4C, 4, 4) -> (O, C, 7, 7);
    the round trip is exact."""
    o, c4, kh, kw = w4.shape
    if (kh, kw) != (4, 4) or c4 % 4:
        raise ValueError(f"stem_kernel_from_s2d: a {tuple(w4.shape)} kernel")
    c = c4 // 4
    w7 = w4.new_zeros((o, c, 7, 7))
    for d, p, e, q, u, v in _s2d_taps():
        ph = (p * 2 + q) * c
        w7[:, :, u, v] = w4[:, ph:ph + c, d, e]
    return w7


class SpaceToDepthStem(Conv2d):
    """The 7x7/2 stem conv as a 4x4/1 conv over 2x2 space-to-depth input,
    padded (2, 1) blocks on each axis as in the JAX package; ``weight`` is
    (O, 4C, 4, 4). Needs even canvas sides."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(4 * in_channels, out_channels, 4, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(space_to_depth(x), (2, 1, 2, 1))
        return F.conv2d(x, self.weight.to(x.dtype))


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: 1x1(stride) -> 3x3 -> 1x1, + shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 has_shortcut: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride,
                            bias=False)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                            bias=False)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_channels)
        self.has_shortcut = has_shortcut
        if has_shortcut:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride,
                                   bias=False)
            self.shortcut_bn = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = self.shortcut_bn(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(out + sc)


class ResNet(nn.Module):
    """ResNet with frozen BN returning a dict of stage features.

    Blocks are named ``res{2..5}_block{i}`` after the flax modules.
    """

    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("res3", "res4", "res5"),
                 stem_channels: int = 64, res2_out_channels: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 s2d_stem: bool = False):
        super().__init__()
        self.out_features = tuple(out_features)
        self.compute_dtype = compute_dtype
        self.stem_conv1 = (SpaceToDepthStem(3, stem_channels) if s2d_stem
                           else Conv2d(3, stem_channels, 7, 2, bias=False))
        self.stem_bn1 = FrozenBatchNorm(stem_channels)
        self.stages = []  # (stage name, its block names)
        in_channels = stem_channels
        out_channels = res2_out_channels
        bottleneck_channels = out_channels // 4
        for stage_idx, num_blocks in enumerate(RESNET_STAGES[depth]):
            name = f"res{stage_idx + 2}"
            stride = 1 if stage_idx == 0 else 2
            blocks = [f"{name}_block{b}" for b in range(num_blocks)]
            for b, block_name in enumerate(blocks):
                self.add_module(block_name, Bottleneck(
                    in_channels, out_channels, bottleneck_channels,
                    stride=stride if b == 0 else 1, has_shortcut=(b == 0)))
                in_channels = out_channels
            self.stages.append((name, blocks))
            out_channels *= 2
            bottleneck_channels *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype)
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        out: Dict[str, torch.Tensor] = {}
        for name, blocks in self.stages:
            for block_name in blocks:
                x = getattr(self, block_name)(x)
            if name in self.out_features:
                out[name] = x
        return out


def resnet_feature_channels(res2_out: int = 256) -> Dict[str, int]:
    return {f"res{i + 2}": res2_out * (2 ** i) for i in range(4)}
