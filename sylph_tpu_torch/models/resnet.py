"""Caffe-style ResNet backbone with frozen BN, NCHW (port of
sylph_tpu/models/resnet.py).

  * caffe bottlenecks: the spatial stride sits in the 1x1 ``conv1``;
  * FrozenBatchNorm: y = x * scale + bias with (scale, bias) as buffers;
  * stem: 7x7/2 conv + frozen BN + relu + 3x3/2 max pool (pads with -inf);
  * symmetric torch padding k // 2 on every conv.

The JAX package's space-to-depth stem is a TPU workaround and is not ported.
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
        if s2d_stem:
            raise NotImplementedError(
                "the space-to-depth stem is a TPU workaround; the port runs "
                "the 7x7/2 stem (set TPU.S2D_STEM false)")
        self.out_features = tuple(out_features)
        self.compute_dtype = compute_dtype
        self.stem_conv1 = Conv2d(3, stem_channels, 7, 2, bias=False)
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
