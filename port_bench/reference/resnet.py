"""ResNet with frozen batch norm (detectron2's caffe-style R-50), NCHW.

The stem is a 7x7/2 convolution without bias, frozen BN, ReLU and a 3x3/2
max pool padded by one; each bottleneck puts its stride on the first 1x1
convolution, pads its 3x3 by one, and adds a 1x1 projection shortcut in its
stage's first block. Frozen BN is ``x * scale + bias`` per channel.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .arith import Arith

BLOCKS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def frozen_bn(sd: Dict[str, torch.Tensor], name: str,
              x: torch.Tensor) -> torch.Tensor:
    scale = sd[f"{name}.scale"].float()[None, :, None, None]
    return x * scale + sd[f"{name}.bias"].float()[None, :, None, None]


def bottleneck(sd, name: str, x, stride: int, shortcut: bool,
               arith: Arith) -> torch.Tensor:
    out = F.relu(frozen_bn(sd, f"{name}.bn1", arith.conv2d(
        x, sd[f"{name}.conv1.weight"], stride=stride)))
    out = F.relu(frozen_bn(sd, f"{name}.bn2", arith.conv2d(
        out, sd[f"{name}.conv2.weight"], padding=1)))
    out = frozen_bn(sd, f"{name}.bn3", arith.conv2d(
        out, sd[f"{name}.conv3.weight"]))
    if shortcut:
        x = frozen_bn(sd, f"{name}.shortcut_bn", arith.conv2d(
            x, sd[f"{name}.shortcut.weight"], stride=stride))
    return F.relu(out + x)


def resnet(sd, x: torch.Tensor, arith: Arith, depth: int = 50,
           out_features: Sequence[str] = ("res3", "res4", "res5"),
           prefix: str = "backbone.") -> Dict[str, torch.Tensor]:
    """(B, 3, H, W) normalized float32 -> {stage name: features}."""
    p = prefix
    x = F.relu(frozen_bn(sd, f"{p}stem_bn1", arith.conv2d(
        x, sd[f"{p}stem_conv1.weight"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    out = {}
    for si, n_blocks in enumerate(BLOCKS[depth]):
        stage = f"res{si + 2}"
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = bottleneck(sd, f"{p}{stage}_block{bi}", x, stride, bi == 0,
                           arith)
        if stage in out_features:
            out[stage] = x
    return out
