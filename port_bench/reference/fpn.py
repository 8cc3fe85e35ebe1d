"""Feature pyramid, both variants the configurations use.

Laterals are 1x1 convolutions and outputs 3x3 ones, both with bias; the
top-down path adds the coarser merged map upsampled x2 by nearest
neighbour. FCOS (``top="p6p7"``): P6 is a 3x3/2 convolution of the P5
output and P7 one of ReLU(P6). Faster R-CNN (``top="maxpool"``): P6 is
the P5 output subsampled by 2 (a 1x1 max pool of stride 2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .arith import Arith


def fpn(sd, feats: Dict[str, torch.Tensor], arith: Arith,
        in_features: Sequence[str], top: str = "p6p7", top_levels: int = 2,
        prefix: str = "fpn.") -> List[torch.Tensor]:
    """Stage features -> pyramid maps, finest first."""
    p = prefix
    lat = [arith.conv2d(feats[f], sd[f"{p}lateral_{f}.weight"],
                        sd[f"{p}lateral_{f}.bias"]) for f in in_features]
    merged = [lat[-1]]
    for lateral in lat[-2::-1]:
        merged.insert(0, lateral + F.interpolate(merged[0], scale_factor=2,
                                                 mode="nearest"))
    outs = [arith.conv2d(m, sd[f"{p}output_{f}.weight"],
                         sd[f"{p}output_{f}.bias"], padding=1)
            for f, m in zip(in_features, merged)]
    if top == "maxpool":
        return outs + [outs[-1][:, :, ::2, ::2]]
    x = outs[-1]
    for i in range(top_levels):
        if i:
            x = F.relu(x)
        x = arith.conv2d(x, sd[f"{p}top_block_p{6 + i}.weight"],
                         sd[f"{p}top_block_p{6 + i}.bias"], stride=2,
                         padding=1)
        outs.append(x)
    return outs
