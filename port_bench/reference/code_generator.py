"""Sylph's code generator up to the raw code rows registration returns.

Each support image's one box is pooled by ROIAlign (7 x 7, ``roi_align.py``)
from the pyramid levels the generator reads; two tower layers [3x3
convolution with bias, GroupNorm(32), ReLU]; the ``cls_conv_head`` (3x3 to
the code width) and ``cls_bias_head`` (3x3 to one channel) with no norm or
activation, each averaged over the 7 x 7 bins; the shots of a class are
averaged into its code row and bias.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .arith import Arith
from .roi_align import multilevel_roi_align


def class_codes(sd, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                strides: Sequence[int], shots: int, arith: Arith,
                tower_layers: int = 2, prefix: str = "code_generator."
                ) -> Dict[str, torch.Tensor]:
    """Maps of S support images, their boxes (S, 4) -> raw codes
    {cls_conv (S/shots, W), cls_bias (S/shots,)}."""
    p = prefix
    x = torch.cat([multilevel_roi_align(features, i, boxes[i:i + 1], strides)
                   for i in range(boxes.shape[0])])
    for i in range(tower_layers):
        x = arith.conv2d(x, sd[f"{p}tower_conv{i}.weight"],
                         sd[f"{p}tower_conv{i}.bias"], padding=1)
        gn = f"{p}tower_conv{i}_gn"
        x = F.relu(F.group_norm(x, 32, sd[f"{gn}.weight"].float(),
                                sd[f"{gn}.bias"].float(), 1e-5))

    def head(name):
        y = arith.conv2d(x, sd[f"{p}{name}.weight"], sd[f"{p}{name}.bias"],
                         padding=1)
        y = y.mean(dim=(2, 3))
        return y.reshape(-1, shots, y.shape[-1]).mean(1)
    return {"cls_conv": head("cls_conv_head"),
            "cls_bias": head("cls_bias_head").reshape(-1)}
