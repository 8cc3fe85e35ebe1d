"""Feature Pyramid Network P3-P7 (FCOS flavor), NCHW (port of
sylph_tpu/models/fpn.py).

Top-down pathway with nearest x2 upsampling and sum fusion; P6 comes from
the P5 *output* and P7 from relu(P6) (``LastLevelP6P7(in_feature="p5")``),
or the R-CNN ``"maxpool"`` P6.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d


class FPN(nn.Module):
    """P3..P5 from res3..res5 laterals, then the top block."""

    def __init__(self, in_channels: Dict[str, int],
                 in_features: Sequence[str] = ("res3", "res4", "res5"),
                 out_channels: int = 256, top_levels: int = 2,
                 top_block: str = "p6p7",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if top_block not in ("p6p7", "maxpool"):
            raise NotImplementedError(f"FPN top block {top_block}")
        self.in_features = tuple(in_features)
        self.top_levels = top_levels
        self.top_block = top_block
        self.compute_dtype = compute_dtype
        c = out_channels
        for f in self.in_features:
            self.add_module(f"lateral_{f}", Conv2d(in_channels[f], c, 1))
            self.add_module(f"output_{f}", Conv2d(c, c, 3))
        if top_block == "p6p7":
            for i in range(top_levels):
                self.add_module(f"top_block_p{6 + i}", Conv2d(c, c, 3, 2))

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        xs = [feats[f].to(self.compute_dtype) for f in self.in_features]
        laterals = [getattr(self, f"lateral_{f}")(x)
                    for f, x in zip(self.in_features, xs)]
        merged = [laterals[-1]]
        for lat in laterals[-2::-1]:
            merged.append(lat + F.interpolate(merged[-1], scale_factor=2,
                                              mode="nearest"))
        merged = merged[::-1]  # fine -> coarse
        outs = [getattr(self, f"output_{f}")(m)
                for f, m in zip(self.in_features, merged)]

        if self.top_block == "maxpool":
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
            return outs
        top = outs[-1]
        for i in range(self.top_levels):
            if i > 0:
                top = F.relu(top)
            top = getattr(self, f"top_block_p{6 + i}")(top)
            outs.append(top)
        return outs  # [P3, P4, P5, P6, P7]
