"""FCOS towers and heads, shared over the pyramid levels.

Each tower is four [3x3 convolution with bias, GroupNorm(32, eps 1e-5),
ReLU]. The box branch gives ``bbox_pred`` (4 channels, times the level's
learned scale, then ReLU), ``ctrness`` and ``iou_overlap`` (one channel
each); the class logits come from the conditional classifier
(``conditional.py``) over the class tower. Outputs are flattened level
after level, row-major over (h, w).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from .arith import Arith
from .conditional import fcos_logits


class Dense(NamedTuple):
    logits: torch.Tensor   # (B, K, N)
    reg: torch.Tensor      # (B, K, 4), in strides (after scale and ReLU)
    ctrness: torch.Tensor  # (B, K)
    iou: torch.Tensor      # (B, K)


def flat(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def tower(sd, name: str, x: torch.Tensor, arith: Arith, convs: int = 4,
          groups: int = 32) -> torch.Tensor:
    for i in range(convs):
        x = arith.conv2d(x, sd[f"{name}.conv{i}.weight"],
                         sd[f"{name}.conv{i}.bias"], padding=1)
        x = F.group_norm(x, groups, sd[f"{name}.gn{i}.weight"].float(),
                         sd[f"{name}.gn{i}.bias"].float(), 1e-5)
        x = F.relu(x)
    return x


def fcos_head(sd, features: Sequence[torch.Tensor],
              bank: Dict[str, torch.Tensor], arith: Arith,
              convs: int = 4, prefix: str = "fcos_head.") -> Dense:
    """Pyramid maps and a code bank -> dense outputs of every level."""
    p = prefix
    logits: List[torch.Tensor] = []
    reg, ctr, iou = [], [], []
    for li, f in enumerate(features):
        ct = tower(sd, f"{p}cls_tower", f, arith, convs)
        bt = tower(sd, f"{p}bbox_tower", f, arith, convs)
        logits.append(fcos_logits(flat(ct), bank, arith))
        r = arith.conv2d(bt, sd[f"{p}bbox_pred.weight"],
                         sd[f"{p}bbox_pred.bias"], padding=1)
        r = F.relu(r * sd[f"{p}scale_l{li}.scale"].float())
        reg.append(flat(r))
        for out, name in ((ctr, "ctrness"), (iou, "iou_overlap")):
            out.append(flat(arith.conv2d(bt, sd[f"{p}{name}.weight"],
                                         sd[f"{p}{name}.bias"],
                                         padding=1))[..., 0])
    return Dense(torch.cat(logits, 1), torch.cat(reg, 1), torch.cat(ctr, 1),
                 torch.cat(iou, 1))
