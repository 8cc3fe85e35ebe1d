"""Sylph's conditional classifier: class logits from a bank of class codes.

FCOS: the class tower's features at each location times each code row,
plus the row's bias. Faster R-CNN: the box head's features times each code
row plus its bias, and one learned background column (``bg_weight``,
``bg_bias``) appended last.
"""

from __future__ import annotations

from typing import Dict

import torch

from .arith import Arith


def fcos_logits(features: torch.Tensor, bank: Dict[str, torch.Tensor],
                arith: Arith) -> torch.Tensor:
    """(B, K, C) features, bank rows (N, C) -> (B, K, N) logits."""
    w = bank["cls_conv"].reshape(bank["cls_conv"].shape[0], -1).float()
    return arith.matmul(features, w.t()) + bank["cls_bias"].reshape(-1).float()


def rcnn_logits(features: torch.Tensor, bank: Dict[str, torch.Tensor],
                bg_weight: torch.Tensor, bg_bias: torch.Tensor,
                arith: Arith) -> torch.Tensor:
    """(P, D) features -> (P, N + 1) logits, background last."""
    w = bank["cls_conv"].reshape(bank["cls_conv"].shape[0], -1).float()
    cond = arith.matmul(features, w.t()) + bank["cls_bias"].reshape(-1).float()
    bg = arith.matmul(features, bg_weight.float()[:, None]) + bg_bias.float()
    return torch.cat([cond, bg], dim=-1)
