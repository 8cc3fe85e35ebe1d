"""The least time an NMS launch could take on the card, from its inputs.

Bytes: each input read once (four box planes, the scores and the flags,
4 bytes each a candidate) and each output written once (an index and a flag
a pick). Operations: the IoU tests the greedy walk of this input needs
(each candidate the walk reaches, in (score desc, index asc) order,
against each kept candidate ranked before it; 14 operations a test) and
K log2 K compares to order the candidates. The bound is the larger of
bytes over the memory rate and operations over the float32 rate.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

OPS_PER_IOU_TEST = 14  # 2 max, 2 min, 3 sub, 2 clamp, mul, add, max, div, cmp


def walk_tests(scores: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
               ok: torch.Tensor) -> torch.Tensor:
    """IoU tests of the walk over (B, K) candidates that picked ``idx``
    where ``ok`` (B, M) (flags bool or 0/1 integers, as ``nms_cuda`` takes
    and gives them), as a 0-dim tensor on the inputs' device: no value
    is read back to the host, so it can be counted as the launch returns."""
    b, k = scores.shape
    s = torch.where(valid.bool(), scores.float() + 0.0,
                    torch.full_like(scores, -1e10, dtype=torch.float32))
    alive = (s > -5e9).sum(1)
    order = torch.sort(-s, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(k, device=order.device)
                  .expand(b, k).contiguous())
    picked = ok.bool()
    kept = rank.gather(1, idx.long().clamp(0, k - 1))
    last = torch.where(picked, kept, torch.full_like(kept, -1)).amax(1)
    reached = torch.where(picked.sum(1) == idx.shape[1], last + 1, alive)
    return torch.where(picked, reached[:, None] - 1 - kept,
                       torch.zeros_like(kept)).sum()


def bound_ms(b: int, k: int, m: int, tests: int) -> Tuple[float, str]:
    """The bound of a launch over (B, K) candidates with M outputs a row
    whose walk makes ``tests`` IoU tests: (ms, "bytes" or "operations",
    whichever sets it)."""
    nbytes = b * k * (4 * 4 + 4 + 4) + b * m * (4 + 4)
    ops = tests * OPS_PER_IOU_TEST + b * k * math.ceil(math.log2(max(k, 2)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nms_bound_ms(scores: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
                 ok: torch.Tensor) -> Tuple[float, str]:
    """-> (the bound in ms, "bytes" or "operations", whichever sets it)."""
    (b, k), m = scores.shape, idx.shape[1]
    return bound_ms(b, k, m, int(walk_tests(scores, valid, idx, ok)))
