"""FCOS decoding: dense outputs -> at most ``detections`` boxes an image.

For each level, the (location, class) pairs whose class probability
sigmoid(logit) exceeds the threshold are ranked by sigmoid(logit) *
sigmoid(ctrness), and the first ``pre_nms_topk`` (the lower flat index
first among equal scores, the index running over locations then classes)
become candidates: the box is the location minus and plus the regressed
(left, top, right, bottom) distances times the level's stride, the score
the square root of the ranking score. Greedy multi-class NMS runs on the
unclipped boxes, then the kept boxes are clipped to the image.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from .fcos_head import Dense
from .nms import multiclass_nms


class Grid(NamedTuple):
    """Location centres (K, 2) as (x, y), their strides (K,), and each
    level's (H, W)."""
    locations: torch.Tensor
    strides: torch.Tensor
    sizes: List[Tuple[int, int]]


def location_grid(canvas: Sequence[int], strides: Sequence[int],
                  device) -> Grid:
    """Centre of cell (y, x) on a level of stride s:
    (x*s + s//2, y*s + s//2)."""
    locs, st, sizes = [], [], []
    for s in strides:
        h, w = -(-canvas[0] // s), -(-canvas[1] // s)
        ys, xs = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        locs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
                    * s + s // 2)
        st.append(torch.full((h * w,), float(s), device=device))
        sizes.append((h, w))
    return Grid(torch.cat(locs), torch.cat(st), sizes)


class Candidates(NamedTuple):
    boxes: torch.Tensor    # (C, 4) unclipped
    scores: torch.Tensor   # (C,) square-rooted
    classes: torch.Tensor  # (C,)
    levels: torch.Tensor   # (C,)
    index: torch.Tensor    # (C,) flat location index over all levels


def boxes_at(dense: Dense, b: int, grid: Grid, index: torch.Tensor
             ) -> torch.Tensor:
    """The unclipped boxes of image ``b`` at flat location ``index``."""
    loc = grid.locations[index]
    r = dense.reg[b, index] * grid.strides[index, None]
    return torch.stack([loc[:, 0] - r[:, 0], loc[:, 1] - r[:, 1],
                        loc[:, 0] + r[:, 2], loc[:, 1] + r[:, 3]], -1)


def scores_at(dense: Dense, b: int, index: torch.Tensor,
              classes: torch.Tensor) -> torch.Tensor:
    """The square-rooted score of image ``b`` at (location, class) pairs."""
    p = torch.sigmoid(dense.logits[b, index, classes])
    return torch.sqrt(p * torch.sigmoid(dense.ctrness[b, index]))


def candidates(dense: Dense, b: int, grid: Grid, threshold: float,
               pre_nms_topk: int) -> Candidates:
    n = dense.logits.shape[-1]
    parts, start = [], 0
    for li, (h, w) in enumerate(grid.sizes):
        k = h * w
        prob = torch.sigmoid(dense.logits[b, start:start + k])       # (k, N)
        rank = prob * torch.sigmoid(dense.ctrness[b, start:start + k, None])
        rank = torch.where(prob > threshold, rank,
                           torch.full_like(rank, float("-inf"))).reshape(-1)
        order = torch.sort(rank, descending=True, stable=True).indices
        order = order[:pre_nms_topk]
        order = order[rank[order] > float("-inf")]
        index = start + order // n
        classes = order % n
        parts.append((boxes_at(dense, b, grid, index),
                      torch.sqrt(rank[order]), classes,
                      torch.full_like(classes, li), index))
        start += k
    return Candidates(*(torch.cat(p) for p in zip(*parts)))


def clip(boxes: torch.Tensor, size_hw: Sequence[float]) -> torch.Tensor:
    h, w = float(size_hw[0]), float(size_hw[1])
    lim = torch.tensor([w, h, w, h], device=boxes.device)
    return torch.minimum(boxes.clamp(min=0), lim)


def detect(dense: Dense, b: int, grid: Grid, image_hw: Sequence[float],
           threshold: float, pre_nms_topk: int, nms_threshold: float,
           detections: int):
    """-> (candidates, kept indices into them, clipped kept boxes)."""
    cand = candidates(dense, b, grid, threshold, pre_nms_topk)
    keep = multiclass_nms(cand.boxes, cand.scores, cand.classes,
                          torch.ones_like(cand.classes, dtype=torch.bool),
                          nms_threshold, detections)
    return cand, keep, clip(cand.boxes[keep], image_hw)
