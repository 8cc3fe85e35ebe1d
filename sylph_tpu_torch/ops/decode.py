"""Proposal decoding: dense head outputs -> padded Detections (port of
sylph_tpu/ops/decode.py).

  * quality multiply per BOX_QUALITY (ctrness / iou / sqrt(iou*ctr)),
    before the threshold under THRESH_WITH_CTR or OWD, after it otherwise;
  * per-level threshold, then top ``min(pre_nms_topk, K_l * N)``, ltrb
    decode x stride, ``sqrt`` score;
  * multiclass NMS on the **unclipped** boxes, then the clip;
  * OWD mode: single-channel all-ones class scores.

``TPU.APPROX_TOPK`` maps to the exact ``torch.topk``; ties are ordered
lower index first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..structures import Detections
from .nms import batched_multiclass_nms
from ..utils.spans import span

NEG_INF = -1e10


class DecodeCfg(NamedTuple):
    pre_nms_thresh: float = 0.05
    pre_nms_topk: int = 1000
    post_nms_topk: int = 100
    nms_thresh: float = 0.6
    thresh_with_ctr: bool = False
    box_quality: tuple = ("ctrness",)
    owd: bool = False


class Candidates(NamedTuple):
    """Per-image pre-NMS candidates, level-major, ``pre_nms_topk`` per level."""
    boxes: torch.Tensor      # (B, C, 4) unclipped
    scores: torch.Tensor     # (B, C) sqrt scores, 0 where invalid
    classes: torch.Tensor    # (B, C) int64
    levels: torch.Tensor     # (B, C) int32
    locations: torch.Tensor  # (B, C, 2)
    valid: torch.Tensor      # (B, C) bool


def _apply_quality(scores, ctr, iou, box_quality):
    bq = tuple(sorted(box_quality))
    if bq == ("ctrness",):
        return scores * ctr[..., None]
    if bq == ("iou",):
        return scores * iou[..., None]
    if bq == ("ctrness", "iou"):
        return scores * torch.sqrt(iou[..., None] * ctr[..., None])
    raise NotImplementedError(f"BOX_QUALITY {bq}")


def _topk_lower_index_first(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: every element above the k-th
    value, then the lowest-index elements equal to it; equal values in
    ascending index order.

    ``torch.topk`` picks freely among the elements tied at the k-th value,
    so only its elements above that value are kept. The slots of the tie
    run are refilled with the first elements equal to it, found by a
    search in the running count of the ties (no sort of the whole row).
    """
    vals, idx = torch.topk(x, k, dim=-1)
    idx, perm = torch.sort(idx, dim=-1)
    vals = vals.gather(-1, perm)
    vals, perm = torch.sort(vals, dim=-1, descending=True, stable=True)
    idx = idx.gather(-1, perm)
    kth = vals[..., -1:]
    n_above = (vals > kth).sum(dim=-1, keepdim=True)
    ties_seen = torch.cumsum(x == kth, dim=-1)
    # slot s >= n_above takes the (s - n_above + 1)-th element equal to kth
    nth = (torch.arange(1, k + 1, device=x.device) - n_above).clamp(min=1)
    first = torch.searchsorted(ties_seen, nth)
    slots = torch.arange(k, device=x.device)
    return vals, torch.where(slots < n_above, idx, first)


def _level_candidates(masked, reg, locations, strides, pre_nms_topk):
    """Top-k of one level's masked (B, K_l, N) scores -> boxes etc."""
    b, k, n = masked.shape
    topk = min(pre_nms_topk, k * n)
    top_scores, top_idx = _topk_lower_index_first(masked.reshape(b, k * n),
                                                  topk)
    loc_idx = top_idx // n
    cls_idx = top_idx % n
    valid = top_scores > NEG_INF / 2

    loc = locations[loc_idx]                     # (B, topk, 2)
    stride = strides[loc_idx][..., None]         # (B, topk, 1)
    r = reg.gather(1, loc_idx[..., None].expand(-1, -1, 4)) * stride
    boxes = torch.stack([
        loc[..., 0] - r[..., 0], loc[..., 1] - r[..., 1],
        loc[..., 0] + r[..., 2], loc[..., 1] + r[..., 3]], dim=-1)
    return (boxes, torch.where(valid, top_scores, 0.0), cls_idx, loc, valid)


def select_candidates(logits: torch.Tensor, reg_pred: torch.Tensor,
                      ctrness_pred: torch.Tensor, iou_pred: torch.Tensor,
                      locations: torch.Tensor, strides: torch.Tensor,
                      cfg: DecodeCfg, level_splits: Sequence[int],
                      class_valid: Optional[torch.Tensor] = None
                      ) -> Candidates:
    """Everything before NMS: quality, per-level threshold and top-k, ltrb
    decode, sqrt score."""
    b, k, n = logits.shape
    dev = logits.device
    if class_valid is None:
        class_valid = torch.ones((n,), dtype=torch.bool, device=dev)

    if cfg.owd:
        scores = torch.ones((b, k, 1), dtype=torch.float32, device=dev)
        class_valid = torch.ones((1,), dtype=torch.bool, device=dev)
    else:
        scores = torch.sigmoid(logits.float())
    ctr = torch.sigmoid(ctrness_pred.float())
    iou = torch.sigmoid(iou_pred.float())

    if cfg.thresh_with_ctr or cfg.owd:
        scores = _apply_quality(scores, ctr, iou, cfg.box_quality)
        pre_scores = scores
    else:
        pre_scores = scores
        scores = _apply_quality(scores, ctr, iou, cfg.box_quality)

    outs = []
    start = 0
    for li, count in enumerate(level_splits):
        sl = slice(start, start + count)
        # Candidates are defined on pre_scores; ranking uses final scores.
        cand = (pre_scores[:, sl] > cfg.pre_nms_thresh) & class_valid
        masked = torch.where(cand, scores[:, sl], NEG_INF)
        bxs, scs, cls_, locs, val = _level_candidates(
            masked, reg_pred[:, sl], locations[sl], strides[sl],
            cfg.pre_nms_topk)
        lvl = torch.full(cls_.shape, li, dtype=torch.int32, device=dev)
        outs.append((bxs, scs, cls_, lvl, locs, val))
        start += count
    boxes, scores_c, classes, levels, locs, valid = (
        torch.cat(parts, dim=1) for parts in zip(*outs))
    # sqrt score (reference fcos_outputs.py:1001)
    return Candidates(boxes, torch.sqrt(torch.clamp(scores_c, min=0.0)),
                      classes, levels, locs, valid)


def decode_proposals(logits: torch.Tensor, reg_pred: torch.Tensor,
                     ctrness_pred: torch.Tensor, iou_pred: torch.Tensor,
                     locations: torch.Tensor, strides: torch.Tensor,
                     image_sizes: torch.Tensor, cfg: DecodeCfg,
                     level_splits: Sequence[int],
                     class_valid: Optional[torch.Tensor] = None,
                     nms_impl: Optional[str] = None) -> Detections:
    """Dense (B, K, ...) head outputs -> (B, post_nms_topk) Detections.

    image_sizes: (B, 2) (h, w) content size on the canvas, for the clip.
    nms_impl: passed to ``batched_multiclass_nms`` (None = by device).
    """
    with span("decode"):
        cand = select_candidates(logits, reg_pred, ctrness_pred, iou_pred,
                                 locations, strides, cfg, level_splits,
                                 class_valid)
        # NMS runs on unclipped boxes, as in the reference.
        nboxes, nscores, nclasses, nvalid, keep_idx = batched_multiclass_nms(
            cand.boxes, cand.scores, cand.classes, cand.valid, cfg.nms_thresh,
            cfg.post_nms_topk, impl=nms_impl)
        hw = image_sizes.float()
        wh = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)
        nboxes = torch.minimum(torch.clamp(nboxes, min=0.0), wh[:, None, :])
        keep = keep_idx.long()
        return Detections(
            boxes=nboxes, scores=nscores, classes=nclasses.to(torch.int32),
            valid=nvalid,
            locations=cand.locations.gather(
                1, keep[..., None].expand(-1, -1, 2)),
            fpn_levels=cand.levels.gather(1, keep),
        )
