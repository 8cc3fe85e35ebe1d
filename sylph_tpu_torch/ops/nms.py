"""Batched multiclass greedy NMS (port of sylph_tpu/ops/nms.py).

Greedy NMS followed by a top-``max_outputs`` cap is exactly the first
``max_outputs`` greedy picks, so the selection runs ``max_outputs``
select-and-suppress steps rather than a K x K IoU matrix. Multiclass
behaviour comes from the class-offset trick (boxes of different classes
never overlap).

Dispatch follows the tensors' device: CUDA tensors go to the hand-written
kernel (``ops/nms_kernel.py``, ``csrc/nms.cu``), CPU tensors to the plain
PyTorch twin ``nms_select_reference``. ``impl="reference"`` names the twin
explicitly, for comparisons on the card. ``nms_select_ranked_reference``
renders the kernel's own algorithm (rank once, by either of its routes, then
scan in chunks) in plain PyTorch for the CPU tests; no path runs it.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from . import nms_kernel

NEG_INF = -1e10
CHUNK = 64  # candidates per chunk of the kernel's ranked scan
ROUTES = ("count", "radix")


def nms_select_reference(boxes: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor, iou_threshold: float,
                         max_outputs: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch greedy NMS, batched over B (twin of ``nms_select``
    and of the NMS kernel).

    Args:
      boxes: (B, K, 4) XYXY (already class-offset for multiclass use).
      scores: (B, K); invalid entries may hold any value.
      valid: (B, K) bool.

    Returns:
      (idx, ok): (B, max_outputs) int32 indices (0 where not ok) and bool.
    """
    b, k = scores.shape
    dev = scores.device
    alive = torch.where(valid, scores.float(), NEG_INF)
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0))
    iota = torch.arange(k, device=dev)
    idx = torch.zeros((b, max_outputs), dtype=torch.int32, device=dev)
    ok = torch.zeros((b, max_outputs), dtype=torch.bool, device=dev)
    for t in range(max_outputs):
        i = torch.argmax(alive, dim=1, keepdim=True)  # first max on ties
        ok_t = alive.gather(1, i) > NEG_INF / 2        # (B, 1)
        if not bool(ok_t.any()):
            break  # nothing alive anywhere: the remaining slots stay 0
        pick = lambda v: v.gather(1, i)  # noqa: E731
        iw = torch.clamp(torch.minimum(x2, pick(x2))
                         - torch.maximum(x1, pick(x1)), min=0.0)
        ih = torch.clamp(torch.minimum(y2, pick(y2))
                         - torch.maximum(y1, pick(y1)), min=0.0)
        inter = iw * ih
        union = torch.clamp(area + pick(area) - inter, min=1e-9)
        suppress = (inter / union > iou_threshold) | (iota[None] == i)
        alive = torch.where(ok_t & suppress, NEG_INF, alive)
        idx[:, t] = torch.where(ok_t[:, 0], i[:, 0], 0).to(torch.int32)
        ok[:, t] = ok_t[:, 0]
    return idx, ok


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., 5) rows (x1, y1, x2, y2, area) in the twin's order of
    operations; symmetric bit for bit in its two arguments."""
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    return inter / torch.clamp(a[..., 4] + b[..., 4] - inter, min=1e-9)


def order_keys(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit ``order_key`` per candidate, as int64: the score's
    bits made monotone (a larger key is a higher score, -0.0 taken as +0.0),
    0 for a dead candidate."""
    s = scores.float() + 0.0                                # -0.0 -> +0.0
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(valid & (s > NEG_INF / 2), key, 0)


def rank_count_reference(keys: torch.Tensor) -> torch.Tensor:
    """The counting route's ranked list for one image's (K,) keys: the
    alive candidates in (key descending, index ascending) order."""
    n_alive = int((keys != 0).sum())
    return torch.sort(-keys, stable=True).indices[:n_alive]


def rank_radix_reference(keys: torch.Tensor, tile: int = 2048
                         ) -> torch.Tensor:
    """The radix route's ranked list for one image's (K,) keys, pass by
    pass as the kernels build it (csrc/nms.cu, ``radix_*_kernel``): pass 0
    drops the dead candidates, keeping index order, and complements the
    keys; each of four passes counts 8-bit digits per tile of ``tile``
    members, scans the counts in (digit, tile) order, and moves each member
    to its tile's first slot for its digit plus the members of that digit
    before it in the tile."""
    vals = torch.nonzero(keys).flatten()            # compaction, index order
    ck = 0xFFFFFFFF - keys[vals]                    # ascending = descending
    n = vals.numel()
    tiles = -(-n // tile)
    for shift in (0, 8, 16, 24) if n else ():
        digit = (ck >> shift) & 0xFF
        hist = torch.zeros((256, tiles), dtype=torch.int64)
        within = torch.empty(n, dtype=torch.int64)
        for t in range(tiles):
            d = digit[t * tile:(t + 1) * tile]
            onehot = torch.nn.functional.one_hot(d, 256)
            hist[:, t] = onehot.sum(0)
            within[t * tile:(t + 1) * tile] = (
                onehot.cumsum(0).gather(1, d[:, None])[:, 0] - 1)
        first = (torch.cumsum(hist.flatten(), 0) - hist.flatten()).view(
            256, tiles)
        tile_of = torch.arange(n) // tile
        pos = first[digit, tile_of] + within
        out_k, out_v = torch.empty_like(ck), torch.empty_like(vals)
        out_k[pos], out_v[pos] = ck, vals
        ck, vals = out_k, out_v
    return vals


def nms_select_ranked_reference(boxes: torch.Tensor, scores: torch.Tensor,
                                valid: torch.Tensor, iou_threshold: float,
                                max_outputs: int, route: str = "count",
                                tile: int = 2048
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch rendering of the kernel's algorithm (csrc/nms.cu);
    same arguments and results as ``nms_select_reference``.

    Greedy picks with a top-``max_outputs`` cap are the walk, in the order
    (score descending, index ascending), over the alive candidates that
    keeps a candidate when no kept one has IoU > threshold with it. So:

      1. rank the alive candidates by that order (-0.0 counts as +0.0), by
         ``route``: ``"count"`` (``rank_count_reference``) or ``"radix"``
         (``rank_radix_reference`` over tiles of ``tile``), which give
         the same list;
      2. take the ranked list in chunks of ``CHUNK``; per chunk, mark the
         members that some earlier kept candidate suppresses, and build
         the intra-chunk bitmask ``m[i]`` = the later members that member
         i suppresses;
      3. resolve the chunk serially on bits: take the lowest unmarked
         member, keep it, clear the bits of ``m[i]``; stop at
         ``max_outputs`` kept, possibly mid-chunk.

    It runs on no path; the CPU tests hold it against the references.
    """
    if route not in ROUTES:
        raise ValueError(f"unknown ranking route {route!r}")
    rank = (rank_count_reference if route == "count"
            else partial(rank_radix_reference, tile=tile))
    b, k = scores.shape
    keys = order_keys(scores.cpu(), valid.cpu())
    x1, y1, x2, y2 = boxes.float().cpu().unbind(-1)
    area = (torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0))
    rows = torch.stack([x1, y1, x2, y2, area], dim=-1)       # (B, K, 5)
    idx = torch.zeros((b, max_outputs), dtype=torch.int32)
    ok = torch.zeros((b, max_outputs), dtype=torch.bool)
    for r in range(b):
        order = rank(keys[r])
        n_alive = order.numel()
        ranked = rows[r, order]
        kept = []                       # ranks of the kept candidates
        for c0 in range(0, n_alive, CHUNK):
            if len(kept) == max_outputs:
                break
            box = ranked[c0:c0 + CHUNK]
            n = box.shape[0]
            marked = _iou(box[:, None], ranked[kept][None]) > iou_threshold
            pending = sum(1 << i for i in range(n)
                          if not bool(marked[i].any()))
            over = _iou(box[:, None], box[None]) > iou_threshold
            m = [sum(1 << j for j in range(i + 1, n) if bool(over[i, j]))
                 for i in range(n)]
            while pending and len(kept) < max_outputs:
                i = (pending & -pending).bit_length() - 1  # lowest set bit
                kept.append(c0 + i)
                pending &= ~m[i] & ~(1 << i)
        idx[r, :len(kept)] = order[kept].to(torch.int32)
        ok[r, :len(kept)] = True
    return idx.to(scores.device), ok.to(scores.device)


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Translate each class into a disjoint region; the extent is taken
    over valid boxes only."""
    max_coord = torch.amax(torch.where(valid[..., None], boxes, 0.0),
                           dim=(1, 2), keepdim=True) + 1.0
    return boxes + classes.to(boxes.dtype)[..., None] * max_coord


def batched_multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                           classes: torch.Tensor, valid: torch.Tensor,
                           iou_threshold: float, max_outputs: int,
                           impl: Optional[str] = None):
    """Multiclass NMS for a batch with a static output size.

    Args:
      boxes: (B, K, 4) float32, scores: (B, K), classes: (B, K) int,
      valid: (B, K) bool.
      impl: None dispatches by device (CUDA -> kernel, CPU -> twin);
        "reference" runs the twin on any device.

    Returns:
      (boxes, scores, classes, valid, gather_idx), each (B, max_outputs,
      ...): the top ``max_outputs`` greedy picks by score; ``gather_idx``
      indexes the input candidate axis.
    """
    if impl not in (None, "reference"):
        raise ValueError(f"unknown NMS impl {impl!r}")
    shifted = class_offset_boxes(boxes, classes, valid)
    if impl == "reference" or not boxes.is_cuda:
        idx, ok = nms_select_reference(shifted, scores, valid, iou_threshold,
                                       max_outputs)
    else:
        planes = shifted.float().permute(2, 0, 1).contiguous()
        idx, ok = nms_kernel.nms_cuda(
            planes[0], planes[1], planes[2], planes[3],
            scores.float().contiguous(), valid.to(torch.int32).contiguous(),
            iou_threshold, max_outputs)
        ok = ok.bool()

    gidx = idx.long()
    out_boxes = boxes.gather(1, gidx[..., None].expand(-1, -1, 4))
    out_scores = torch.where(ok, scores.gather(1, gidx), 0.0)
    return out_boxes, out_scores, classes.gather(1, gidx), ok, idx
