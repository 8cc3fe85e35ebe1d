"""Faster R-CNN's region proposal network (detectron2's StandardRPNHead and
its test-time proposals).

Anchors: on a level of stride s, one per aspect ratio r at each cell
(y, x), centred on (x*s, y*s), of area size^2 with width sqrt(size^2 / r)
and height width * r, ordered (y, x, ratio). The head is a shared 3x3
convolution with ReLU, then 1x1 convolutions giving one objectness logit
and four deltas per anchor (channel a*4 + j for anchor a). Proposals: per
level the ``pre_nms_topk`` anchors of highest objectness (lower index
first among ties), decoded, clipped to the image, kept if wider and higher
than ``min_size``, scored by sigmoid(objectness); NMS at IoU 0.7 within
each level, and the first ``post_nms_topk`` picks over all levels.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .arith import Arith
from .boxes import decode
from .nms import multiclass_nms


def anchors(canvas: Sequence[int], strides: Sequence[int],
            sizes: Sequence[int], ratios: Sequence[float], device
            ) -> Tuple[torch.Tensor, List[int]]:
    out, counts = [], []
    for s, size in zip(strides, sizes):
        h, w = -(-canvas[0] // s), -(-canvas[1] // s)
        base = []
        for r in ratios:
            bw = math.sqrt(size * size / r)
            bh = bw * r
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = torch.tensor(base, device=device)
        ys, xs = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        c = torch.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4).float() * s
        out.append((c + base[None]).reshape(-1, 4))
        counts.append(out[-1].shape[0])
    return torch.cat(out), counts


def rpn_head(sd, features: Sequence[torch.Tensor], arith: Arith,
             prefix: str = "rpn_head."):
    """-> objectness (B, A_total), deltas (B, A_total, 4)."""
    p = prefix
    logits, deltas = [], []
    for f in features:
        t = F.relu(arith.conv2d(f, sd[f"{p}conv.weight"], sd[f"{p}conv.bias"],
                                padding=1))
        o = arith.conv2d(t, sd[f"{p}objectness.weight"],
                         sd[f"{p}objectness.bias"])
        d = arith.conv2d(t, sd[f"{p}anchor_deltas.weight"],
                         sd[f"{p}anchor_deltas.bias"])
        b = f.shape[0]
        logits.append(o.permute(0, 2, 3, 1).reshape(b, -1))
        deltas.append(d.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.cat(logits, 1), torch.cat(deltas, 1)


def proposals(logits: torch.Tensor, deltas: torch.Tensor,
              all_anchors: torch.Tensor, counts: Sequence[int], b: int,
              image_hw: Sequence[float], pre_nms_topk: int,
              post_nms_topk: int, nms_threshold: float = 0.7,
              min_size: float = 0.0) -> torch.Tensor:
    """Image ``b``'s proposals (P, 4), in pick order, P <= post_nms_topk."""
    h, w = float(image_hw[0]), float(image_hw[1])
    lim = torch.tensor([w, h, w, h], device=logits.device)
    boxes, scores, levels, start = [], [], [], 0
    for li, k in enumerate(counts):
        top = torch.sort(logits[b, start:start + k], descending=True,
                         stable=True).indices[:pre_nms_topk]
        bx = decode(all_anchors[start + top], deltas[b, start + top])
        bx = torch.minimum(bx.clamp(min=0), lim)
        ok = ((bx[:, 2] - bx[:, 0] > min_size)
              & (bx[:, 3] - bx[:, 1] > min_size))
        boxes.append(bx[ok])
        scores.append(torch.sigmoid(logits[b, start + top])[ok])
        levels.append(torch.full((int(ok.sum()),), li, device=logits.device))
        start += k
    boxes, scores, levels = (torch.cat(x) for x in (boxes, scores, levels))
    keep = multiclass_nms(boxes, scores, levels,
                          torch.ones_like(levels, dtype=torch.bool),
                          nms_threshold, post_nms_topk)
    return boxes[keep]
