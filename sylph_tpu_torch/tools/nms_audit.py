"""Hold every launch of the NMS kernel in a run against its plain twin, and
time the kernel at the shapes the run gave it.

    audit = NMSAudit().install()
    ...                      # anything that launches ops/nms_kernel.nms_cuda
    audit.flush("train")     # each pending launch against the twin
    rows = audit.time_shapes()   # launches of its own, counted as any
    audit.uninstall()

``install`` wraps ``nms_kernel.nms_cuda``: each launch runs the kernel as
before (and adds to its counts), and its inputs and outputs are kept on the
card. ``flush(label)`` replays each kept launch through the twin
(``ops/nms.py::nms_select_reference``) on the same tensors and raises unless
the indices and flags are identical; it counts the launches under
``label``. The check runs after the fact, so the timed steps do not carry
the twin. ``time_shapes`` times the kernel on the first input of each
(B, K, M, IoU) shape, from CUDA-graph replays, beside its bound and the
twin's time. Its launches add to ``nms_kernel``'s counts like any other:
a caller that counts a run's launches reads the counts before timing.

The bound is the least time the card could take for the same work: the
bytes moved (each input read once, each output written once) over the
memory rate, or the IoU tests the greedy walk of this input needs and the
K log2 K compares that order it, over the FP32 rate, whichever is larger.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops import nms_kernel
from ..ops.nms import nms_select_reference

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# One IoU test: 2 max, 2 min, 3 sub, 2 clamp, 1 mul, 1 add, 1 max, 1 div,
# 1 compare.
NMS_OPS_PER_IOU_TEST = 14


def time_ms(fn, reps: int, warmup: int = 2, rounds: int = 5,
            graph: bool = False) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls of ``fn`` between two CUDA events. Without ``graph`` the calls
    are issued from the host, so a call that is shorter on the card than
    on the host measures the host. With ``graph`` the ``reps`` calls are
    captured once in a CUDA graph that is replayed between the events:
    the kernels' time on the card, back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            run()
        run = g.replay
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def walk_tests(scores, valid, idx, ok) -> int:
    """IoU tests the walk in (score desc, index asc) order needs: each
    candidate it reaches against each kept one ranked before it."""
    tests = 0
    for r in range(scores.shape[0]):
        s = torch.where(valid[r], scores[r] + 0.0, -1e10)
        n = int((s > -5e9).sum())
        order = torch.sort(-s, stable=True).indices[:n]
        rank = torch.full_like(s, -1, dtype=torch.long)
        rank[order] = torch.arange(n, device=order.device)
        kept = rank[idx[r][ok[r]].long()]
        if kept.numel() == 0:  # nothing alive in this image
            continue
        reached = int(kept.max()) + 1 if int(ok[r].sum()) == idx.shape[1] \
            else n
        tests += int((reached - 1 - kept).sum())
    return tests


def nms_bound_ms(scores, valid, idx, ok):
    """Least time for the work this input needs: each input read once,
    each output written once; the IoU tests of the walk, and
    K log2 K compares to order the candidates."""
    (b, k), m = scores.shape, idx.shape[1]
    nbytes = b * k * (4 * 4 + 4 + 4) + b * m * (4 + 4)
    ops = (walk_tests(scores, valid, idx, ok) * NMS_OPS_PER_IOU_TEST
           + b * k * int(np.ceil(np.log2(max(k, 2)))))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class NMSAudit:
    """Every ``nms_kernel.nms_cuda`` launch while installed, held against
    the twin at each ``flush``; launches counted by label and by shape."""

    def __init__(self):
        self.pending: List[tuple] = []
        self.by_label: Dict[str, int] = {}
        self.shapes: Dict[tuple, dict] = {}
        self._orig = None

    def install(self) -> "NMSAudit":
        self._orig = nms_kernel.nms_cuda
        orig = self._orig

        def audited(x1, y1, x2, y2, scores, valid, iou_threshold,
                    max_outputs):
            idx, ok = orig(x1, y1, x2, y2, scores, valid, iou_threshold,
                           max_outputs)
            planes = tuple(t.clone() for t in (x1, y1, x2, y2, scores,
                                               valid))
            self.pending.append((planes, float(iou_threshold),
                                 int(max_outputs), idx.clone(), ok.clone()))
            return idx, ok

        nms_kernel.nms_cuda = audited
        return self

    def uninstall(self) -> None:
        if self._orig is not None:
            nms_kernel.nms_cuda = self._orig
            self._orig = None

    def flush(self, label: str) -> int:
        """Hold each launch since the last flush against the twin on the
        same tensors; -> how many there were. Raises on any difference."""
        n = len(self.pending)
        for i, (planes, iou, m, idx, ok) in enumerate(self.pending):
            x1, y1, x2, y2, scores, valid = planes
            boxes = torch.stack([x1, y1, x2, y2], -1)
            w_idx, w_ok = nms_select_reference(boxes, scores, valid.bool(),
                                               iou, m)
            if not (torch.equal(idx.long(), w_idx.long())
                    and torch.equal(ok.bool(), w_ok)):
                raise AssertionError(
                    f"NMS kernel != twin: {label}, launch {i} of {n} "
                    f"(B={scores.shape[0]}, K={scores.shape[1]}, M={m})")
            key = (*scores.shape, m, iou)
            row = self.shapes.setdefault(key, {"launches": 0})
            row["launches"] += 1
            row.setdefault("labels", {}).setdefault(label, 0)
            row["labels"][label] += 1
            if "sample" not in row:
                row["sample"] = (planes, iou, m, idx, ok)
        self.pending = []
        self.by_label[label] = self.by_label.get(label, 0) + n
        return n

    def time_shapes(self, reps: int = 20) -> List[dict]:
        """Per shape: launches by label, the kernel's ms (CUDA graph of
        ``reps`` calls), its bound, the twin's ms."""
        kernel = self._orig or nms_kernel.nms_cuda
        rows = []
        for (b, k, m, iou), row in sorted(self.shapes.items()):
            planes, _, _, idx, ok = row["sample"]
            x1, y1, x2, y2, scores, valid = planes
            ms = time_ms(lambda: kernel(*planes, iou, m), reps, graph=True)
            boxes = torch.stack([x1, y1, x2, y2], -1)
            twin_ms = time_ms(lambda: nms_select_reference(
                boxes, scores, valid.bool(), iou, m), 3, warmup=1, rounds=3)
            bound, by = nms_bound_ms(scores, valid.bool(), idx, ok.bool())
            rows.append(dict(b=b, k=k, m=m, iou=iou,
                             route=nms_kernel.select_route(b, k, m),
                             launches=row["launches"],
                             launches_by_label=dict(row["labels"]),
                             kernel_ms=ms, bound_ms=bound, bound_by=by,
                             twin_ms=twin_ms))
        return rows
