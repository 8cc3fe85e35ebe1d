"""COCO-protocol detection evaluation in numpy (the port's own copy of
sylph_tpu/evaluation/coco_eval_np.py).

Self-contained replacement for pycocotools ``COCOeval`` (bbox) — the C
extension is a host-side dependency the reference consumes
(meta_learn_evaluation.py:28, coco_evaluation.py:19) but is not
available here, so the full protocol is implemented from the spec:

  * IoU thresholds 0.50:0.05:0.95, greedy score-ordered matching per
    (image, category), crowd GTs are ignore-regions matched with
    intersection-over-det-area;
  * area ranges all/small/medium/large on GT area;
  * detections matched to ignored GTs (or unmatched with out-of-range
    area) are dropped from the PR accumulation;
  * precision interpolated (monotone non-increasing) and sampled at 101
    recall points; AP averaged over classes with GT present;
  * AR at maxDets 1/10/100.

The greedy matching loop runs in the native matcher
(``csrc/coco_matcher.cpp`` through ``_native.py``); its plain numpy twin
``match_greedy_reference`` runs only where a caller names
``impl="reference"``.

Inputs use original-image coordinates, XYWH boxes (COCO convention).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ._native import match_greedy

IOU_THRS = np.round(np.arange(0.5, 0.955, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


@dataclasses.dataclass
class DetEvalInputs:
    """Ground truth + detections, COCO-format dicts.

    gts:  [{image_id, category_id, bbox XYWH, area?, iscrowd?, ignore?}]
    dets: [{image_id, category_id, bbox XYWH, score}]
    image_ids: evaluated image set (images without GT still count).
    category_ids: categories to evaluate.
    nonexhaustive: optional set of (image_id, category_id) pairs where
      the category is NOT exhaustively annotated (LVIS
      ``not_exhaustive_category_ids``): unmatched detections on such
      pairs are IGNORED rather than counted as false positives — the
      lvis-package protocol the reference consumes
      (sylph/evaluation/lvis_evaluation.py:246-251).
    """

    gts: List[dict]
    dets: List[dict]
    image_ids: Sequence[int]
    category_ids: Sequence[int]
    nonexhaustive: Optional[set] = None


def _iou_xywh(dets: np.ndarray, gts: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools-style IoU: crowd GT uses intersection/det_area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(0)
    iy = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(0)
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_greedy_reference(ious: np.ndarray, g_ignore: np.ndarray,
                           g_crowd: np.ndarray, iou_thrs: np.ndarray):
    """Plain numpy twin of the native matcher (``_native.match_greedy``):
    per IoU threshold, detections in score order greedily take the best
    still-available GT (crowd GTs can be matched repeatedly); once a real
    match exists, ignored GTs no longer improve it.

    Returns (dt_m (T, nd) int64 matched GT index or -1, dt_ig (T, nd) bool
    matched-to-ignored).
    """
    nd, ng = ious.shape
    t_n = len(iou_thrs)
    dt_m = -np.ones((t_n, nd), np.int64)
    gt_m = -np.ones((t_n, ng), np.int64)
    dt_ig = np.zeros((t_n, nd), bool)
    for ti, t in enumerate(iou_thrs):
        for di in range(nd):
            best, best_gi = min(t, 1 - 1e-10), -1
            for gi in range(ng):
                if gt_m[ti, gi] >= 0 and not g_crowd[gi]:
                    continue
                # stop at ignored GT if a real match was found
                if best_gi > -1 and not g_ignore[best_gi] and g_ignore[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best, best_gi = ious[di, gi], gi
            if best_gi == -1:
                continue
            dt_ig[ti, di] = g_ignore[best_gi]
            dt_m[ti, di] = best_gi
            gt_m[ti, best_gi] = di
    return dt_m, dt_ig


class COCOEval:
    """Evaluate; results() returns the standard 12-metric dict plus
    per-category AP."""

    def __init__(self, inputs: DetEvalInputs, max_dets=(1, 10, 100),
                 area_ranges: Optional[Dict] = None,
                 iou_thrs: np.ndarray = IOU_THRS,
                 impl: Optional[str] = None):
        """impl: None runs the native matcher, ``"reference"`` its numpy
        twin."""
        if impl not in (None, "reference"):
            raise ValueError(f"unknown matcher impl {impl!r}")
        self.impl = impl
        self.inp = inputs
        self.max_dets = tuple(sorted(max_dets))
        self.areas = area_ranges or AREA_RANGES
        self.iou_thrs = np.asarray(iou_thrs)
        self._gt_index = defaultdict(list)
        self._det_index = defaultdict(list)
        for g in inputs.gts:
            self._gt_index[(g["image_id"], g["category_id"])].append(g)
        for d in inputs.dets:
            self._det_index[(d["image_id"], d["category_id"])].append(d)

    # ------------------------------------------------------------- matching
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gt_index.get((img_id, cat_id), [])
        dets = self._det_index.get((img_id, cat_id), [])
        if not gts and not dets:
            return None
        lo, hi = area_rng
        g_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_area = np.asarray(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts])
        g_crowd = np.asarray([g.get("iscrowd", 0) for g in gts])
        g_ignore = (np.asarray([g.get("ignore", 0) for g in gts], bool)
                    | g_crowd.astype(bool) | (g_area < lo) | (g_area > hi))
        # sort GT: non-ignored first (pycocotools order)
        g_order = np.argsort(g_ignore, kind="stable")
        g_boxes, g_crowd, g_ignore = (g_boxes[g_order], g_crowd[g_order],
                                      g_ignore[g_order])

        d_scores = np.asarray([d["score"] for d in dets], np.float64)
        d_order = np.argsort(-d_scores, kind="stable")[:max_det]
        d_boxes = np.asarray([dets[i]["bbox"] for i in d_order],
                             np.float64).reshape(-1, 4)
        d_scores = d_scores[d_order]
        nd, ng = len(d_boxes), len(g_boxes)

        ious = _iou_xywh(d_boxes, g_boxes, g_crowd)
        if self.impl == "reference":
            dt_m, dt_ig = match_greedy_reference(ious, g_ignore, g_crowd,
                                                 self.iou_thrs)
        else:
            dt_m, dt_ig = match_greedy(ious, g_ignore, g_crowd,
                                       self.iou_thrs)
        # unmatched dets with out-of-range area are ignored; so are
        # unmatched dets on (image, category) pairs flagged
        # not-exhaustively-annotated (LVIS protocol — the lvis package
        # ORs this into the same unmatched-ignore mask as the area test)
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        d_out = (d_area < lo) | (d_area > hi)
        if self.inp.nonexhaustive and (img_id, cat_id) \
                in self.inp.nonexhaustive:
            d_out = np.ones_like(d_out)
        dt_ig = dt_ig | ((dt_m == -1) & d_out[None, :])
        return {
            "scores": d_scores, "dt_matched": dt_m >= 0, "dt_ignore": dt_ig,
            "num_gt": int((~g_ignore).sum()),
        }

    # ----------------------------------------------------------- accumulate
    def _evals_for(self, area: str, max_det: int):
        """Per-category eval lists, matched ONCE per (img, cat, area) at
        the largest maxDet and truncated for smaller ones (dets are
        score-ordered, so a maxDet-m eval is the first m columns) —
        the same reuse pycocotools gets from slicing dtMatches."""
        key = area
        if not hasattr(self, "_eval_cache"):
            self._eval_cache = {}
        if key not in self._eval_cache:
            md = self.max_dets[-1]
            rng = self.areas[area]
            per_cat = {}
            cat_set = set(self.inp.category_ids)
            # only (img, cat) pairs that actually have gts or dets
            pairs = set(self._gt_index) | set(self._det_index)
            for (img_id, cat) in pairs:
                if cat not in cat_set:
                    continue
                e = self._evaluate_img(img_id, cat, rng, md)
                if e is not None:
                    per_cat.setdefault(cat, []).append(e)
            self._eval_cache[key] = per_cat
        per_cat = self._eval_cache[key]
        if max_det == self.max_dets[-1]:
            return per_cat
        return {c: [{
            "scores": e["scores"][:max_det],
            "dt_matched": e["dt_matched"][:, :max_det],
            "dt_ignore": e["dt_ignore"][:, :max_det],
            "num_gt": e["num_gt"],
        } for e in evs] for c, evs in per_cat.items()}

    def _accumulate(self, area: str, max_det: int):
        """Per-category (precision[T,R], recall[T]) arrays."""
        T, R = len(self.iou_thrs), len(RECALL_THRS)
        cats = list(self.inp.category_ids)
        precision = -np.ones((T, R, len(cats)))
        recall = -np.ones((T, len(cats)))
        by_cat = self._evals_for(area, max_det)
        for ci, cat in enumerate(cats):
            evals = by_cat.get(cat, [])
            if not evals:
                continue
            scores = np.concatenate([e["scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            matched = np.concatenate([e["dt_matched"] for e in evals],
                                     axis=1)[:, order]
            ignored = np.concatenate([e["dt_ignore"] for e in evals],
                                     axis=1)[:, order]
            npig = sum(e["num_gt"] for e in evals)
            if npig == 0:
                continue
            tps = matched & ~ignored
            fps = ~matched & ~ignored
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(T):
                tp, fp = tp_sum[ti], fp_sum[ti]
                rc = tp / npig
                pr = tp / np.maximum(tp + fp, 1e-12)
                recall[ti, ci] = rc[-1] if len(rc) else 0.0
                # monotone precision envelope
                q = np.zeros(R)
                if len(pr):
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    valid = inds < len(pr)
                    q[valid] = pr[inds[valid]]
                precision[ti, :, ci] = q
        return precision, recall

    # -------------------------------------------------------------- results
    def results(self) -> Dict[str, float]:
        md = self.max_dets[-1]
        precision, recall = self._accumulate("all", md)

        def ap(prec, thr=None):
            p = prec if thr is None else prec[
                np.where(self.iou_thrs == thr)[0]]
            p = p[p > -1]
            return float(np.mean(p)) * 100 if p.size else float("nan")

        out = {
            "AP": ap(precision),
            "AP50": ap(precision, 0.5),
            "AP75": ap(precision, 0.75),
        }
        for area in ("small", "medium", "large"):
            p, _ = self._accumulate(area, md)
            out[f"AP{area[0]}"] = ap(p)
        for m in self.max_dets:
            _, r = self._accumulate("all", m)
            rv = r[r > -1]
            out[f"AR@{m}"] = float(np.mean(rv)) * 100 if rv.size else \
                float("nan")
        # per-category AP (reference reports this for few-shot splits)
        per_cat = {}
        for ci, cat in enumerate(self.inp.category_ids):
            p = precision[:, :, ci]
            p = p[p > -1]
            per_cat[cat] = float(np.mean(p)) * 100 if p.size else \
                float("nan")
        out["per_category_AP"] = per_cat
        return out
