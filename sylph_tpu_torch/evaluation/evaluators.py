"""Sylph evaluators on top of the numpy COCO protocol (the port's own
copy of sylph_tpu/evaluation/evaluators.py).

Reference counterparts (evaluation/meta_learn_evaluation.py:472-812,
lvis_evaluation.py:110-320, coco_evaluation.py:27-178):

  * ``COCOMetaEvaluator`` — catIds-restricted COCOeval over the episodic
    split; for split=="all" also reports separate novel/base AP means
    (coco_evaluation.py:152-171);
  * ``AREvaluator``       — adds AR metrics to the AP table
    (meta_learn_evaluation.py:472-547);
  * ``COCOOWDEvaluator``  — class-agnostic open-world evaluation: GT
    category ids rewritten to a single foreground class
    (meta_learn_evaluation.py:680-812);
  * ``FewshotLVISEvaluator`` — LVIS protocol: maxDets=300, no crowd,
    federated negatives (dets on images whose neg_category_ids contain
    the class count as FPs; other images are out-of-universe), APr/c/f
    frequency breakdown (lvis_evaluation.py:110-320).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_eval_np import COCOEval, DetEvalInputs


def _gt_from_records(records: List[dict], id_map: Dict[int, int]) -> List[dict]:
    """Dataset records (contiguous ids) → COCO gt dicts (dataset ids)."""
    inv = {v: k for k, v in id_map.items()}
    gts = []
    for r in records:
        for a in r.get("annotations", []):
            x, y, w, h = a["bbox"]
            gts.append({
                "image_id": r["image_id"],
                "category_id": inv.get(a["category_id"], a["category_id"]),
                "bbox": [x, y, w, h], "area": w * h,
                "iscrowd": a.get("iscrowd", 0),
            })
    return gts


class COCOMetaEvaluator:
    """process(results) accumulates COCO-format detections; evaluate()
    runs the protocol restricted to the split's categories."""

    def __init__(self, query_records: List[dict], metadata: Dict,
                 novel_dataset_ids: Optional[Sequence[int]] = None):
        self.metadata = metadata
        self.id_map = metadata["thing_dataset_id_to_contiguous_id"]
        self.cat_ids = sorted(self.id_map)
        self.image_ids = [r["image_id"] for r in query_records]
        self.gts = _gt_from_records(query_records, self.id_map)
        self.novel_ids = list(novel_dataset_ids or [])
        self.reset()

    def reset(self):
        self._results: List[dict] = []

    def process(self, results: List[dict]):
        self._results.extend(results)

    def _run(self, max_dets=(1, 10, 100)):
        return COCOEval(DetEvalInputs(
            gts=self.gts, dets=self._results, image_ids=self.image_ids,
            category_ids=self.cat_ids), max_dets=max_dets).results()

    def evaluate(self) -> Dict[str, float]:
        res = self._run()
        out = {k: v for k, v in res.items() if k != "per_category_AP"}
        per_cat = res["per_category_AP"]
        inv_names = {did: self.metadata["thing_classes"][cid]
                     for did, cid in self.id_map.items()}
        out.update({f"AP-{inv_names[c]}": v for c, v in per_cat.items()})
        if self.novel_ids:
            novel = [per_cat[c] for c in per_cat if c in set(self.novel_ids)]
            base = [per_cat[c] for c in per_cat
                    if c not in set(self.novel_ids)]
            out["nAP"] = float(np.nanmean(novel)) if novel else float("nan")
            out["bAP"] = float(np.nanmean(base)) if base else float("nan")
        return {"bbox": out}


class AREvaluator(COCOMetaEvaluator):
    """AP + AR table (reference AREvaluator)."""

    def evaluate(self):
        out = super().evaluate()
        res = self._run()
        for m in (1, 10, 100):
            out["bbox"][f"AR@{m}"] = res[f"AR@{m}"]
        return out


class COCOOWDEvaluator(COCOMetaEvaluator):
    """Open-world detection: everything is one foreground class
    (reference COCO_OWD rewrite, meta_learn_evaluation.py:726-812)."""

    OWD_CAT = 1

    def __init__(self, query_records, metadata, **kw):
        super().__init__(query_records, metadata)
        for g in self.gts:
            g["category_id"] = self.OWD_CAT
        self.cat_ids = [self.OWD_CAT]

    def process(self, results):
        for r in results:
            r = dict(r)
            r["category_id"] = self.OWD_CAT
            self._results.append(r)


class FewshotLVISEvaluator:
    """LVIS federated evaluation with frequency breakdown."""

    def __init__(self, query_records: List[dict], metadata: Dict,
                 categories: Optional[List[dict]] = None,
                 max_dets: int = 300):
        self.metadata = metadata
        self.id_map = metadata["thing_dataset_id_to_contiguous_id"]
        self.cat_ids = sorted(self.id_map)
        self.max_dets = max_dets
        self.image_ids = [r["image_id"] for r in query_records]
        self.gts = _gt_from_records(query_records, self.id_map)
        # federated universe: for each category, images where it's
        # positively annotated or listed negative are in-universe.
        inv = {v: k for k, v in self.id_map.items()}
        self._in_universe = defaultdict(set)
        # (image, category) pairs where the category is NOT exhaustively
        # annotated: unmatched detections there are ignored, not false
        # positives (lvis-package protocol the reference consumes,
        # sylph/evaluation/lvis_evaluation.py:246-251)
        self._nonexhaustive = set()
        for r in query_records:
            for a in r.get("annotations", []):
                self._in_universe[inv.get(a["category_id"])].add(
                    r["image_id"])
            for did in r.get("neg_category_ids", []):
                self._in_universe[did].add(r["image_id"])
            for did in r.get("not_exhaustive_category_ids", []):
                self._nonexhaustive.add((r["image_id"], did))
        self.freq = {}
        for c in categories or []:
            self.freq[c["id"]] = c.get("frequency", "f")
        self.reset()

    def reset(self):
        self._results = []

    def process(self, results: List[dict]):
        self._results.extend(results)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        # drop detections that are out-of-universe for their category
        dets = [d for d in self._results
                if not self._in_universe
                or d["image_id"] in self._in_universe.get(
                    d["category_id"], set())]
        res = COCOEval(DetEvalInputs(
            gts=self.gts, dets=dets, image_ids=self.image_ids,
            category_ids=self.cat_ids,
            nonexhaustive=self._nonexhaustive),
            max_dets=(self.max_dets,)).results()
        out = {k: v for k, v in res.items()
               if k not in ("per_category_AP",)}
        per_cat = res["per_category_AP"]
        if self.freq:
            for tag, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                vals = [v for c, v in per_cat.items()
                        if self.freq.get(c) == tag and not np.isnan(v)]
                out[key] = float(np.mean(vals)) if vals else float("nan")
        inv_names = {did: self.metadata["thing_classes"][cid]
                     for did, cid in self.id_map.items()}
        out.update({f"AP-{inv_names[c]}": v for c, v in per_cat.items()})
        return {"bbox": out}
