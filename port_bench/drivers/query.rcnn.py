"""Meta Faster R-CNN query batches: the two-stage runner's ``make_infer``
against the mix's bank.

The reference follows the program step by step at the one point where two
correct runs part, its proposals: the program's are kept as its ROI stage
takes them (a wrapper on the instance's bound ``roi_candidates``), the
reference's own RPN proposals are held against them both ways, and the
reference's ROI stage then runs on the program's proposals, so that every
served detection names one (proposal, class) candidate:

  * ``proposal_miss_share``: the program's valid proposals with no proposal
    of the reference's own at IoU >= ``MATCH_IOU``;
  * ``proposal_lost_share``: the reference's own proposals with no valid
    proposal of the program's at IoU >= ``MATCH_IOU``: a proposal set cut
    short, or one box repeated, reads high here and nowhere else;
  * ``score_log_gap``: the largest |log served - log reference| of a served
    detection's probability at its proposal and class (found by its box;
    one that matches no candidate's box at ``MATCH_IOU`` counts
    ``UNMATCHED_GAP``);
  * ``miss_share``: the reference's detections on those proposals (its
    softmax, decode and NMS) that were not served.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.counts import flops
from port_bench.lib import model
from port_bench.lib.check import (MATCH_IOU, UNMATCHED_GAP, iou_matrix,
                                  unmatched, update_max)
from port_bench.lib.drive import QueryDriver
from port_bench.reference import detector as ref

CHUNK = 1  # images the reference holds at once


class Driver(QueryDriver):

    def __init__(self, cell):
        self.proposals: List = []
        bound = cell.det.roi_candidates

        def roi_candidates(feats, props, props_valid, *a, **k):
            self.proposals.append((props, props_valid))
            return bound(feats, props, props_valid, *a, **k)
        cell.det.roi_candidates = roi_candidates
        super().__init__(cell)

    def make_infer(self):
        from sylph_tpu_torch.meta_faster_rcnn_runner import eval_anchor_grid

        cell = self.cell
        runner = model.runner_class(cell.conf["runner"])(device=cell.dev)
        return runner.make_infer(cell.cfg, cell.det, self.bank,
                                 eval_anchor_grid(cell.cfg))

    def flops(self) -> int:
        return flops.rcnn_query_flops(self.cell.table,
                                      len(self.bank["cls_bias"]))["total"]

    def window(self, deadline=None, n=None) -> Dict:
        self.proposals.clear()
        res = super().window(deadline, n)
        res["proposals"] = list(self.proposals)
        return res

    def served_rows(self, res: Dict, picks: List[int]) -> List[Dict]:
        rows = super().served_rows(res, picks)
        props = [p for i in picks for p in zip(
            *(np.asarray(t.cpu()) for t in res["proposals"][i]))]
        for row, (p, pv) in zip(rows, props):
            row.update(proposals=p, proposals_valid=pv)
        return rows

    def compare(self, bank, images, sizes, served, arith) -> Dict[str, float]:
        sd, cfg, dev = self.cell.sd, self.cell.table, images.device
        out = dict.fromkeys(("proposal_miss_share", "proposal_lost_share",
                             "score_log_gap", "miss_share"), 0.0)
        props_n = props_missed = own_n = own_lost = kept = missed = 0
        for c0 in range(0, images.shape[0], CHUNK):
            feats = ref.pyramid(sd, images[c0:c0 + CHUNK], cfg, "rcnn", arith)
            hw = [list(map(float, s)) for s in sizes[c0:c0 + CHUNK]]
            own = ref.rcnn_proposals(sd, feats, hw, cfg, arith)
            for b in range(len(hw)):
                det = served[c0 + b]
                pv = torch.as_tensor(np.asarray(det["proposals_valid"], bool),
                                     device=dev)
                props = torch.as_tensor(np.asarray(det["proposals"]),
                                        device=dev).float()[pv]
                props_n += len(props)
                props_missed += unmatched(props, own[b])
                own_n += len(own[b])
                own_lost += unmatched(own[b], props)
                r = ref.rcnn_roi(sd, feats, b, props, hw[b], bank, cfg, arith)
                v = np.asarray(det["valid"], bool)
                scores = np.asarray(det["scores"], np.float64)[v]
                cls = torch.as_tensor(np.asarray(det["classes"])[v],
                                      dtype=torch.long, device=dev)
                boxes = torch.as_tensor(np.asarray(det["boxes"])[v],
                                        device=dev).float()
                theirs = set((r.keep_prop * 10 ** 6 + r.keep_cls).tolist())
                mine = set()
                if len(scores) and len(r.roi.boxes):
                    best, p = iou_matrix(boxes, r.roi.boxes).max(1)
                    r_scores = r.roi.probs[p, cls].double().cpu().numpy()
                    gap = np.abs(np.log(np.maximum(scores, 1e-30))
                                 - np.log(np.maximum(r_scores, 1e-30)))
                    gap[(best < MATCH_IOU).cpu().numpy()] = UNMATCHED_GAP
                    update_max(out, "score_log_gap", gap)
                    mine = set((p * 10 ** 6 + cls).tolist())
                elif len(scores):
                    out["score_log_gap"] = max(out["score_log_gap"],
                                               UNMATCHED_GAP)
                kept += len(theirs)
                missed += len(theirs - mine)
        out["proposal_miss_share"] = props_missed / max(props_n, 1)
        out["proposal_lost_share"] = own_lost / max(own_n, 1)
        out["miss_share"] = missed / max(kept, 1)
        return out

    def reference_rows(self, bank, images, sizes, arith) -> List[Dict]:
        sd, cfg = self.cell.sd, self.cell.table
        m = cfg["TEST.DETECTIONS_PER_IMAGE"]
        slots = cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]
        out = []
        for b in range(images.shape[0]):
            r = ref.rcnn_detect(sd, images[b:b + 1], [sizes[b]], bank, cfg,
                                arith)[0]
            n, p = len(r.keep_prop), len(r.proposals)
            row = {"boxes": np.zeros((m, 4), np.float32),
                   "scores": np.zeros((m,), np.float32),
                   "classes": np.zeros((m,), np.int32),
                   "valid": np.zeros((m,), bool),
                   "proposals": np.zeros((slots, 4), np.float32),
                   "proposals_valid": np.zeros((slots,), bool)}
            row["proposals"][:p] = r.proposals.cpu().numpy()
            row["proposals_valid"][:p] = True
            row["boxes"][:n] = r.roi.boxes[r.keep_prop].cpu().numpy()
            row["scores"][:n] = r.roi.probs[r.keep_prop,
                                            r.keep_cls].cpu().numpy()
            row["classes"][:n] = r.keep_cls.cpu().numpy()
            row["valid"][:n] = True
            out.append(row)
        return out

    def control(self, arith) -> Dict:
        res = super().control(arith)
        res["proposals"] = [(torch.as_tensor(d.proposals),
                             torch.as_tensor(d.proposals_valid))
                            for d in res["detections"]]
        return res
