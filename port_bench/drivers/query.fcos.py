"""Meta-FCOS query batches: ``make_fcos_infer`` as ``MetaTestDriver`` builds
it, against the mix's bank.

The comparison (a served detection names its candidate: level, location
and class):

  * ``score_logit_gap``: the largest gap between a served score and the
    reference's score of the same candidate, in the log-odds of the squared
    score (``check.log_odds``): served scores sit near 1, where the
    sigmoids flatten every error;
  * ``box_gap``: the largest coordinate gap between a served box and the
    reference's box of the same candidate (clipped alike), in strides of
    its level;
  * ``miss_share``: the share of the reference's own detections (its
    decode and NMS) that were not served. Near-tied candidates trading
    places at the top-100 cut, and neighbours trading which one NMS keeps,
    move it a little; a wrong selection moves it a lot.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.counts import flops
from port_bench.lib.check import log_odds, update_max
from port_bench.lib.drive import QueryDriver
from port_bench.reference import detector as ref
from port_bench.reference import fcos_decode as fd

CHUNK = 2  # images the reference holds at once


class Driver(QueryDriver):

    def make_infer(self):
        from sylph_tpu_torch.evaluation.meta_eval import make_fcos_infer
        from sylph_tpu_torch.runner import _decode_cfg, _eval_grid

        cfg = self.cell.cfg
        return make_fcos_infer(self.cell.det, self.bank, _eval_grid(cfg),
                               _decode_cfg(cfg), device=self.cell.dev)

    def flops(self) -> int:
        return flops.fcos_query_flops(self.cell.table,
                                      len(self.bank["cls_bias"]))["total"]

    def compare(self, bank, images, sizes, served, arith) -> Dict[str, float]:
        sd, cfg, dev = self.cell.sd, self.cell.table, images.device
        grid = ref.fcos_grid(cfg, dev)
        offsets = np.cumsum([0] + [h * w for h, w in grid.sizes])[:-1]
        strides = cfg["MODEL.FCOS.FPN_STRIDES"]
        out = dict.fromkeys(("score_logit_gap", "box_gap", "miss_share"), 0.0)
        kept = missed = 0
        for c0 in range(0, images.shape[0], CHUNK):
            dense = ref.fcos_dense(sd, images[c0:c0 + CHUNK], bank, cfg,
                                   arith)
            for b in range(dense.logits.shape[0]):
                det, hw = served[c0 + b], sizes[c0 + b]
                v = np.asarray(det["valid"], bool)
                lvl = np.asarray(det["fpn_levels"])[v]
                loc = np.asarray(det["locations"])[v]
                s = np.asarray([strides[i] for i in lvl], np.float32)
                w_l = np.asarray([grid.sizes[i][1] for i in lvl])
                ix = np.rint((loc[:, 0] - s // 2) / s).astype(np.int64)
                iy = np.rint((loc[:, 1] - s // 2) / s).astype(np.int64)
                index = torch.as_tensor(offsets[lvl] + iy * w_l + ix,
                                        device=dev)
                cls = torch.as_tensor(np.asarray(det["classes"])[v],
                                      dtype=torch.long, device=dev)
                r_scores = fd.scores_at(dense, b, index, cls).cpu().numpy()
                r_boxes = fd.clip(fd.boxes_at(dense, b, grid, index),
                                  hw).cpu().numpy()
                if v.any():
                    update_max(out, "score_logit_gap", np.abs(
                        log_odds(np.asarray(det["scores"])[v])
                        - log_odds(r_scores)))
                    update_max(out, "box_gap", np.abs(
                        np.asarray(det["boxes"])[v] - r_boxes).max(1) / s)
                cand, keep, _ = ref.fcos_detect(dense, b, grid, hw, cfg)
                n = dense.logits.shape[-1]
                mine = set((index * n + cls).tolist())
                theirs = (cand.index[keep] * n + cand.classes[keep]).tolist()
                kept += len(theirs)
                missed += sum(1 for t in theirs if t not in mine)
        out["miss_share"] = missed / max(kept, 1)
        return out

    def reference_rows(self, bank, images, sizes, arith) -> List[Dict]:
        sd, cfg = self.cell.sd, self.cell.table
        grid = ref.fcos_grid(cfg, images.device)
        m = cfg["MODEL.FCOS.POST_NMS_TOPK_TEST"]
        out = []
        for b in range(images.shape[0]):
            dense = ref.fcos_dense(sd, images[b:b + 1], bank, cfg, arith)
            cand, keep, boxes = ref.fcos_detect(dense, 0, grid, sizes[b], cfg)
            row = {"boxes": np.zeros((m, 4), np.float32),
                   "scores": np.zeros((m,), np.float32),
                   "classes": np.zeros((m,), np.int32),
                   "valid": np.zeros((m,), bool),
                   "locations": np.zeros((m, 2), np.float32),
                   "fpn_levels": np.zeros((m,), np.int32)}
            n = len(keep)
            row["boxes"][:n] = boxes.cpu().numpy()
            row["scores"][:n] = cand.scores[keep].cpu().numpy()
            row["classes"][:n] = cand.classes[keep].cpu().numpy()
            row["valid"][:n] = True
            row["locations"][:n] = grid.locations[
                cand.index[keep]].cpu().numpy()
            row["fpn_levels"][:n] = cand.levels[keep].cpu().numpy()
            out.append(row)
        return out
