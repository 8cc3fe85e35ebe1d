"""Meta-FCOS registration: ``generate_class_codes`` over the mix's support
sets, the code rows fetched to the host each call.

The comparison: ``code_gap``, the largest relative L2 distance between a
class's served raw code (row and bias) and the reference's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench.counts import flops
from port_bench.lib.drive import RegisterDriver
from port_bench.reference import detector as ref

CHUNK = 4  # classes the reference holds at once


class Driver(RegisterDriver):

    def flops(self) -> int:
        return flops.fcos_register_flops(self.cell.table)["total"]

    def reference_codes(self, images, boxes, arith) -> Dict[str, torch.Tensor]:
        """(C, shots, h, w, 3) supports and (C, shots, 4) boxes -> C raw
        codes."""
        return ref.fcos_register(self.cell.sd,
                                 images.reshape(-1, *images.shape[2:]),
                                 boxes.reshape(-1, 4), self.cell.table, arith)

    def compare(self, images, boxes, served, arith) -> Dict[str, float]:
        gap = 0.0
        for c0 in range(0, images.shape[0], CHUNK):
            codes = self.reference_codes(images[c0:c0 + CHUNK],
                                         boxes[c0:c0 + CHUNK], arith)
            r = torch.cat([codes["cls_conv"], codes["cls_bias"][:, None]], 1)
            s = torch.as_tensor(np.concatenate(
                [served["cls_conv"][c0:c0 + CHUNK],
                 served["cls_bias"][c0:c0 + CHUNK, None]], 1), device=r.device)
            gap = max(gap, float(((s - r).norm(dim=1)
                                  / r.norm(dim=1)).max()))
        return {"code_gap": gap}
