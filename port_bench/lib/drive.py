"""The windows, and the two kinds of driver a traffic mix names.

A traffic mix (``traffic/<mix>.json``) names its ``driver``; a cell's run
loads ``drivers/<driver>.<family>.py`` (``spec.driver``), whose ``Driver``
class derives from one of the bases here and supplies what belongs to one
model family: the program's entry, the FLOPs a unit of work counts, the
comparison with the plain reference, and the reference's own answers for
the control. So a mix of a known driver is a data file, and a new driver
or family is new files.

``query_window`` runs ``evaluation/meta_eval.py::run_query_inference`` with
the ``infer`` the runner makes over a ``QueryFeed``, into an evaluator that
keeps nothing. ``TimedInfer`` wraps ``infer`` from outside: a batch's time
runs from its hand-over to ``infer`` to the return of ``Detections.numpy()``
(the detections on the host), and the host detections are kept for the
output check. ``register_window`` runs ``generate_class_codes`` over a
``SupportFeed``; the code rows come back on the host, as the function
fetches them. Every window returns ``start``, ``end`` and ``units`` (images
or classes completed).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import check, traffic

WARMUP_BATCHES = 3
WARMUP_CALLS = 2


class _Sink:
    """An evaluator that keeps nothing and computes no AP."""

    def process(self, results) -> None:
        pass

    def evaluate(self) -> Dict:
        return {}


class _HostFetch:
    """Stands for the ``Detections`` an ``infer`` call returned: its
    ``numpy()`` fetches them and stamps the time."""

    def __init__(self, owner: "TimedInfer", det, t0: float):
        self.owner, self.det, self.t0 = owner, det, t0

    def numpy(self):
        host = self.det.numpy()
        self.owner.batches.append((self.t0, time.perf_counter()))
        self.owner.detections.append(host)
        return host


class TimedInfer:
    def __init__(self, infer):
        self.infer = infer
        self.batches: List = []      # (hand-over, detections on the host)
        self.detections: List = []   # host Detections, batch by batch

    def __call__(self, images, image_sizes):
        t0 = time.perf_counter()
        return _HostFetch(self, self.infer(images, image_sizes), t0)


def query_window(infer, feed, device) -> Dict:
    """-> {"start", "end", "units", "batches": [(t0, t1)], "detections",
    "log": ring indices per batch}."""
    from sylph_tpu_torch.evaluation.meta_eval import run_query_inference

    timed = TimedInfer(infer)
    start = time.perf_counter()
    run_query_inference(timed, feed, {}, _Sink(), device=device)
    end = time.perf_counter()
    return {"start": start, "end": end, "batches": timed.batches,
            "detections": timed.detections, "log": list(feed.log),
            "units": sum(len(i) for i in feed.log)}


def register_window(model, feed, class_batch: int, device) -> Dict:
    """-> {"start", "end", "units", "codes": {class id: raw code}}."""
    from sylph_tpu_torch.evaluation.meta_eval import generate_class_codes

    start = time.perf_counter()
    codes = generate_class_codes(model, feed, class_batch=class_batch,
                                 device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    end = time.perf_counter()
    return {"start": start, "end": end, "units": feed.count, "codes": codes}


class Stacked:
    """Per-image rows stacked into the fields of a batch's host
    ``Detections``."""

    def __init__(self, rows: List[Dict]):
        for k in rows[0]:
            setattr(self, k, np.stack([r[k] for r in rows]))


class QueryDriver:
    """A closed loop of query batches (``traffic.QueryRing``/``QueryFeed``
    from the mix's parameters, its ``bank`` of codes) through the runner's
    ``infer`` and ``run_query_inference``. A family gives ``make_infer()``,
    ``flops() -> FLOPs an image``, ``compare(bank, images, sizes, served,
    arith) -> {number: value}`` and ``reference_rows(bank, images, sizes,
    arith)``: the reference's own detections, one dict of host fields an
    image, which the control serves in the program's place."""

    kind = "query"
    FIELDS = ("boxes", "scores", "classes", "valid", "locations",
              "fpn_levels")

    def __init__(self, cell):
        self.cell = cell
        cfg, mix = cell.cfg, cell.mix
        self.ring = traffic.QueryRing(mix, cfg.TPU.EVAL_CANVAS, cell.seed,
                                      cell.dev)
        width = cfg.MODEL.META_LEARN.CODE_GENERATOR.OUT_CHANNEL
        self.bank = traffic.code_bank(mix["bank"], width, cell.seed, cell.dev)
        self.infer = self.make_infer()
        self.flops_per_unit = self.flops()

    def window(self, deadline=None, n=None) -> Dict:
        feed = traffic.QueryFeed(self.ring, self.cell.mix["batch"], deadline,
                                 n)
        return query_window(self.infer, feed, self.cell.dev)

    def warm_up(self) -> None:
        self.window(n=WARMUP_BATCHES)

    def sample_window(self) -> Dict:
        """As many batches as the check samples."""
        return self.window(n=self.cell.limits["sample_batches"])

    def free(self) -> None:
        self.infer = None

    def device_bank(self) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.cell.dev)
                for k, v in self.bank.items()}

    def served_rows(self, res: Dict, picks: List[int]) -> List[Dict]:
        """The host detections of the sampled batches, one dict an image."""
        return [{f: getattr(res["detections"][i], f)[j] for f in self.FIELDS
                 if hasattr(res["detections"][i], f)}
                for i in picks for j in range(len(res["log"][i]))]

    def check(self, res: Dict, arith) -> Dict[str, float]:
        cell = self.cell
        picks = check.sample(len(res["detections"]),
                             cell.limits["sample_batches"], cell.seed)
        idx = np.concatenate([res["log"][i] for i in picks])
        images = torch.as_tensor(self.ring.images[idx], device=cell.dev)
        sizes = self.ring.sizes[idx].tolist()
        return self.compare(self.device_bank(), images, sizes,
                            self.served_rows(res, picks), arith)

    def control(self, arith) -> Dict:
        """What the window would hand the check, with the reference (in
        ``arith``) in the program's place, over the sampled batches."""
        feed = traffic.QueryFeed(self.ring, self.cell.mix["batch"],
                                 max_batches=self.cell.limits[
                                     "sample_batches"])
        bank = self.device_bank()
        served = [Stacked(self.reference_rows(
            bank, torch.as_tensor(b["images"], device=self.cell.dev),
            b["image_sizes"].tolist(), arith)) for b in feed]
        return {"detections": served, "log": feed.log}


class RegisterDriver:
    """An endless stream of support sets (``traffic.SupportRing``/
    ``SupportFeed``) through ``generate_class_codes``, ``class_batch``
    classes a call. A family gives ``flops() -> FLOPs a class``,
    ``compare(images, boxes, served, arith)`` and ``reference_codes(images,
    boxes, arith) -> {"cls_conv", "cls_bias"}`` for one call's classes."""

    kind = "register"

    def __init__(self, cell):
        self.cell = cell
        self.class_batch = cell.mix["class_batch"]
        self.ring = traffic.SupportRing(cell.mix, cell.cfg.TPU.SUPPORT_CANVAS,
                                        cell.seed, cell.dev)
        self.flops_per_unit = self.flops()

    def window(self, deadline=None, n=None) -> Dict:
        feed = traffic.SupportFeed(self.ring, self.class_batch, deadline, n)
        return register_window(self.cell.det, feed, self.class_batch,
                               self.cell.dev)

    def warm_up(self) -> None:
        self.window(n=WARMUP_CALLS * self.class_batch)

    def _sample_calls(self) -> int:
        return -(-self.cell.limits["sample_classes"] // self.class_batch)

    def sample_window(self) -> Dict:
        """As many calls as the check samples classes."""
        return self.window(n=self._sample_calls() * self.class_batch)

    def free(self) -> None:
        pass

    def _supports(self, ids):
        dev = self.cell.dev
        images = torch.as_tensor(np.stack(
            [self.ring.support_set(i)[0] for i in ids]), device=dev)
        return images, torch.as_tensor(self.ring.boxes[ids], device=dev)

    def check(self, res: Dict, arith) -> Dict[str, float]:
        cell = self.cell
        ids = check.sample(min(res["units"], len(self.ring.boxes)),
                           cell.limits["sample_classes"], cell.seed)
        images, boxes = self._supports(ids)
        served = {k: np.stack([np.asarray(res["codes"][i]["code"][k])
                               .reshape(-1) for i in ids])
                  for k in ("cls_conv", "cls_bias")}
        served["cls_bias"] = served["cls_bias"][:, 0]
        return self.compare(images, boxes, served, arith)

    def control(self, arith) -> Dict:
        """The codes of the first calls' classes, with the reference (in
        ``arith``) in the program's place."""
        ids = list(range(self._sample_calls() * self.class_batch))
        codes = {}
        for c0 in range(0, len(ids), self.class_batch):
            grp = ids[c0:c0 + self.class_batch]
            c = self.reference_codes(*self._supports(grp), arith)
            for j, cid in enumerate(grp):
                codes[cid] = {"code": {
                    k: c[k][j:j + 1].cpu().numpy()
                    for k in ("cls_conv", "cls_bias")}}
        return {"units": len(ids), "codes": codes}
