"""The one traffic generator: inputs made from ``--seed``, and the feeds a
window drives.

A traffic mix (``traffic/<name>.json``) is parameters only; the
``driver`` it names (``lib/drive.py``) says which of these it reads:

  * ``"query"`` (``QueryRing``, ``QueryFeed``, ``code_bank`` from the mix's
    ``bank``): a ring of ``ring`` uint8 BGR canvases at the eval canvas,
    each with random pixels inside a content size taken in turn from
    ``content_hw`` (the rest of the canvas is 0, as the loader pads), and a
    closed loop of batches of ``batch`` images; batch i holds ring images
    ``order[(i * batch + j) % ring]``, ``order`` a permutation drawn from the
    seed. Items are shaped as ``data/loader.py::build_query_loader`` yields
    them.
  * ``"register"`` (``SupportRing``, ``SupportFeed``): a ring of ``ring``
    support sets (``shots`` canvases each, at the support canvas) and one
    box a shot for each of ``vocabulary`` classes, drawn as
    ``tools/bench_registration.py::synthetic_support_loader`` draws them;
    an endless stream of classes whose ids cycle over the vocabulary,
    class k always the same set
    (ring set ``order[k % ring]``, boxes ``k``). Items are shaped as
    ``data/loader.py::build_support_set_loader`` yields them; the stream
    stops only at a multiple of ``class_batch`` classes, so every call the
    window makes has the same shape.

Every seed gives the same sizes and the same amount of work, in another
order and with other pixels, weights and codes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

_TAGS = {"weights": 1, "images": 2, "bank": 3, "order": 4, "boxes": 5,
         "sample": 6}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``--seed`` (any integer)."""
    s = np.random.SeedSequence([seed % 2 ** 64, _TAGS[tag]])
    return int(s.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def _generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def _permutation(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(sub_seed(seed, "order") % 2 ** 32
                                 ).permutation(n)


# ----------------------------------------------------------------- bank
def code_bank(spec: Dict, width: int, seed: int,
              device) -> Dict[str, np.ndarray]:
    """The class codes the query cells serve, on the host as the program's
    ``make_*_infer`` takes them. ``spec["draw"]``: ``"normal"`` rows
    (``std`` times a standard normal) or ``"unit"`` rows (standard normal
    rows scaled to unit length, the L2-normalized form of the code
    generator's output); every bias ``spec["bias"]``."""
    gen = _generator(seed, "bank", device)
    rows = torch.randn((spec["rows"], width), generator=gen,
                       device=torch.device(device))
    if spec["draw"] == "normal":
        rows = rows * spec["std"]
    elif spec["draw"] == "unit":
        rows = rows / rows.norm(dim=1, keepdim=True)
    else:
        raise ValueError(f"bank draw {spec['draw']!r}")
    return {"cls_conv": rows.cpu().numpy(),
            "cls_bias": np.full((spec["rows"],), spec["bias"], np.float32)}


# ---------------------------------------------------------------- query
class QueryRing:
    """``images`` (R, H, W, 3) uint8 and ``sizes`` (R, 2) content (h, w)."""

    def __init__(self, mix: Dict, canvas, seed: int, device):
        r = mix["ring"]
        h, w = canvas
        gen = _generator(seed, "images", device)
        imgs = torch.randint(0, 256, (r, h, w, 3), generator=gen,
                             dtype=torch.uint8, device=torch.device(device))
        content = mix["content_hw"]
        self.sizes = np.asarray([content[i % len(content)] for i in range(r)],
                                np.int32)
        self.sizes = np.minimum(self.sizes, np.asarray(canvas, np.int32))
        for i, (ch, cw) in enumerate(self.sizes):
            imgs[i, ch:] = 0
            imgs[i, :, cw:] = 0
        self.images = imgs.cpu().numpy()
        self.order = _permutation(r, seed)


class QueryFeed:
    """Batches of ``batch`` ring images until ``deadline`` (a
    ``time.perf_counter()`` value) or ``max_batches``; ``log`` holds the
    ring indices of each batch yielded."""

    def __init__(self, ring: QueryRing, batch: int,
                 deadline: Optional[float] = None,
                 max_batches: Optional[int] = None):
        self.ring, self.batch = ring, batch
        self.deadline, self.max_batches = deadline, max_batches
        self.log: List[np.ndarray] = []
        r = len(ring.order)
        self.batches = []
        for i in range(max(1, r // batch)):
            idx = ring.order[(i * batch + np.arange(batch)) % r]
            self.batches.append((idx, np.ascontiguousarray(ring.images[idx])))

    def __iter__(self):
        i = 0
        while ((self.max_batches is None or i < self.max_batches)
               and (self.deadline is None
                    or time.perf_counter() < self.deadline)):
            idx, images = self.batches[i % len(self.batches)]
            sizes = self.ring.sizes[idx]
            self.log.append(idx)
            yield {"images": images, "image_sizes": sizes,
                   "image_ids": idx.astype(np.int64), "orig_sizes": sizes,
                   "batch_valid": np.ones((self.batch,), bool)}
            i += 1


# ------------------------------------------------------------- register
class SupportRing:
    """``images`` (R, shots, h, w, 3) uint8 and ``boxes`` (V, shots, 4)."""

    def __init__(self, mix: Dict, canvas, seed: int, device):
        r, shots, v = mix["ring"], mix["shots"], mix["vocabulary"]
        h, w = canvas
        gen = _generator(seed, "images", device)
        self.images = torch.randint(
            0, 256, (r, shots, h, w, 3), generator=gen, dtype=torch.uint8,
            device=torch.device(device)).cpu().numpy()
        rng = np.random.RandomState(sub_seed(seed, "boxes") % 2 ** 32)
        x0 = rng.randint(0, w // 2, (v, shots, 1))
        y0 = rng.randint(0, h // 2, (v, shots, 1))
        x1 = x0 + rng.randint(16, w // 2, (v, shots, 1))
        y1 = y0 + rng.randint(16, h // 2, (v, shots, 1))
        self.boxes = np.concatenate([x0, y0, x1, y1], -1).astype(np.float32)
        self.order = _permutation(r, seed)

    def support_set(self, class_id: int):
        return (self.images[self.order[class_id % len(self.order)]],
                self.boxes[class_id])


class SupportFeed:
    """Classes 0, 1, 2, ... (ids modulo the vocabulary), stopping at a
    multiple of ``class_batch`` once past ``deadline`` or ``max_classes``;
    ``count`` is the number yielded."""

    def __init__(self, ring: SupportRing, class_batch: int,
                 deadline: Optional[float] = None,
                 max_classes: Optional[int] = None):
        self.ring, self.class_batch = ring, class_batch
        self.deadline, self.max_classes = deadline, max_classes
        self.count = 0

    def _more(self) -> bool:
        if self.count % self.class_batch:
            return True
        if self.max_classes is not None and self.count >= self.max_classes:
            return False
        return self.deadline is None or time.perf_counter() < self.deadline

    def __iter__(self):
        shots = self.ring.boxes.shape[1]
        while self._more():
            cid = self.count % self.ring.boxes.shape[0]
            images, boxes = self.ring.support_set(cid)
            self.count += 1
            yield {"support_images": images, "support_boxes": boxes,
                   "support_box_valid": np.ones((shots,), bool),
                   "class_id": cid, "class_name": f"class_{cid:04d}"}
