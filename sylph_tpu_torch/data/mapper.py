"""Record -> fixed-shape arrays for the meta-test (port of the eval roles of
sylph_tpu/data/mapper.py).

Each record becomes a fixed-canvas uint8 BGR image (normalized on the
device by ``MetaOneStageDetector._normalize``) plus padded GT arrays. The
support role picks one box per record at map time (``select_a_mask``,
reference code_generator/utils.py:27-47), so the device work is
deterministic.

``map_query_train`` (scale jitter, flips, RandAugment) belongs to the
training slice and raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from . import transforms as T


def _load_image(record: Dict, target_short: Optional[int] = None,
                target_max: Optional[int] = None
                ) -> Tuple[np.ndarray, float]:
    """Decode a record's image as RGB -> ``(array, box_prescale)``.

    When the downstream resize is a shrink and the file is a JPEG,
    ``Image.draft`` decodes directly at a 1/2-1/8 DCT scale that is never
    below the target size. Annotation boxes are in original-image
    coordinates, so callers multiply them by the returned ``box_prescale``
    (per axis, xyxy order; 1.0 when no draft ran).

    The channel order is always RGB here; the BGR model-input convention is
    a stride trick inside the final pad copy.
    """
    path = record["file_name"]
    if os.path.exists(path):
        im = Image.open(path)
        pre = 1.0
        if target_short is not None and im.format == "JPEG":
            w, h = im.size
            scale = target_short / min(h, w)
            if target_max is not None and max(h, w) * scale > target_max:
                scale = target_max / max(h, w)
            if scale < 1.0:
                im.draft("RGB", (max(int(w * scale), 1),
                                 max(int(h * scale), 1)))
                # draft rounds each axis up independently (ceil(w/2^k)),
                # so the prescale is per axis
                pre = np.array([im.size[0] / w, im.size[1] / h,
                                im.size[0] / w, im.size[1] / h],
                               np.float32)
        return np.asarray(im.convert("RGB")), pre
    # records carrying inline pixels (tests)
    img = record.get("image")
    if img is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(np.asarray(img)), 1.0


def _xywh_to_xyxy(anns) -> Tuple[np.ndarray, np.ndarray]:
    if not anns:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int64))
    boxes = np.asarray([a["bbox"] for a in anns], np.float32)
    boxes = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], -1)
    labels = np.asarray([a["category_id"] for a in anns], np.int64)
    return boxes, labels


class EpisodicMapper:
    """Maps records for the meta-test's query and support roles; canvas
    sizes are static per role (``TPU.EVAL_CANVAS``,
    ``TPU.SUPPORT_CANVAS``)."""

    def __init__(self, *, eval_canvas=(1024, 1344),
                 support_canvas=(512, 512), max_gt_boxes: int = 100,
                 min_size_test: int = 800, max_size_test: int = 1333,
                 fmt: str = "BGR"):
        self.eval_canvas = tuple(eval_canvas)
        self.support_canvas = tuple(support_canvas)
        self.max_gt = max_gt_boxes
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test
        self.fmt = fmt

    # ------------------------------------------------------------------ roles
    def map_query_train(self, record: Dict, rng: np.random.RandomState,
                        out: Optional[np.ndarray] = None):
        raise NotImplementedError("training-time mapping (scale jitter, "
                                  "flips, RandAugment) is not ported yet")

    def map_query_eval(self, record: Dict,
                       out: Optional[np.ndarray] = None):
        img, pre = _load_image(record, self.min_size_test,
                               self.max_size_test)
        boxes, labels = _xywh_to_xyxy(record.get("annotations", []))
        boxes *= pre
        img, boxes = T.resize_shortest_edge(img, boxes, self.min_size_test,
                                            self.max_size_test)
        out = self._finalize(img, boxes, labels, self.eval_canvas, out)
        out["image_id"] = record["image_id"]
        out["orig_height"] = record["height"]
        out["orig_width"] = record["width"]
        return out

    def map_support(self, record: Dict, rng: np.random.RandomState,
                    train: bool = True,
                    out: Optional[np.ndarray] = None):
        """Support image -> canvas + ONE selected gt box (select_a_mask)."""
        img, pre = _load_image(record, min(self.support_canvas),
                               max(self.support_canvas))
        boxes, labels = _xywh_to_xyxy(record.get("annotations", []))
        if not len(boxes):
            raise ValueError(f"support record {record.get('image_id')} has "
                             "no box")
        boxes *= pre
        short = min(self.support_canvas)
        img, boxes = T.resize_shortest_edge(
            img, boxes, short, max(self.support_canvas))
        if train and rng.rand() < 0.5:
            img = img[:, ::-1]  # lazy view; the pad copy materializes it
            w = img.shape[1]
            boxes = np.stack([w - boxes[:, 2], boxes[:, 1],
                              w - boxes[:, 0], boxes[:, 3]], -1)
        # clip to the canvas (the resize may exceed it on one side)
        img = img[:self.support_canvas[0], :self.support_canvas[1]]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, img.shape[1])
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, img.shape[0])
        keep = ((boxes[:, 2] - boxes[:, 0]) > 1) & \
               ((boxes[:, 3] - boxes[:, 1]) > 1)
        if keep.any():
            boxes = boxes[keep]
        pick = rng.randint(len(boxes)) if train else 0
        sel = boxes[pick] if keep.any() else np.array(
            [0, 0, img.shape[1], img.shape[0]], np.float32)
        if self.fmt == "BGR":
            img = img[:, :, ::-1]
        return {
            "image": T.pad_to_canvas(img, self.support_canvas, out),
            "box": sel.astype(np.float32),
            "box_valid": bool(keep.any()),
        }

    # -------------------------------------------------------------- internals
    def _finalize(self, img, boxes, labels, canvas, out=None):
        h, w = img.shape[:2]
        ch, cw = canvas
        if h > ch or w > cw:  # safety clamp
            img = img[:ch, :cw]
            h, w = img.shape[:2]
            if boxes.size:
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        m = self.max_gt
        gt_boxes = np.zeros((m, 4), np.float32)
        gt_labels = np.zeros((m,), np.int32)
        gt_valid = np.zeros((m,), bool)
        n = min(len(boxes), m)
        if n:
            gt_boxes[:n] = boxes[:n]
            gt_labels[:n] = labels[:n]
            gt_valid[:n] = True
        if self.fmt == "BGR":
            img = img[:, :, ::-1]  # stride view; the pad copy materializes
        return {
            "image": T.pad_to_canvas(img, canvas, out),
            "image_size": np.asarray([h, w], np.int32),
            "gt_boxes": gt_boxes, "gt_labels": gt_labels,
            "gt_valid": gt_valid,
        }
