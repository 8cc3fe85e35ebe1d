"""Detections → COCO result records (the port's own copy of
sylph_tpu/evaluation/postprocess.py; it takes ``Detections.numpy()``).

Equivalent of detectron2's ``detector_postprocess`` + the evaluators'
instances→json conversion: rescale boxes from the resized canvas content
back to original image resolution, clip, drop padding, convert XYXY →
XYWH, and map contiguous ids back to dataset category ids.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..structures import Detections


def detections_to_coco_results(
    det: Detections,                # host arrays: Detections.numpy()
    image_ids: Sequence[int],
    image_sizes: np.ndarray,        # (B, 2) resized content (h, w)
    orig_sizes: np.ndarray,         # (B, 2) original (h, w)
    contiguous_to_dataset_id: Dict[int, int],
    batch_valid: np.ndarray = None,
    score_thresh: float = 0.0,
) -> List[dict]:
    boxes = np.asarray(det.boxes)
    scores = np.asarray(det.scores)
    classes = np.asarray(det.classes)
    valid = np.asarray(det.valid)
    b = boxes.shape[0]
    results = []
    for i in range(b):
        if batch_valid is not None and not batch_valid[i]:
            continue
        rh, rw = float(image_sizes[i][0]), float(image_sizes[i][1])
        oh, ow = float(orig_sizes[i][0]), float(orig_sizes[i][1])
        sx, sy = ow / max(rw, 1e-6), oh / max(rh, 1e-6)
        for k in range(boxes.shape[1]):
            if not valid[i, k] or scores[i, k] <= score_thresh:
                continue
            x1, y1, x2, y2 = boxes[i, k]
            x1, x2 = np.clip([x1 * sx, x2 * sx], 0, ow)
            y1, y2 = np.clip([y1 * sy, y2 * sy], 0, oh)
            if x2 <= x1 or y2 <= y1:
                continue
            cid = int(classes[i, k])
            results.append({
                "image_id": int(image_ids[i]),
                "category_id": contiguous_to_dataset_id.get(cid, cid),
                "bbox": [float(x1), float(y1), float(x2 - x1),
                         float(y2 - y1)],
                "score": float(scores[i, k]),
            })
    return results
