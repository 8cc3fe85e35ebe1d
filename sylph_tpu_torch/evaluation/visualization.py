"""Episode visualization (the port's own copy of
sylph_tpu/evaluation/visualization.py; reference
evaluation/visualization.py:13-69 and evaluation/evaluation.py:13-48 log
support and query images to TensorBoard).

Renders an episodic batch — support crops with their selected box and the
query image with GT — into a single PNG row for quick inspection (no TB
dependency; files drop into OUTPUT_DIR/vis). The batch's arrays may be numpy
arrays or tensors on any device: they are copied to the host first."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from PIL import Image, ImageDraw


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _to_uint8(img, fmt: str = "BGR") -> np.ndarray:
    img = np.clip(_host(img).astype(np.float32), 0, 255).astype(np.uint8)
    if fmt == "BGR":
        img = img[:, :, ::-1]
    return img


def _draw_boxes(img: np.ndarray, boxes, valid=None, color=(0, 255, 0)):
    pil = Image.fromarray(img)
    d = ImageDraw.Draw(pil)
    for i, b in enumerate(_host(boxes).reshape(-1, 4)):
        if valid is not None and not valid[i]:
            continue
        d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                    outline=color, width=2)
    return np.asarray(pil)


def visualize_episode(batch: Dict[str, np.ndarray], out_path: str,
                      episode: int = 0, num_shots: int = 5,
                      fmt: str = "BGR") -> Optional[str]:
    """Save one episode (its support shots + first query) as a PNG row."""
    sup = batch["support_images"][episode * num_shots:
                                  (episode + 1) * num_shots]
    sboxes = batch["support_boxes"][episode * num_shots:
                                    (episode + 1) * num_shots]
    qry = batch["query_images"][episode]
    qboxes = batch["query_gt_boxes"][episode]
    qvalid = _host(batch["query_gt_valid"][episode])

    tiles = [
        _draw_boxes(_to_uint8(im, fmt), bx[None])
        for im, bx in zip(sup, sboxes)
    ]
    qimg = _draw_boxes(_to_uint8(qry, fmt), qboxes, qvalid,
                       color=(255, 64, 64))
    h = max(max(t.shape[0] for t in tiles), qimg.shape[0])
    pad = lambda t: np.pad(t, ((0, h - t.shape[0]), (0, 4), (0, 0)))  # noqa
    row = np.concatenate([pad(t) for t in tiles] + [pad(qimg)], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    Image.fromarray(row).save(out_path)
    return out_path
