"""Host-side image transforms for serving (port of the two eval-path
functions of sylph_tpu/data/transforms.py).

Both return numpy arrays; the device sees only the fixed canvas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


def resize_shortest_edge(img: np.ndarray, boxes: np.ndarray,
                         short: int, max_size: int):
    """detectron2 ResizeShortestEdge semantics (PIL bilinear)."""
    h, w = img.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pil = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    return np.asarray(pil), boxes * scale


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to the static canvas (ImageList semantics).

    ``img`` may be any strided view (a channel reversal, say): the single
    assignment materializes it.
    """
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    assert h <= ch and w <= cw, (img.shape, canvas_hw)
    out = np.zeros((ch, cw, 3), img.dtype)
    out[:h, :w] = img
    return out
