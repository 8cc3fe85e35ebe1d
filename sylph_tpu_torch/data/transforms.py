"""Host-side image transforms (numpy/PIL; port of
sylph_tpu/data/transforms.py).

  * ``resize_shortest_edge`` — eval resize (min 800 / max 1333);
  * ``resize_scale_crop`` (``resize_scale`` + ``fixed_size_crop``) —
    train-time scale jitter (0.5-2.0) into the train canvas;
  * ``hflip`` — horizontal flip;
  * ``draw_rand_augment`` / ``apply_color_op`` / ``rand_augment_color`` —
    color-only RandAugment, drawn on the host; applied on the host or, with
    the drawn ids, on the card (``ops/image_aug.py``).

All return numpy arrays; the device sees only the fixed canvas.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps


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


def resize_scale(img: np.ndarray, boxes: np.ndarray, scale: float,
                 target_hw: Tuple[int, int]):
    """ResizeScaleOp: resize so the image fits scale * target canvas."""
    h, w = img.shape[:2]
    th, tw = target_hw
    out_scale = scale * min(th / h, tw / w)
    nh, nw = int(round(h * out_scale)), int(round(w * out_scale))
    pil = Image.fromarray(img).resize((max(nw, 1), max(nh, 1)),
                                      Image.BILINEAR)
    return np.asarray(pil), boxes * out_scale


def resize_scale_crop(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                      scale: float, target_hw: Tuple[int, int],
                      rng: np.random.RandomState):
    """``resize_scale`` + ``fixed_size_crop`` fused via PIL box-resize: the
    same bilinear samples and the same rng stream as the two-step pipeline
    (crop offset drawn in output coordinates, y then x) without the scaled
    intermediate (PIL maps ``box`` linearly onto the output)."""
    h, w = img.shape[:2]
    th, tw = target_hw
    out_scale = scale * min(th / h, tw / w)
    nh = max(int(round(h * out_scale)), 1)
    nw = max(int(round(w * out_scale)), 1)
    y0 = rng.randint(0, max(nh - th, 0) + 1)
    x0 = rng.randint(0, max(nw - tw, 0) + 1)
    ch, cw = min(th, nh), min(tw, nw)
    sx, sy = w / nw, h / nh  # output -> source
    src_box = (x0 * sx, y0 * sy, (x0 + cw) * sx, (y0 + ch) * sy)
    pil = Image.fromarray(np.ascontiguousarray(img)).resize(
        (cw, ch), Image.BILINEAR, box=src_box)
    img = np.asarray(pil)
    if boxes.size:
        boxes = boxes * out_scale - np.array([x0, y0, x0, y0], np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
        keep = ((boxes[:, 2] - boxes[:, 0]) > 1e-3) & \
               ((boxes[:, 3] - boxes[:, 1]) > 1e-3)
        boxes, labels = boxes[keep], labels[keep]
    return img, boxes, labels


def fixed_size_crop(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    crop_hw: Tuple[int, int], rng: np.random.RandomState):
    """Random crop (or pass-through when smaller) to crop_hw; boxes are
    shifted+clipped, fully-cropped-out boxes dropped."""
    h, w = img.shape[:2]
    ch, cw = crop_hw
    y0 = rng.randint(0, max(h - ch, 0) + 1)
    x0 = rng.randint(0, max(w - cw, 0) + 1)
    img = img[y0:y0 + ch, x0:x0 + cw]
    if boxes.size:
        boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, img.shape[1])
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, img.shape[0])
        keep = ((boxes[:, 2] - boxes[:, 0]) > 1e-3) & \
               ((boxes[:, 3] - boxes[:, 1]) > 1e-3)
        boxes, labels = boxes[keep], labels[keep]
    return img, boxes, labels


def hflip(img: np.ndarray, boxes: np.ndarray):
    img = img[:, ::-1]
    if boxes.size:
        w = img.shape[1]
        x1 = w - boxes[:, 2]
        x2 = w - boxes[:, 0]
        boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], -1)
    return np.ascontiguousarray(img), boxes


_COLOR_OPS = ("autocontrast", "equalize", "color", "contrast",
              "brightness", "sharpness", "posterize", "solarize")
# op-id order is shared with ops/image_aug.py::_OPS


def draw_rand_augment(rng: np.random.RandomState, n: int = 2,
                      magnitude: float = 9.0, magnitude_std: float = 0.5):
    """Draw RandAugment op ids + resolved parameters (no pixels touched).

    Same rng stream as the in-place host path, so host and device
    augmentation are swappable without changing data order. Parameters
    are fully resolved here (posterize bits, solarize threshold,
    enhancement factor) — the device kernel only switches and applies.
    """
    ids = rng.choice(len(_COLOR_OPS), n, replace=False).astype(np.int32)
    params = np.zeros((n,), np.float32)
    for j, op in enumerate(ids):
        m = float(np.clip(rng.normal(magnitude, magnitude_std), 0, 10)) / 10.0
        name = _COLOR_OPS[op]
        if name == "posterize":
            params[j] = max(1, int(8 - 4 * m))
        elif name == "solarize":
            params[j] = int(256 * (1 - m))
        elif name in ("color", "contrast", "brightness", "sharpness"):
            params[j] = 1.0 + (m - 0.5)
    return ids, params


def apply_color_op(pil: Image.Image, name: str, param: float) -> Image.Image:
    """Apply one drawn color op on host (PIL reference implementation)."""
    if name == "autocontrast":
        return ImageOps.autocontrast(pil)
    if name == "equalize":
        return ImageOps.equalize(pil)
    if name == "posterize":
        return ImageOps.posterize(pil, int(param))
    if name == "solarize":
        return ImageOps.solarize(pil, int(param))
    enh = {"color": ImageEnhance.Color,
           "contrast": ImageEnhance.Contrast,
           "brightness": ImageEnhance.Brightness,
           "sharpness": ImageEnhance.Sharpness}[name]
    return enh(pil).enhance(param)


def rand_augment_color(img: np.ndarray, rng: np.random.RandomState,
                       n: int = 2, magnitude: float = 9.0,
                       magnitude_std: float = 0.5) -> np.ndarray:
    """Color-only RandAugment (geometry handled by scale/crop/flip)."""
    ids, params = draw_rand_augment(rng, n, magnitude, magnitude_std)
    pil = Image.fromarray(img)
    for op, p in zip(ids, params):
        pil = apply_color_op(pil, _COLOR_OPS[op], float(p))
    return np.asarray(pil)


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int],
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Zero-pad bottom/right to the static canvas (ImageList semantics).

    ``img`` may be any strided view (a channel reversal, say): the single
    assignment materializes it. ``out`` (the canvas's shape and dtype)
    receives the result in place: the loaders pass slots of a reused batch
    buffer (``data/loader.py::_BufferPool``).
    """
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    assert h <= ch and w <= cw, (img.shape, canvas_hw)
    if out is None:
        out = np.zeros((ch, cw, 3), img.dtype)
    else:
        assert out.shape == (ch, cw, 3), (out.shape, canvas_hw)
        out[h:] = 0
        out[:h, w:] = 0
    out[:h, :w] = img
    return out
