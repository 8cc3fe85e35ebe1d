"""Device-side color RandAugment, uint8 in and out (port of
sylph_tpu/ops/image_aug.py).

The host draws each image's op ids and parameters
(``data/transforms.py::draw_rand_augment``, the same rng stream as the host
path) and the pixels change on the card inside the train step. The host path
augments before padding, so every op acts on the content region of its
zero-padded canvas only: each image's ``(h, w)`` crop is transformed and
written back into a zeroed canvas. Within the crop each op reproduces the
Pillow algorithm of the host path, in the JAX package's float32 order of
operations, each multiply-add rounded once as XLA's fused multiply-add
rounds it (``_fma``):

  * autocontrast(cutoff=0): per-channel lut ``trunc(x*scale - lo*scale)``,
    identity when hi <= lo;
  * equalize: per-channel ``lut[i] = (step//2 + cumsum(h)[:i]) // step`` with
    ``step = (total - h[last nonzero bin]) // 255``, identity when step is 0
    (histogram by ``torch.bincount``, lut applied by a gather);
  * Color/Contrast/Brightness/Sharpness: ``Image.blend(degenerate, im,
    factor)`` with truncation, against ITU-R 601-2 L gray, the integer mean
    gray, black and the SMOOTH 3x3 filter (borders unfiltered);
  * posterize keeps the top ``bits`` bits; solarize inverts >= threshold.

The op ids and sizes stay on the host, so choosing an op never waits on the
card. Op ids index ``data/transforms.py::_COLOR_OPS``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_L_R, _L_G, _L_B = 19595, 38470, 7471  # Pillow convert.c L24 coefficients


def _gray_l(img: torch.Tensor) -> torch.Tensor:
    """Pillow convert("L") of an RGB (h, w, 3) float image -> int32 (h, w)."""
    x = img.to(torch.int32)
    l24 = _L_R * x[..., 0] + _L_G * x[..., 1] + _L_B * x[..., 2] + 0x8000
    return l24 >> 16


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA contracts it: the product
    of two float32 values is exact in float64. ``b`` may be a Python float
    holding a float32 value (no host-to-device copy)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def _blend(degenerate: torch.Tensor, img: torch.Tensor,
           factor: float) -> torch.Tensor:
    """Image.blend(degenerate, img, factor); Pillow truncates."""
    out = _fma(img - degenerate, float(np.float32(factor)), degenerate)
    return torch.clamp(torch.trunc(out), 0.0, 255.0)


def _autocontrast(img: torch.Tensor, _p: float) -> torch.Tensor:
    lo = img.amin(dim=(0, 1))
    hi = img.amax(dim=(0, 1))
    scale = 255.0 / torch.clamp(hi - lo, min=1.0)
    offset = -lo * scale
    mapped = torch.clamp(torch.trunc(_fma(img, scale, offset)), 0.0, 255.0)
    return torch.where(hi <= lo, img, mapped)


def _equalize(img: torch.Tensor, _p: float) -> torch.Tensor:
    h, w, _ = img.shape
    x = img.to(torch.int64)
    chan = torch.arange(3, device=img.device) * 256
    hist = torch.bincount((x + chan).reshape(-1),
                          minlength=768).reshape(3, 256)
    nonzero = hist > 0
    last_idx = 255 - torch.argmax(nonzero.flip(1).to(torch.int32), dim=1)
    step = (h * w - hist.gather(1, last_idx[:, None])[:, 0]) // 255
    csum = torch.cumsum(hist, dim=1) - hist           # exclusive
    lut = torch.clamp((step[:, None] // 2 + csum)
                      // torch.clamp(step[:, None], min=1), 0, 255)
    mapped = lut.reshape(-1)[(x + chan).reshape(-1)].reshape(x.shape)
    return torch.where(step <= 0, x, mapped).to(img.dtype)


def _color(img: torch.Tensor, factor: float) -> torch.Tensor:
    gray = _gray_l(img).to(torch.float32)[..., None]
    return _blend(gray.expand_as(img), img, factor)


def _contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    total = img.shape[0] * img.shape[1]
    s = _gray_l(img).to(torch.int64).sum()
    # int(mean + 0.5) in exact integer arithmetic: (2s + t) // 2t
    mean = ((2 * s + total) // (2 * total)).to(torch.float32)
    return _blend(torch.full_like(img, 0.0) + mean, img, factor)


def _brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    return _blend(torch.zeros_like(img), img, factor)


def _sharpness(img: torch.Tensor, factor: float) -> torch.Tensor:
    p = F.pad(img.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)
    acc = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
           + p[1:-1, :-2] + 5.0 * p[1:-1, 1:-1] + p[1:-1, 2:]
           + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:])
    sm = torch.clamp(torch.floor(acc / 13.0 + 0.5), 0.0, 255.0)
    degenerate = img.clone()
    degenerate[1:-1, 1:-1] = sm[1:-1, 1:-1]
    return _blend(degenerate, img, factor)


def _posterize(img: torch.Tensor, bits: float) -> torch.Tensor:
    q = float(2.0 ** (8.0 - float(bits)))  # exact power of two
    return torch.floor(img / q) * q


def _solarize(img: torch.Tensor, threshold: float) -> torch.Tensor:
    t = float(np.float32(threshold))
    return torch.where(img < t, img, 255.0 - img)


# order == data/transforms.py::_COLOR_OPS
_OPS = (_autocontrast, _equalize, _color, _contrast, _brightness,
        _sharpness, _posterize, _solarize)


def rand_augment_device(images: torch.Tensor, op_ids, params, image_sizes,
                        bgr: bool = True) -> torch.Tensor:
    """images (B, H, W, 3) uint8 zero-padded canvases on any device; op_ids
    (B, n) and params (B, n) as drawn on the host; image_sizes (B, 2)
    content (h, w). ``bgr``: the canvases are model-input BGR, so channels
    are reversed around the ops (the gray-based ops need RGB). Returns a new
    uint8 tensor with the padding zeroed."""
    ids = np.asarray(op_ids)
    ps = np.asarray(params, np.float32)
    hw = np.asarray(image_sizes.cpu() if isinstance(image_sizes,
                                                    torch.Tensor)
                    else image_sizes)
    out = torch.zeros_like(images)
    for b in range(images.shape[0]):
        h, w = int(hw[b, 0]), int(hw[b, 1])
        x = images[b, :h, :w]
        if bgr:
            x = x.flip(-1)
        x = x.to(torch.float32)
        for i, p in zip(ids[b], ps[b]):
            x = _OPS[int(i)](x, float(p))
        x = torch.clamp(x, 0.0, 255.0).to(torch.uint8)
        out[b, :h, :w] = x.flip(-1) if bgr else x
    return out
