"""The ROIAlign kernel's CPU side (ops/roi_align_kernel.py, ops/roi_align.py).

Nothing here needs ``nvcc`` or a card: the module imports and checks its
arguments without either, the CPU path is the plain twin as it was, the
autograd Function (driven with the twin as its forward) gives the twin's
own gradients bit for bit, and the kernel's algorithm (each ROI at its own
level only, the separable tap tables, zero weights outside the map) is
rendered in plain PyTorch and held against the twin. chip_smoke.py holds
the CUDA kernel itself against the twin on the card.
"""

import math
import re

import numpy as np
import pytest
import torch

from sylph_tpu_torch.ops import roi_align_kernel
from sylph_tpu_torch.ops.roi_align import (assign_levels,
                                           multilevel_roi_align,
                                           multilevel_roi_align_plain,
                                           roi_align, roi_align_plain)

STRIDES = (4, 8, 16, 32, 64)
CANVAS = (96, 128)


def levels(rng, dtype=torch.float32, c=6, b=2, n_levels=4):
    return [torch.from_numpy(rng.randn(
        b, c, CANVAS[0] // s, CANVAS[1] // s).astype(np.float32)).to(dtype)
        for s in STRIDES[:n_levels]]


def rois(rng, n=24):
    """Boxes over every level, partly off the canvas, two degenerate, and
    the batch index and valid flags (two invalid)."""
    xy = rng.uniform(-20, 110, size=(n, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(160), size=(n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[0, 2] = boxes[0, 0]          # degenerate width
    boxes[1, 3] = boxes[1, 1] - 3.0    # inverted height
    valid = np.ones(n, bool)
    valid[[2, 5]] = False
    return (torch.from_numpy(boxes), torch.from_numpy(valid),
            torch.from_numpy(rng.randint(0, 2, size=n)).long())


def seed_multilevel(features, strides, boxes, valid, batch_idx, **opts):
    """The port's multilevel ROIAlign as it stood before the kernel: every
    level pooled, the assigned one kept."""
    min_level = int(math.log2(strides[0]))
    area = (torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0)
            * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0.0))
    target = torch.floor(4 + torch.log2(
        torch.sqrt(torch.clamp(area, min=1e-6)) / 224 + 1e-8))
    target = torch.clamp(target, min_level, min_level + len(features) - 1)
    pooled = torch.stack([roi_align_plain(f, boxes, batch_idx,
                                          spatial_scale=1.0 / s, **opts)
                          for f, s in zip(features, strides)])
    out = pooled[target.long() - min_level, torch.arange(boxes.shape[0])]
    return out * valid[:, None, None, None].to(out.dtype)


def kernel_rendering(features, strides, boxes, valid, batch_idx, *,
                     output_size, sampling_ratio=0, max_grid=4):
    """csrc/roi_align.cu's algorithm in plain PyTorch: each ROI at its own
    level only; per axis P*S positions as two taps with weights (0 outside
    the map); a bin's samples summed in (iy, ix) order in float32."""
    p = output_size
    s = sampling_ratio if sampling_ratio > 0 else max_grid
    lvl = assign_levels(boxes, strides, len(features))
    out = torch.zeros(boxes.shape[0], features[0].shape[1], p, p)
    for n in range(boxes.shape[0]):
        if not valid[n]:
            continue
        f = features[int(lvl[n])][int(batch_idx[n])].float()
        h, w = f.shape[1:]
        scale = torch.tensor(1.0 / strides[int(lvl[n])], dtype=torch.float32)
        x1, y1, x2, y2 = (boxes[n] * scale - 0.5).unbind()

        def axis(start, end, size):
            b = (end - start) / p
            if sampling_ratio > 0:
                g = s
            else:
                g = int(max(min(math.ceil(float(b)), s), 0))
            taps = []
            for pi in range(p):
                row = []
                for i in range(g):
                    off = (torch.tensor(i, dtype=torch.float32) + 0.5) \
                        / float(max(g, 1))
                    pos = start + (pi + off) * b
                    if not (-1.0 < float(pos) < size):
                        row.append((0, 0, 0.0, 0.0))
                        continue
                    c = min(max(float(pos), 0.0), size - 1)
                    lo = math.floor(c)
                    lw = torch.tensor(c, dtype=torch.float32) - lo
                    row.append((lo, min(lo + 1, size - 1), 1.0 - lw, lw))
                taps.append(row)
            return g, taps
        g_h, ty = axis(y1, y2, h)
        g_w, tx = axis(x1, x2, w)
        for ph in range(p):
            for pw in range(p):
                acc = torch.zeros(f.shape[0])
                for y0, y1i, wy0, wy1 in ty[ph]:
                    for x0, x1i, wx0, wx1 in tx[pw]:
                        acc = acc + (f[:, y0, x0] * wy0 * wx0
                                     + f[:, y0, x1i] * wy0 * wx1
                                     + f[:, y1i, x0] * wy1 * wx0
                                     + f[:, y1i, x1i] * wy1 * wx1)
                out[n, :, ph, pw] = acc / max(g_h * g_w, 1)
    return out


def test_module_imports_without_nvcc_or_card():
    """Nothing is built or loaded at import; the counters start at 0."""
    assert roi_align_kernel._fn is None
    assert isinstance(roi_align_kernel.LAUNCHES, int)
    assert isinstance(roi_align_kernel.ROIS, int)
    assert roi_align_kernel.SOURCE.exists()


def test_binding_matches_the_c_entry():
    """The ctypes argument types follow the C entry's parameters: a
    pointer (or the stream) for each ``*`` or ``cudaStream_t``, an int
    for each ``int``."""
    src = roi_align_kernel.SOURCE.read_text()
    params = re.search(r"sylph_roi_align_launch\(([^)]*)\)", src).group(1)
    kinds = [roi_align_kernel._P if ("*" in q or "Stream" in q)
             else roi_align_kernel._I for q in params.split(",")]
    assert kinds == roi_align_kernel._ARGTYPES


@pytest.mark.parametrize("case", ["cpu", "float16", "six_levels",
                                  "non_contiguous", "lattice"])
def test_cuda_entry_refuses(case):
    """The CUDA entry raises on what the kernel does not take; on the CPU
    it raises before any build."""
    rng = np.random.RandomState(0)
    feats = levels(rng)
    boxes, valid, bidx = rois(rng)
    lvl = torch.zeros_like(bidx)
    opts = dict(output_size=7)
    match = {"cpu": "CUDA device", "float16": "float32 or bfloat16",
             "six_levels": "1 to 5 levels", "non_contiguous": "contiguous",
             "lattice": "shared-memory plan"}[case]
    if case == "float16":
        feats = [f.half() for f in feats]
    elif case == "six_levels":
        feats = feats + feats[:2]
    elif case == "non_contiguous":
        feats[1] = feats[1].transpose(2, 3)
    elif case == "lattice":
        opts = dict(output_size=64, sampling_ratio=32)
    with pytest.raises(ValueError, match=match):
        roi_align_kernel.roi_align_cuda(
            feats, boxes, bidx, lvl, valid,
            [1.0 / s for s in STRIDES[:len(feats)]], **opts)
    assert roi_align_kernel._fn is None


@pytest.mark.parametrize("dtype,sampling_ratio,n_levels", [
    (torch.float32, 0, 4), (torch.bfloat16, 0, 4), (torch.float32, 2, 4),
    (torch.float32, 0, 5), (torch.float32, 0, 1)])
def test_cpu_path_keeps_the_seed_bits(dtype, sampling_ratio, n_levels):
    """On CPU tensors ``multilevel_roi_align`` is the twin as it was."""
    rng = np.random.RandomState(1)
    feats = levels(rng, dtype, n_levels=n_levels)
    boxes, valid, bidx = rois(rng)
    opts = dict(output_size=7, sampling_ratio=sampling_ratio)
    got = multilevel_roi_align(feats, STRIDES, boxes, valid, bidx, **opts)
    want = seed_multilevel(feats, STRIDES, boxes, valid, bidx, **opts)
    assert torch.equal(got, want)
    one = roi_align(feats[0], boxes, bidx, spatial_scale=0.25, **opts)
    assert torch.equal(one, roi_align_plain(feats[0], boxes, bidx,
                                            spatial_scale=0.25, **opts))


@pytest.mark.parametrize("dtype,sampling_ratio,max_grid", [
    (torch.float32, 0, 4), (torch.bfloat16, 0, 4), (torch.float32, 2, 4),
    (torch.float32, 0, 6)])
def test_kernel_algorithm_matches_the_twin(dtype, sampling_ratio, max_grid):
    """The kernel's algorithm, rendered in plain PyTorch, against the twin
    within 1e-5 x max |map| (the order of a bin's float32 sum)."""
    rng = np.random.RandomState(2)
    feats = levels(rng, dtype)
    boxes, valid, bidx = rois(rng)
    opts = dict(output_size=7, sampling_ratio=sampling_ratio,
                max_grid=max_grid)
    want = multilevel_roi_align_plain(feats, STRIDES, boxes, valid, bidx,
                                      **opts)
    got = kernel_rendering(feats, STRIDES, boxes, valid, bidx, **opts)
    top = max(float(f.float().abs().max()) for f in feats)
    assert float((got - want).abs().max()) <= 1e-5 * top
    assert torch.all(got[~valid] == 0)
    if sampling_ratio == 0:  # a fixed grid samples a degenerate edge too
        assert torch.all(got[0] == 0) and torch.all(got[1] == 0)


def _twin(valid, bidx, **opts):
    def twin(maps, bx):
        return multilevel_roi_align_plain(maps, STRIDES, bx, valid, bidx,
                                          **opts)
    return twin


@pytest.mark.parametrize("dtype,slices", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)])
def test_function_gradients_equal_the_twins(dtype, slices):
    """``KernelROIAlign`` with the twin as its forward: the maps' gradients
    equal the twin's own autograd bit for bit (per-image slices of maps
    that train, as the two-stage step passes them, included)."""
    rng = np.random.RandomState(3)
    full = [f.requires_grad_() for f in levels(rng, dtype)]
    boxes, valid, bidx = rois(rng)
    if slices:
        bidx = torch.zeros_like(bidx)
    maps = [f[1:2] for f in full] if slices else full
    twin = _twin(valid, bidx, output_size=7)
    grad = torch.from_numpy(rng.randn(boxes.shape[0], 6, 7, 7)
                            .astype(np.float32))
    out = roi_align_kernel.KernelROIAlign.apply(twin, twin, boxes, *maps)
    got = torch.autograd.grad(out, full, grad)
    want = torch.autograd.grad(twin(maps, boxes), full, grad)
    assert torch.equal(out, twin(maps, boxes).detach())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_function_without_grad_and_for_boxes():
    """No graph under no_grad or inference_mode; boxes that ask for a
    gradient raise."""
    rng = np.random.RandomState(4)
    feats = levels(rng)
    boxes, valid, bidx = rois(rng)
    twin = _twin(valid, bidx, output_size=7)
    want = twin(feats, boxes)
    for scope in (torch.no_grad, torch.inference_mode):
        with scope():
            out = roi_align_kernel.KernelROIAlign.apply(twin, twin, boxes,
                                                        *feats)
        assert not out.requires_grad and torch.equal(out, want)
    with pytest.raises(ValueError, match="boxes"):
        roi_align_kernel.KernelROIAlign.apply(
            twin, twin, boxes.clone().requires_grad_(), *feats)


@pytest.mark.parametrize("n,c,want", [
    (80, 256, 16), (1000, 256, 64), (8000, 256, 64), (10, 256, 8),
    (128, 256, 16), (1, 6, 6)])
def test_channel_slice_from_n(n, c, want):
    """80 ROIs still fill 132 SMs; 1000 and 8000 take the largest slice
    whose 7 x 7 output tile fits the shared-memory plan."""
    assert roi_align_kernel.channels_per_block(n, c, 7, 132) == want
