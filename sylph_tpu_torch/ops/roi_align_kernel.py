"""Build, bind and launch the hand-written Hopper ROIAlign (csrc/roi_align.cu).

The kernel replaces no Pallas kernel: the JAX package's ROIAlign is XLA
gathers, and ``ops/roi_align.py`` keeps the same arithmetic in plain
PyTorch as this kernel's twin. At first use ``build()`` compiles
``csrc/roi_align.cu`` with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``sylph_tpu_torch/_build/`` (named by a hash
of the source and flags) and loads it with ``ctypes``. The library links
the shared CUDA runtime, the one torch has loaded, so the profiler ties each
launch to the host op that made it. Nothing here touches ``nvcc`` or the
loader at import time.

``roi_align_cuda`` takes CUDA tensors only and raises on anything else, on a
failed build and on a failed launch: there is no fallback. One call is one
launch on the current stream, which pools each ROI at its own level only,
reading the level maps as they lie (bf16 or float32, dense NCHW or
channels-last, as the detector's are, per-image slices included; through
their strides, with no copy) and writing (N, C, P, P) float32.
``KernelROIAlign`` gives it a gradient: the backward recomputes the twin
under autograd and returns the twin's gradient with respect to the maps,
which does not depend on the forward's values (ROIAlign is linear in the
maps), so training keeps its bits.

``LAUNCHES`` counts the launches and ``ROIS`` the ROIs they pooled (from the
shapes, no read back), so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Sequence

import torch

from .nms_kernel import BUILD_DIR, _nvcc

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "roi_align.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC", "-cudart", "shared")
MAX_LEVELS = 5
# The shared-memory plan (48 KB a block): two taps and their weights (16
# bytes) for each of the P * S sample positions on each axis, and a tile of
# the block's C-slice x P * P float32 outputs.
MAX_AXIS_SAMPLES = 1024
MAX_TILE_BYTES = 16384
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks a launch aims at: two waves of 8 resident 256-thread blocks on
# every SM. A block's channel slice halves while the launch stays under it,
# down to MIN_CHANNELS.
BLOCKS_PER_SM = 16
MIN_CHANNELS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I] + [_P] * 10 + [_I] * 7 + [_P, _P]

LAUNCHES = 0
ROIS = 0
BUILD_LOG = ""
_fn = None
_sms = {}


def _library() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsylph_roi_align_{tag}.so"


def build():
    """Compile if missing (once per source hash), load, and return the
    launch function."""
    global _fn, BUILD_LOG
    if _fn is not None:
        return _fn
    out = _library()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        rpath = Path(nvcc).resolve().parent.parent / "lib64"
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, f"-Xlinker=-rpath={rpath}", "-o", str(tmp),
             str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        BUILD_LOG = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, out)
    fn = ctypes.CDLL(str(out)).sylph_roi_align_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def channels_per_block(n: int, c: int, p: int, sms: int) -> int:
    """The channel slice a block pools for one ROI: the largest whose
    output tile (slice x P * P float32) fits ``MAX_TILE_BYTES``, halved
    while N x slices stays within ``BLOCKS_PER_SM`` blocks an SM and the
    slice divides C and keeps ``MIN_CHANNELS``."""
    slices = 1
    while (c // slices) * p * p * 4 > MAX_TILE_BYTES and c % (slices * 2) == 0:
        slices *= 2
    if (c // slices) * p * p * 4 > MAX_TILE_BYTES:
        raise ValueError(f"roi_align_cuda: no slice of C={c} channels x P={p}"
                         f"^2 fits the shared-memory plan's {MAX_TILE_BYTES} "
                         "B tile")
    while (n * slices * 2 <= BLOCKS_PER_SM * sms and c % (slices * 2) == 0
           and c // (slices * 2) >= MIN_CHANNELS):
        slices *= 2
    return c // slices


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def _check_maps(features: Sequence[torch.Tensor]):
    """Raise on maps the kernel does not take -> (dtype, C)."""
    if not 1 <= len(features) <= MAX_LEVELS:
        raise ValueError(f"roi_align_cuda: takes 1 to {MAX_LEVELS} levels, "
                         f"got {len(features)}")
    dtype, c = features[0].dtype, features[0].shape[1]
    if dtype not in DTYPES:
        raise ValueError(f"roi_align_cuda: maps must be float32 or bfloat16, "
                         f"got {dtype}")
    for i, f in enumerate(features):
        if f.dim() != 4 or f.shape[1] != c or f.dtype != dtype:
            raise ValueError(f"roi_align_cuda: level {i} must be (B, {c}, H, "
                             f"W) {dtype}, got {tuple(f.shape)} {f.dtype}")
        if not (f.is_contiguous() or f.is_contiguous(
                memory_format=torch.channels_last)):
            raise ValueError(f"roi_align_cuda: level {i} must be contiguous, "
                             "NCHW or channels-last")
    return dtype, c


def roi_align_cuda(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   batch_idx: torch.Tensor, level_idx: torch.Tensor,
                   valid: torch.Tensor, scales: Sequence[float], *,
                   output_size: int, sampling_ratio: int = 0,
                   max_grid: int = 4) -> torch.Tensor:
    """Pool each ROI at its level in one launch.

    features: up to 5 (B_l, C, H_l, W_l) maps, float32 or bf16, contiguous
    NCHW or channels-last; boxes (N, 4) XYXY image coordinates; batch_idx,
    level_idx (N,) int64; valid (N,) bool; scales: each level's 1 / stride.
    Returns (N, C, P, P) float32, zeros where ``valid`` is false or the
    batch index lies outside the level's maps.
    """
    global LAUNCHES, ROIS
    dtype, c = _check_maps(features)
    n, p = boxes.shape[0], output_size
    s = sampling_ratio if sampling_ratio > 0 else max_grid
    if len(scales) != len(features):
        raise ValueError("roi_align_cuda: one scale per level")
    if p < 1 or s < 1 or p * s > MAX_AXIS_SAMPLES:
        raise ValueError(f"roi_align_cuda: P={p} x S={s} sample positions an "
                         f"axis; the shared-memory plan holds 1 to "
                         f"{MAX_AXIS_SAMPLES}")
    device = boxes.device
    if not boxes.is_cuda or any(f.device != device for f in features):
        where = [str(f.device) for f in features]
        raise ValueError(f"roi_align_cuda: maps and boxes must lie on one "
                         f"CUDA device, got {where} and {device}")
    if boxes.shape != (n, 4):
        raise ValueError(f"roi_align_cuda: boxes must be (N, 4), got "
                         f"{tuple(boxes.shape)}")
    for name, t, want in (("batch_idx", batch_idx, torch.int64),
                          ("level_idx", level_idx, torch.int64),
                          ("valid", valid, torch.bool)):
        if t.device != device or t.dtype != want or t.shape != (n,):
            raise ValueError(f"roi_align_cuda: {name} must be ({n},) {want} "
                             f"on {device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    cpb = channels_per_block(n, c, p, _sm_count(device))
    boxes = boxes.float().contiguous()
    batch_idx, level_idx, valid = (t.contiguous()
                                   for t in (batch_idx, level_idx, valid))
    out = torch.empty((n, c, p, p), dtype=torch.float32, device=device)
    if n == 0:
        return out
    fn = build()
    levels = len(features)
    data = (ctypes.c_uint64 * levels)(*(f.data_ptr() for f in features))
    batch = (ctypes.c_int * levels)(*(f.shape[0] for f in features))
    height = (ctypes.c_int * levels)(*(f.shape[2] for f in features))
    width = (ctypes.c_int * levels)(*(f.shape[3] for f in features))
    strides = (ctypes.c_int64 * (4 * levels))(
        *(st for f in features for st in f.stride()))
    scale = (ctypes.c_float * levels)(*scales)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(DTYPES[dtype], levels, data, batch, height, width, strides,
                 scale, boxes.data_ptr(), batch_idx.data_ptr(),
                 level_idx.data_ptr(), valid.data_ptr(), n, c, p, s,
                 sampling_ratio, max_grid, cpb, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ROIAlign kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    ROIS += n
    return out


Pool = Callable[[Sequence[torch.Tensor], torch.Tensor], torch.Tensor]


class KernelROIAlign(torch.autograd.Function):
    """``forward(maps, boxes)`` with the gradient of ``twin(maps, boxes)``
    with respect to the maps: the backward runs the twin again under
    autograd. The boxes take no gradient; asking for one raises.

    ``KernelROIAlign.apply(forward, twin, boxes, *maps)``.
    """

    @staticmethod
    def forward(ctx, forward: Pool, twin: Pool, boxes: torch.Tensor,
                *maps: torch.Tensor) -> torch.Tensor:
        if ctx.needs_input_grad[2]:
            raise ValueError("ROIAlign takes no gradient with respect to the "
                             "boxes: pass detached boxes")
        ctx.twin = twin
        ctx.save_for_backward(boxes, *maps)
        return forward(maps, boxes)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        boxes, *maps = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        leaves = [m.detach().requires_grad_(w) for m, w in zip(maps, need)]
        with torch.enable_grad():
            out = ctx.twin(leaves, boxes)
        grads = iter(torch.autograd.grad(
            out, [m for m, w in zip(leaves, need) if w], grad))
        return (None, None, None,
                *(next(grads) if w else None for w in need))

