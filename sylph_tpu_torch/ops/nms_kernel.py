"""Build, bind and launch the hand-written Hopper NMS kernel (csrc/nms.cu).

The kernel replaces sylph_tpu/ops/nms_pallas.py::_nms_kernel. At first use
``build()`` compiles ``csrc/nms.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``sylph_tpu_torch/_build/``
(named by a hash of the source and flags), and loads it with ``ctypes``.
Nothing here touches ``nvcc`` or the loader at import time, so CPU-only
installs import the module freely.

``nms_cuda`` takes CUDA tensors only and raises on anything else, on a
failed build and on a failed launch: there is no fallback. One call launches
two kernels on the current stream, ``rank_kernel`` (orders the alive
candidates once, over a grid of blocks) and then ``scan_kernel`` (one block
per image walks the ranked list in chunks of 64); the scratch between them
is allocated here with ``torch.empty``. ``LAUNCHES`` counts the calls (one
per image batch, each launching both kernels), so a run can show that its
path went through the kernel.

``nms_cuda_greedy`` runs the kernel's first design (``csrc/nms_greedy.cu``,
one block-wide argmax step per pick) on the same arguments. It is the
yardstick chip_smoke.py times the kernel against; no path calls it and it
adds to no count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"nms": _PKG / "csrc" / "nms.cu",
           "nms_greedy": _PKG / "csrc" / "nms_greedy.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# The card's per-block shared-memory ceiling (227 KB) less room for the
# kernels' static shared arrays (under 4 KB). rank_kernel holds one 4-byte
# order key per candidate (K <= 57,088); scan_kernel holds the kept boxes,
# 20 bytes for each of min(M, K).
MAX_DYNAMIC_SMEM = 232448 - 4096
SMEM_BYTES_PER_CANDIDATE = 4
SMEM_BYTES_PER_PICK = 20
GREEDY_SMEM_BYTES_PER_CANDIDATE = 24  # the first design's six planes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# symbol, argument types: 6 input planes, B, K, M, threshold, then outputs,
# scratch and the stream
_BINDINGS = {"nms": ("sylph_nms_launch", [_P] * 6 + [_I] * 3 + [_F]
                     + [_P] * 6),
             "nms_greedy": ("sylph_nms_greedy_launch",
                            [_P] * 6 + [_I] * 3 + [_F] + [_P] * 3)}

LAUNCHES = 0
BUILD_LOG = {}  # source name -> nvcc's output
_fns = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the NMS kernels are built from "
                       f"{_PKG / 'csrc'} on a machine with the CUDA toolkit")


def _library(name: str) -> Path:
    tag = hashlib.sha1(SOURCES[name].read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsylph_{name}_{tag}.so"


def build(names: Sequence[str] = ("nms",)):
    """Compile what is missing (once per source hash; one ``nvcc`` per
    source, all started together), load, and return the launch function
    of the first name."""
    if all(name in _fns for name in names):
        return _fns[names[0]]
    procs = {}
    for name in names:
        out = _library(name)
        if name in _fns or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, _, proc) in procs.items():  # wait for every one first
        BUILD_LOG[name] = proc.communicate()[0]
    for name, (tmp, out, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n"
                               f"{BUILD_LOG[name]}")
        os.replace(tmp, out)
    for name in names:
        if name not in _fns:
            symbol, argtypes = _BINDINGS[name]
            fn = getattr(ctypes.CDLL(str(_library(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return _fns[names[0]]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"nms_cuda: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"nms_cuda: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"nms_cuda: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"nms_cuda: {name} must be contiguous")


def _check_inputs(x1, y1, x2, y2, scores, valid, max_outputs: int,
                  smem) -> Tuple[int, int]:
    """Raise on what the kernels do not take; ``smem(k)`` is the dynamic
    shared memory a block needs. Returns (B, K)."""
    if x1.dim() != 2:
        raise ValueError(f"nms_cuda: planes must be (B, K), got "
                         f"{tuple(x1.shape)}")
    b, k = x1.shape
    if k < 1:
        raise ValueError("nms_cuda: needs at least one candidate")
    if max_outputs < 0:
        raise ValueError(f"nms_cuda: max_outputs {max_outputs} < 0")
    if smem(k) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"nms_cuda: K={k}, M={max_outputs} needs {smem(k)} "
                         f"B of shared memory, more than the "
                         f"{MAX_DYNAMIC_SMEM} B a block has")
    for name, t in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2),
                    ("scores", scores)):
        _check(name, t, torch.float32, (b, k))
    _check("valid", valid, torch.int32, (b, k))
    if any(t.device != x1.device for t in (y1, x2, y2, scores, valid)):
        raise ValueError("nms_cuda: all inputs must be on one device")
    return b, k


def _launch(fn, planes, b: int, max_outputs: int, iou_threshold: float,
            *scratch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch on the current stream; ``scratch`` holds device addresses."""
    device = planes[0].device
    out = torch.empty((2, b, max_outputs), dtype=torch.int32, device=device)
    idx, ok = out[0], out[1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in planes), b, planes[0].shape[1],
                 max_outputs, float(iou_threshold), idx.data_ptr(),
                 ok.data_ptr(), *scratch, stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    return idx, ok


def nms_cuda(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
             y2: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, max_outputs: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS on (B, K) class-offset box planes: rank, then a chunked
    scan with one block per image.

    x1, y1, x2, y2, scores: (B, K) float32; valid: (B, K) int32 (0 / 1).
    Returns (idx, ok), each (B, max_outputs) int32: the picks in order,
    index 0 and ok 0 after the last one.
    """
    global LAUNCHES
    b, k = _check_inputs(
        x1, y1, x2, y2, scores, valid, max_outputs,
        lambda k: max(SMEM_BYTES_PER_CANDIDATE * k,
                      SMEM_BYTES_PER_PICK * min(max_outputs, k)))
    fn = build()
    # scratch, in one allocation: the ranked boxes (B, K) x (x1, y1, x2, y2)
    # float32, their indices (B, K) and the alive counts (B,), int32
    scratch = torch.empty(b * k * 5 + b, dtype=torch.int32, device=x1.device)
    ptr = scratch.data_ptr()
    out = _launch(fn, (x1, y1, x2, y2, scores, valid), b, max_outputs,
                  iou_threshold, ptr, ptr + 16 * b * k, ptr + 20 * b * k)
    LAUNCHES += 1
    return out


def nms_cuda_greedy(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                    y2: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float,
                    max_outputs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_cuda``'s function by the first design (one block per image,
    one argmax step per pick); the yardstick, not on any path."""
    b, _ = _check_inputs(x1, y1, x2, y2, scores, valid, max_outputs,
                         lambda k: GREEDY_SMEM_BYTES_PER_CANDIDATE * k)
    fn = build(("nms_greedy",))
    return _launch(fn, (x1, y1, x2, y2, scores, valid), b, max_outputs,
                   iou_threshold)
