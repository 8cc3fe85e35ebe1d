"""Build, bind and launch the hand-written Hopper NMS kernel (csrc/nms.cu).

The kernel replaces sylph_tpu/ops/nms_pallas.py::_nms_kernel. At first use
``build()`` compiles ``csrc/nms.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``sylph_tpu_torch/_build/``
(named by a hash of the source and flags), and loads it with ``ctypes``.
Nothing here touches ``nvcc`` or the loader at import time, so CPU-only
installs import the module freely.

``nms_cuda`` takes CUDA tensors only and raises on anything else, on a
failed build and on a failed launch: there is no fallback. ``LAUNCHES``
counts the launches, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nms.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# The card's per-block shared-memory ceiling (227 KB) less room for the
# kernel's static shared arrays; the planes take 24 bytes per candidate.
MAX_DYNAMIC_SMEM = 232448 - 1024
SMEM_BYTES_PER_CANDIDATE = 24

LAUNCHES = 0
BUILD_LOG = ""
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the NMS kernel is built from "
                       f"{SOURCE} on a machine with the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libsylph_nms_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn = lib.sylph_nms_launch
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


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


def nms_cuda(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
             y2: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, max_outputs: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS, one block per image, on (B, K) class-offset box planes.

    x1, y1, x2, y2, scores: (B, K) float32; valid: (B, K) int32 (0 / 1).
    Returns (idx, ok), each (B, max_outputs) int32: the picks in order,
    index 0 and ok 0 after the last one.
    """
    global LAUNCHES
    if x1.dim() != 2:
        raise ValueError(f"nms_cuda: planes must be (B, K), got "
                         f"{tuple(x1.shape)}")
    b, k = x1.shape
    if k < 1:
        raise ValueError("nms_cuda: needs at least one candidate")
    if max_outputs < 0:
        raise ValueError(f"nms_cuda: max_outputs {max_outputs} < 0")
    smem = SMEM_BYTES_PER_CANDIDATE * k
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"nms_cuda: K={k} needs {smem} B of shared memory, "
                         f"more than the {MAX_DYNAMIC_SMEM} B a block has")
    for name, t in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2),
                    ("scores", scores)):
        _check(name, t, torch.float32, (b, k))
    _check("valid", valid, torch.int32, (b, k))
    device = x1.device
    if any(t.device != device for t in (y1, x2, y2, scores, valid)):
        raise ValueError("nms_cuda: all inputs must be on one device")

    lib = build()
    idx = torch.empty((b, max_outputs), dtype=torch.int32, device=device)
    ok = torch.empty((b, max_outputs), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sylph_nms_launch(
            x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
            scores.data_ptr(), valid.data_ptr(), b, k, max_outputs,
            float(iou_threshold), idx.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return idx, ok
