"""Build, bind and launch the hand-written Hopper NMS kernel (csrc/nms.cu).

The kernel replaces sylph_tpu/ops/nms_pallas.py::_nms_kernel. At first use
``build()`` compiles ``csrc/nms.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``sylph_tpu_torch/_build/``
(named by a hash of the source and flags), and loads it with ``ctypes``.
Nothing here touches ``nvcc`` or the loader at import time, so CPU-only
installs import the module freely.

``nms_cuda`` takes CUDA tensors only and raises on anything else, on a
failed build and on a failed launch: there is no fallback. One call ranks
the alive candidates once and then launches ``scan_kernel`` (one block per
image walks the ranked list in chunks of 64), on the current stream; the
scratch between them is allocated here with ``torch.empty``. The ranking
route is chosen by K alone (``select_route``):

  * ``"count"`` (K <= ``COUNT_ROUTE_MAX_K``): ``rank_kernel`` orders by
    counting, with every key in shared memory;
  * ``"radix"`` (larger K, the two-stage ROI stage): a stable radix sort of
    the order keys from global memory, four passes of three kernels.

``LAUNCHES`` counts the calls (one per image batch) and ``LAUNCHES_BY_ROUTE``
the same calls by route, so a run can show that its path went through the
kernel and which route its shapes took.

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
# order key per candidate (K <= 57,088), past which the radix route ranks;
# scan_kernel holds the kept boxes, 20 bytes for each of min(M, K).
MAX_DYNAMIC_SMEM = 232448 - 4096
SMEM_BYTES_PER_CANDIDATE = 4
SMEM_BYTES_PER_PICK = 20
COUNT_ROUTE_MAX_K = MAX_DYNAMIC_SMEM // SMEM_BYTES_PER_CANDIDATE
GREEDY_SMEM_BYTES_PER_CANDIDATE = 24  # the first design's six planes
SORT_TILE = 2048    # candidates per block of a radix pass (kSortTile)
RADIX_DIGITS = 256  # 8-bit digits (kDigits)
MAX_K = 2 ** 31 - 1 - SORT_TILE  # int32 element indices within an image
MAX_B = 65535                    # the grid's y extent

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# per source, per entry: symbol, argument types (6 input planes, B, K, M,
# threshold, then outputs, scratch and the stream)
_BINDINGS = {"nms": {"count": ("sylph_nms_launch",
                               [_P] * 6 + [_I] * 3 + [_F] + [_P] * 6),
                     "radix": ("sylph_nms_radix_launch",
                               [_P] * 6 + [_I] * 3 + [_F] + [_P] * 11)},
             "nms_greedy": {"greedy": ("sylph_nms_greedy_launch",
                                       [_P] * 6 + [_I] * 3 + [_F]
                                       + [_P] * 3)}}

LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"count": 0, "radix": 0}
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
    source, all started together), load, and return the launch functions
    of the first name by entry."""
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
            lib = ctypes.CDLL(str(_library(name)))
            _fns[name] = {}
            for entry, (symbol, argtypes) in _BINDINGS[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name][entry] = fn
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


def _planes_shape(x1: torch.Tensor) -> Tuple[int, int]:
    if x1.dim() != 2:
        raise ValueError(f"nms_cuda: planes must be (B, K), got "
                         f"{tuple(x1.shape)}")
    return tuple(x1.shape)


def _check_inputs(x1, y1, x2, y2, scores, valid) -> None:
    """Raise on tensors the kernels do not take."""
    b, k = x1.shape
    for name, t in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2),
                    ("scores", scores)):
        _check(name, t, torch.float32, (b, k))
    _check("valid", valid, torch.int32, (b, k))
    if any(t.device != x1.device for t in (y1, x2, y2, scores, valid)):
        raise ValueError("nms_cuda: all inputs must be on one device")


def select_route(b: int, k: int, max_outputs: int) -> str:
    """The ranking route of a (B, K, M) call, by K alone: ``"count"`` up to
    ``COUNT_ROUTE_MAX_K``, ``"radix"`` past it. Raises on sizes the kernels
    do not take: the limits are the scan's kept list (20 bytes for each of
    min(M, K) in shared memory), int32 indices within an image and the
    grid's B."""
    if k < 1:
        raise ValueError("nms_cuda: needs at least one candidate")
    if max_outputs < 0:
        raise ValueError(f"nms_cuda: max_outputs {max_outputs} < 0")
    if k > MAX_K or b > MAX_B:
        raise ValueError(f"nms_cuda: B={b}, K={k} past the kernels' limits "
                         f"(B <= {MAX_B}, K <= {MAX_K})")
    kept = SMEM_BYTES_PER_PICK * min(max_outputs, k)
    if kept > MAX_DYNAMIC_SMEM:
        raise ValueError(f"nms_cuda: M={max_outputs} needs {kept} B of shared "
                         f"memory for the kept boxes, more than the "
                         f"{MAX_DYNAMIC_SMEM} B a block has")
    return "count" if k <= COUNT_ROUTE_MAX_K else "radix"


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
    """Greedy NMS on (B, K) class-offset box planes: rank (by the route K
    selects), then a chunked scan with one block per image.

    x1, y1, x2, y2, scores: (B, K) float32; valid: (B, K) int32 (0 / 1).
    Returns (idx, ok), each (B, max_outputs) int32: the picks in order,
    index 0 and ok 0 after the last one.
    """
    global LAUNCHES
    b, k = _planes_shape(x1)
    route = select_route(b, k, max_outputs)
    _check_inputs(x1, y1, x2, y2, scores, valid)
    fn = build()[route]
    # scratch, in one int32 allocation: the ranked boxes (B, K) x (x1, y1,
    # x2, y2) float32, their indices (B, K) and the alive counts (B,); the
    # radix route adds two key and two value lists (B, K) and the counts
    # (B, 256, tiles)
    extra = 0
    if route == "radix":
        tiles = -(-k // SORT_TILE)
        extra = 4 * b * k + b * RADIX_DIGITS * tiles
    scratch = torch.empty(b * k * 5 + b + extra, dtype=torch.int32,
                          device=x1.device)
    ptr = scratch.data_ptr()
    ptrs = [ptr, ptr + 16 * b * k, ptr + 20 * b * k]
    if route == "radix":
        lists = ptr + 4 * (5 * b * k + b)
        ptrs += [lists + 4 * b * k * i for i in range(5)]
    out = _launch(fn, (x1, y1, x2, y2, scores, valid), b, max_outputs,
                  iou_threshold, *ptrs)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[route] += 1
    return out


def nms_cuda_greedy(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                    y2: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float,
                    max_outputs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_cuda``'s function by the first design (one block per image,
    one argmax step per pick); the yardstick, not on any path."""
    b, k = _planes_shape(x1)
    select_route(b, k, max_outputs)
    smem = GREEDY_SMEM_BYTES_PER_CANDIDATE * k
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"nms_cuda_greedy: K={k} needs {smem} B of shared "
                         f"memory, more than the {MAX_DYNAMIC_SMEM} B a block "
                         "has")
    _check_inputs(x1, y1, x2, y2, scores, valid)
    fn = build(("nms_greedy",))["greedy"]
    return _launch(fn, (x1, y1, x2, y2, scores, valid), b, max_outputs,
                   iou_threshold)
