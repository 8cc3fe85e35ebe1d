"""Build and bind the native COCO matcher (csrc/coco_matcher.cpp).

At first use the matcher is compiled with ``g++ -O3 -shared -fPIC`` into
``sylph_tpu_torch/_build/`` (named by a hash of the source and flags) and
loaded with ``ctypes``. A failed build raises: there is no fallback. The
plain numpy twin is ``coco_eval_np.match_greedy_reference``; it runs only
where a caller names ``impl="reference"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "coco_matcher.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def _library() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcocomatch_{tag}.so"


def get_lib() -> ctypes.CDLL:
    """Compile (once per source hash) and load the matcher."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = _library()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.match_greedy.argtypes = [
            ctypes.POINTER(ctypes.c_double),   # ious
            ctypes.POINTER(ctypes.c_uint8),    # g_ignore
            ctypes.POINTER(ctypes.c_uint8),    # g_crowd
            ctypes.POINTER(ctypes.c_double),   # iou_thrs
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),    # out_dt_m
            ctypes.POINTER(ctypes.c_uint8),    # out_dt_ig
        ]
        lib.match_greedy.restype = None
        _LIB = lib
        return lib


def match_greedy(ious: np.ndarray, g_ignore: np.ndarray,
                 g_crowd: np.ndarray, iou_thrs: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The native matcher: (dt_m (T, nd) int64, dt_ig (T, nd) bool)."""
    lib = get_lib()
    nd, ng = ious.shape
    t = len(iou_thrs)
    ious = np.ascontiguousarray(ious, np.float64)
    gi = np.ascontiguousarray(g_ignore, np.uint8)
    gc = np.ascontiguousarray(g_crowd, np.uint8)
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    dt_m = np.empty((t, nd), np.int64)
    dt_ig = np.empty((t, nd), np.uint8)
    lib.match_greedy(
        ious.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        gc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        thrs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        t, nd, ng,
        dt_m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dt_ig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return dt_m, dt_ig.astype(bool)
