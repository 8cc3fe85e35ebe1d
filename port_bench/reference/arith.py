"""The reference's arithmetic: where its convolutions and products run.

``Arith()`` computes in float32; ``float32_exact()`` turns TF32 off for the
scope of a reference run (a float32 matmul or convolution on the card may
otherwise round its operands to TF32) and restores the flags after.
``Arith(fp8=True)`` is the output check's control: each operand of every
convolution, linear layer and product is rounded to float8 e4m3 under a
per-tensor scale (its largest magnitude maps to e4m3's 448) before the
float32 product, the nearest precision below the bfloat16 the
configurations state. ``counter`` receives one ``(kind, multiply_adds)``
per call, which the FLOP count's test holds against ``counts/flops.py``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in float32."""
    amax = x.detach().abs().amax().float()
    if not bool(amax > 0):
        return x.float()
    scale = amax / E4M3_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN inside the scope."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class Arith:
    """Convolutions and products of the reference, in float32 or (the
    control) on float8-rounded operands."""

    def __init__(self, fp8: bool = False,
                 counter: Optional[Callable[[str, int], None]] = None):
        self.fp8 = fp8
        self.counter = counter

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.fp8 else x.float()

    def conv2d(self, x, w, b=None, stride: int = 1, padding: int = 0):
        out = F.conv2d(self._operand(x), self._operand(w),
                       None if b is None else b.float(), stride, padding)
        if self.counter is not None:
            self.counter("conv", out.numel() * w[0].numel())
        return out

    def linear(self, x, w, b=None):
        out = F.linear(self._operand(x), self._operand(w),
                       None if b is None else b.float())
        if self.counter is not None:
            self.counter("linear", out.numel() * w.shape[1])
        return out

    def matmul(self, a, b):
        """``a @ b`` for (..., M, K) by (K, N)."""
        out = self._operand(a) @ self._operand(b)
        if self.counter is not None:
            self.counter("matmul", out.numel() * b.shape[0])
        return out
