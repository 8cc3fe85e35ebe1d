"""Small building blocks shared by the port's models.

Parameters stay float32; activations run in the model's compute dtype.
``Conv2d``, ``Linear`` and ``LayerNorm`` cast their weights to the input's
dtype on the fly (so weights held in bfloat16 for evaluation,
``utils/precision.py``, are widened where a layer runs in float32, as flax
promotes them) and ``GroupNorm`` normalizes in float32 (flax ``GroupNorm(dtype=float32)``), so
one float32 state dict serves both float32 and bfloat16 runs. On bfloat16
inputs ``GroupNorm`` rounds its scale and bias to bfloat16 before using them
in float32, as the JAX package's bf16-resident parameters are used.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with torch-style symmetric padding ``dilation * (k - 1)
    // 2`` (``k // 2`` undilated) that runs in the dtype of its input."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride,
                         padding=dilation * (kernel_size - 1) // 2,
                         dilation=dilation, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` that runs in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that runs in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in float32, returned in the input's dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if x.dtype != torch.float32:
            w, b = w.to(x.dtype), b.to(x.dtype)
        # float32 sums whatever dtype the parameters are held in
        return F.group_norm(x.float(), self.num_groups, w.float(),
                            b.float(), self.eps).to(x.dtype)


class Scale(nn.Module):
    """Learnable scalar multiplier (JAX ``Scale`` / ``_Scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.init_value = float(init_value)
        self.scale = nn.Parameter(torch.tensor(self.init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


def flatten_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major over (h, w) — the order of the
    JAX package's NHWC ``reshape(b, -1, C)``."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)
