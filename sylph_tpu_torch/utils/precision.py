"""Evaluation weights held in bfloat16 (port of sylph_tpu/utils/precision.py).

``TPU.EVAL_BF16_RESIDENT`` (on by default): on the card, serving and
evaluation hold every float32 parameter and buffer in bfloat16, which halves
the bytes each weight read moves. A convolution or matmul in bfloat16 rounds
its weights to bfloat16 anyway, so the cast changes only what the model
uses in float32 (GroupNorm scales and biases, the heads' biases) by ~0.4%
relative. Training keeps float32 master weights: ``eval_resident`` casts
for one evaluation and puts the float32 tensors back after it, bit for bit.
On the CPU the policy is off, as the JAX package turns it off on its CPU
backend, so the CPU tests keep the float32 numerics.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Iterator, List

import torch
import torch.nn as nn


def _float32_tensors(model: nn.Module) -> List[torch.Tensor]:
    return [t for t in itertools.chain(model.parameters(), model.buffers())
            if t.dtype == torch.float32]


def bf16_resident(model: nn.Module) -> nn.Module:
    """Hold every float32 parameter and buffer of ``model`` in bfloat16, in
    place; integer, bool and other floating tensors stay as they are.
    Returns ``model``."""
    with torch.no_grad():
        for t in _float32_tensors(model):
            t.data = t.data.to(torch.bfloat16)
    return model


def _policy_on(cfg, model: nn.Module) -> bool:
    if not cfg.TPU.EVAL_BF16_RESIDENT:
        return False
    first = next(itertools.chain(model.parameters(), model.buffers()), None)
    return first is not None and first.device.type != "cpu"


def eval_resident_params(cfg, model: nn.Module) -> nn.Module:
    """The ``TPU.EVAL_BF16_RESIDENT`` policy applied to a model that only
    evaluates from now on (serving): ``bf16_resident`` in place on the card,
    nothing when the switch is off or the model lies on the CPU."""
    return bf16_resident(model) if _policy_on(cfg, model) else model


@contextlib.contextmanager
def eval_resident(cfg, model: nn.Module) -> Iterator[nn.Module]:
    """``eval_resident_params`` for the scope of one evaluation of a model
    that goes on training: each cast tensor gets its float32 storage back
    on exit, so the master weights are untouched."""
    if not _policy_on(cfg, model):
        yield model
        return
    saved = [(t, t.data) for t in _float32_tensors(model)]
    with torch.no_grad():
        for t, data in saved:
            t.data = data.to(torch.bfloat16)
    try:
        yield model
    finally:
        for t, data in saved:
            t.data = data
