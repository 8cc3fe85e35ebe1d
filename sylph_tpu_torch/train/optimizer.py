"""Optimizer, LR schedule and freezing (port of sylph_tpu/train/optimizer.py).

The JAX package builds the optax chain

    masked(set_to_zero, frozen) + masked(clip_by_global_norm ->
        add_decayed_weights(mask = ndim > 1) -> sgd(schedule, momentum),
        trainable)

and this module applies the same update by hand (``SGD.step``), because
``torch.optim.SGD`` differs from it where it matters:

  * every trainable parameter is updated, a gradient-free one too (its
    gradient counts as zero, so weight decay and momentum still move it);
  * the global norm runs over the trainable parameters only, and the clip
    scales by ``max_norm / norm`` only when ``norm >= max_norm`` (no
    epsilon);
  * weight decay skips parameters with ``ndim <= 1`` unless
    ``weight_decay_norm > 0``;
  * the schedule is read at the update count before it is incremented;
  * frozen parameters are never touched, so they stay bit-identical.

Freezing follows the flax parameter paths (``backbone/res2_block0/conv1/
kernel``), derived from the port's module names by ``flax_param_path``, so
``build_freeze_mask`` applies the JAX rules word for word. FrozenBN
statistics are buffers in the port and never train.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn


def build_lr_schedule(base_lr: float, steps: Sequence[int], gamma: float,
                      warmup_iters: int, warmup_factor: float
                      ) -> Callable[[int], float]:
    """d2go WarmupMultiStepLR (linear warmup), computed in float32 in the
    JAX package's order of operations."""
    steps = tuple(steps)
    f32 = np.float32

    def schedule(count) -> float:
        c = f32(count)
        if c < warmup_iters:
            warm = f32(warmup_factor) + f32(1.0 - warmup_factor) * (
                c / f32(max(warmup_iters, 1)))
        else:
            warm = f32(1.0)
        decay = f32(1.0)
        for s in steps:
            decay = decay * (f32(gamma) if c >= s else f32(1.0))
        return float(f32(f32(base_lr) * warm) * decay)

    return schedule


def flax_param_path(model: nn.Module, name: str) -> str:
    """The flax path of a port parameter: ``fcos_head.cls_tower.gn0.weight``
    -> ``fcos_head/cls_tower/gn0/scale``, a conv ``weight`` -> ``kernel``."""
    parts = name.split(".")
    module = model.get_submodule(".".join(parts[:-1]))
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if isinstance(module, nn.GroupNorm) else "kernel"
    return "/".join(parts[:-1] + [leaf])


def _trainable(p: str, f: Dict[str, bool], exclude: List[str]) -> bool:
    """The JAX package's rule (optimizer.py:66-102) on one flax path."""
    if "_bn" in p and ("/scale" in p or "/bias" in p):
        return False
    # detectron2's "backbone" is ResNet + FPN
    if (p.startswith("backbone/") or p.startswith("fpn/")) and f["backbone"]:
        return any(e in p for e in exclude)
    if p.startswith("fcos_head/"):
        if f["proposal_generator"]:
            return False
        if "cls_tower" in p and (f["cls_tower"] or f["owd"]):
            return False
        if "cls_logits" in p and (f["cls_logits"] or f["owd"]
                                  or f["episodic"]):
            return False
        if "bbox_tower" in p and (f["bbox_branch"] or f["bbox_tower"]):
            return False
        if f["bbox_branch"] and any(m in p for m in (
                "bbox_pred", "ctrness", "iou_overlap")):
            return False
    if p.startswith("code_generator/") and f["code_generator"]:
        return False
    if p.startswith("rpn_head/") and f["proposal_generator"]:
        return False
    if p.startswith("box_head/") and f["roi_heads"]:
        return False
    if p.startswith("box_head/fc") and f["roi_heads_feat"]:
        return False
    return True


def build_freeze_mask(model: nn.Module, freeze_cfg: Dict[str, Any]
                      ) -> Dict[str, bool]:
    """{port parameter name: trainable}. freeze_cfg keys as in the JAX
    package: backbone, backbone_exclude, proposal_generator, cls_tower,
    cls_logits, bbox_branch, bbox_tower, owd, code_generator, episodic,
    roi_heads, roi_heads_feat."""
    freeze_cfg = freeze_cfg or {}
    f = {k: bool(freeze_cfg.get(k, False)) for k in (
        "backbone", "proposal_generator", "cls_tower", "cls_logits",
        "bbox_branch", "bbox_tower", "owd", "code_generator", "episodic",
        "roi_heads", "roi_heads_feat")}
    exclude = list(freeze_cfg.get("backbone_exclude", []) or [])
    return {name: _trainable(flax_param_path(model, name), f, exclude)
            for name, _ in model.named_parameters()}


class SGD:
    """SGD with momentum on the trainable parameters of a model, the optax
    chain of the JAX package written out (see the module docstring).

    ``count`` is optax's update count: the schedule reads it before it is
    incremented, so the first update uses ``schedule(0)``."""

    def __init__(self, model: nn.Module, trainable: Dict[str, bool],
                 schedule: Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 1e-4, weight_decay_norm: float = 0.0,
                 clip_grad_norm: float = 0.0):
        self.schedule = schedule
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.clip_grad_norm = float(clip_grad_norm or 0.0)
        named = dict(model.named_parameters())
        self.names = [n for n in named if trainable[n]]
        self.params = [named[n] for n in self.names]
        self.decayed = [p.ndim > 1 or weight_decay_norm > 0
                        for p in self.params]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if not grads:
            self.count += 1
            return
        if self.clip_grad_norm > 0:
            sq = [(g * g).sum() for g in grads]
            norm = torch.sqrt(torch.stack(sq).sum())
            factor = torch.where(norm < self.clip_grad_norm,
                                 torch.ones_like(norm),
                                 self.clip_grad_norm / norm)
            torch._foreach_mul_(grads, factor)
        if self.weight_decay > 0:
            dg = [g for g, d in zip(grads, self.decayed) if d]
            dp = [p for p, d in zip(self.params, self.decayed) if d]
            if dg:
                torch._foreach_add_(dg, torch._foreach_mul(
                    dp, self.weight_decay))
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        lr = self.schedule(self.count)
        torch._foreach_add_(self.params, torch._foreach_mul(self.trace, -lr))
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                "trace": {n: t.detach().cpu() for n, t in
                          zip(self.names, self.trace)}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.count = int(sd["count"])
        for n, t in zip(self.names, self.trace):
            t.copy_(sd["trace"][n])


def build_optimizer(model: nn.Module, *, base_lr: float,
                    momentum: float = 0.9, weight_decay: float = 1e-4,
                    weight_decay_norm: float = 0.0,
                    steps: Sequence[int] = (60000, 80000),
                    gamma: float = 0.1, warmup_iters: int = 1000,
                    warmup_factor: float = 1e-3,
                    clip_grad_norm: float = 0.0,
                    freeze_cfg: Dict[str, Any] = None
                    ) -> Tuple[SGD, Callable[[int], float]]:
    """The reference recipe on ``model``; returns (optimizer, schedule).
    Frozen parameters get ``requires_grad=False``, so autograd does not
    compute gradients that the update would discard."""
    schedule = build_lr_schedule(base_lr, steps, gamma, warmup_iters,
                                 warmup_factor)
    mask = build_freeze_mask(model, freeze_cfg or {})
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    tx = SGD(model, mask, schedule, momentum=momentum,
             weight_decay=weight_decay,
             weight_decay_norm=weight_decay_norm,
             clip_grad_norm=clip_grad_norm)
    return tx, schedule
