"""Sylph code generator (hypernetwork), NCHW (port of the serving path of
sylph_tpu/models/code_generator.py).

  1. multilevel ROIAlign of one support box per image -> (S, 256, 7, 7);
  2. shared tower: TOWER_LAYERS x [conv3x3, norm, act];
  3. heads ``cls_conv`` (256 channels), ``cls_bias`` (1), optional
     ``cls_weight`` (per-shot softmax weights) and ``cls_scale``, each a
     conv3x3 + optional norm/act ending in a global mean pool;
  4. k-shot aggregation: mean, weighted sum, or ``compress_code_w_max``
     (0.5-scaled mean + 0.5-scaled max, both learnable);
  5. ``normalize``: GN post-norm over a (N, 256, 1, 1) view, L2, then
     ``conv_scale``; bias = ``bias_scale`` * pred + focal prior (or the
     learnable ``meta_bias_value``).

Module names follow the flax ones (``tower_conv0``, ``tower_conv0_gn``,
``cls_conv_head``, ``post_norm``, ...) so converted weights load by name.
With ``contrastive_loss="snnl"`` the training codes also carry the soft-
nearest-neighbor loss over the per-shot features
(``soft_nearest_neighbor_loss``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.roi_align import multilevel_roi_align
from ..utils.spans import span
from .layers import Conv2d, GroupNorm, Scale


class _NormAct:
    """Inline norm + activation; the norm module is registered on the
    parent under ``{name}_gn`` / ``{name}_ln`` (flax ``_norm_act``)."""

    def __init__(self, parent: nn.Module, name: str, channels: int,
                 norm: str, act: str):
        if norm == "GN":
            self.norm_name = f"{name}_gn"
            groups = 32 if channels % 32 == 0 else 1
            parent.add_module(self.norm_name, GroupNorm(groups, channels))
        elif norm == "LN":
            self.norm_name = f"{name}_ln"
            parent.add_module(self.norm_name, GroupNorm(1, channels))
        elif norm in ("", "none", None):
            self.norm_name = None
        else:
            raise NotImplementedError(f"codegen norm {norm}")
        if act not in ("ReLU", "Tanh", "", "none", None):
            raise NotImplementedError(f"codegen activation {act}")
        self.act = act

    def __call__(self, parent: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.norm_name is not None:
            x = getattr(parent, self.norm_name)(x)
        if self.act == "ReLU":
            x = F.relu(x)
        elif self.act == "Tanh":
            x = torch.tanh(x)
        return x


class CodeGeneratorHead(nn.Module):
    """``forward(features, boxes, box_valid, num_shots, training)`` generates
    codes; ``normalize(codes)`` applies the shared post-processing."""

    def __init__(self, strides: Sequence[int] = (8, 16, 32, 64, 128),
                 pooler_resolution: int = 7, in_channels: int = 256,
                 out_channel: int = 256,
                 tower_layers: Sequence[Sequence[str]] = (("GN", "ReLU"),
                                                          ("GN", "ReLU")),
                 cls_layer: Sequence = ("", "", 1),
                 bias_layer: Sequence = ("", "", 1),
                 weight_layer: Sequence = (), scale_layer: Sequence = (),
                 conv_l2_norm: bool = True,
                 bias_l2_norm: bool = False, post_norm: str = "GN",
                 use_weight_scale: bool = True,
                 compress_code_w_max: bool = False, prior_prob: float = 0.01,
                 meta_bias: bool = False, contrastive_loss: str = "",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.strides = tuple(strides)
        self.pooler_resolution = pooler_resolution
        self.out_channel = out_channel
        self.bias_layer = tuple(bias_layer)
        self.weight_layer = tuple(weight_layer)
        self.scale_layer = tuple(scale_layer)
        self.conv_l2_norm = conv_l2_norm
        self.bias_l2_norm = bias_l2_norm
        self.compress_code_w_max = compress_code_w_max
        self.contrastive_loss = contrastive_loss
        self.compute_dtype = compute_dtype
        self.prior = -math.log((1 - prior_prob) / prior_prob)

        self.tower_acts = []
        for i, (norm, act) in enumerate(tower_layers):
            self.add_module(f"tower_conv{i}", Conv2d(in_channels, 256, 3))
            self.tower_acts.append(_NormAct(self, f"tower_conv{i}", 256,
                                            norm, act))
            in_channels = 256
        self.head_acts = {}

        def head(out_c, layer_cfg, name):
            self.add_module(name, Conv2d(in_channels, out_c, 3))
            self.head_acts[name] = _NormAct(self, name, out_c, layer_cfg[0],
                                            layer_cfg[1])

        head(out_channel, cls_layer, "cls_conv_head")
        if self.weight_layer:
            head(1, self.weight_layer, "cls_weight_head")
        if self.bias_layer:
            head(1, self.bias_layer, "cls_bias_head")
        if self.scale_layer:
            head(1, self.scale_layer, "cls_scale_head")
        if compress_code_w_max:
            self.cls_mean_scale = Scale(0.5)
            self.cls_max_scale = Scale(0.5)

        self.use_post_norm = post_norm == "GN" and out_channel % 32 == 0
        if self.use_post_norm:
            self.post_norm = GroupNorm(32, out_channel)
        self.use_conv_scale = use_weight_scale and (conv_l2_norm
                                                    or post_norm == "GN")
        if self.use_conv_scale:
            self.conv_scale = Scale(1.0)
        if self.bias_layer:
            self.bias_scale = Scale(1.0)
        self.meta_bias = meta_bias
        if meta_bias:
            self.meta_bias_value = nn.Parameter(torch.tensor(self.prior))

    # ------------------------------------------------------------ generate
    def _head(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.head_acts[name](self, getattr(self, name)(x))
        return y.mean(dim=(2, 3)).float()  # global pool -> (S, C)

    def forward(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                box_valid: torch.Tensor, num_shots: int,
                training: bool = False) -> Dict[str, torch.Tensor]:
        """features: per-level (S, C, H_l, W_l); boxes (S, 4), one per image."""
        s = boxes.shape[0]
        assert s % num_shots == 0, (s, num_shots)
        feats = [f.to(self.compute_dtype) for f in features]
        with span("roi_align"):
            x = multilevel_roi_align(
                feats, self.strides, boxes, box_valid,
                torch.arange(s, device=boxes.device),
                output_size=self.pooler_resolution)

        for i, norm_act in enumerate(self.tower_acts):
            x = norm_act(self, getattr(self, f"tower_conv{i}")(x))

        conv_feature = self._head(x, "cls_conv_head")
        weight = None
        if self.weight_layer:
            w_logit = self._head(x, "cls_weight_head")
            weight = torch.softmax(w_logit.reshape(-1, num_shots), dim=1)

        conv_weights = self._compute_code(conv_feature, num_shots, weight)
        n_class = conv_weights.shape[0]

        if self.bias_layer:
            bias_feature = self._head(x, "cls_bias_head")
            if self.bias_l2_norm:
                bias_feature = bias_feature / torch.clamp(
                    torch.linalg.vector_norm(bias_feature, dim=-1,
                                             keepdim=True), min=1e-12)
            conv_bias = self._compute_code(
                bias_feature, num_shots, weight).reshape(n_class)
        else:
            conv_bias = torch.zeros((n_class,), dtype=torch.float32,
                                    device=conv_weights.device)

        conv_weight_norm = None
        if self.scale_layer:
            conv_weight_norm = self._compute_code(
                self._head(x, "cls_scale_head"), num_shots,
                weight).reshape(n_class)

        out: Dict[str, torch.Tensor] = {}
        if training and self.contrastive_loss == "snnl":
            # registration reads only the codes, so the loss is left out
            out["snnl"] = soft_nearest_neighbor_loss(conv_feature, num_shots)
        if training:
            conv_weights, conv_bias = self._process_code(
                conv_weights, conv_bias, conv_weight_norm)
        out.update({"cls_conv": conv_weights, "cls_bias": conv_bias})
        if conv_weight_norm is not None:
            out["cls_weight_norm"] = conv_weight_norm
        return out

    # --------------------------------------------------------------- parts
    def _compute_code(self, per_shot: torch.Tensor, num_shots: int,
                      weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(S, C) -> (S/num_shots, C) k-shot aggregation."""
        grouped = per_shot.reshape(-1, num_shots, per_shot.shape[-1])
        if self.compress_code_w_max:
            return (self.cls_mean_scale(grouped.mean(1))
                    + self.cls_max_scale(grouped.amax(1)))
        if weight is None:
            return grouped.mean(1)
        return (grouped * weight[..., None]).sum(1)

    def _process_code(self, conv_weights, conv_bias, conv_weight_norm=None):
        """post-norm GN + L2 + scale; bias = prior + scale * pred."""
        w = conv_weights.float()
        if self.use_post_norm:
            w = self.post_norm(w[:, :, None, None])[:, :, 0, 0]
        if self.conv_l2_norm:
            w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                         keepdim=True),
                                min=1e-12)
        if conv_weight_norm is not None:
            w = w * conv_weight_norm[:, None]
        if self.use_conv_scale:
            w = self.conv_scale(w)

        b = conv_bias.float()
        if self.bias_layer:
            b = self.bias_scale(b)
        prior = self.meta_bias_value if self.meta_bias else self.prior
        return w, b + prior

    def normalize(self, class_codes: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        w, b = self._process_code(class_codes["cls_conv"],
                                  class_codes["cls_bias"],
                                  class_codes.get("cls_weight_norm"))
        return {"cls_conv": w, "cls_bias": b}


def soft_nearest_neighbor_loss(features: torch.Tensor, k: int
                               ) -> torch.Tensor:
    """Soft-nearest-neighbor contrastive loss over per-shot features
    (reference SoftNearestNeighborLoss, code_generator/utils.py:326-351):
    L2-normalized features, exp(-squared distance), the same k-group as the
    numerator against every other item as the denominator."""
    n = features.shape[0]
    f = features / torch.clamp(torch.linalg.vector_norm(
        features, dim=-1, keepdim=True), min=1e-12)
    sq = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
    sim = torch.exp(-sq)
    idx = torch.arange(n, device=features.device)
    same_class = (idx[:, None] // k) == (idx[None, :] // k)
    off_diag = idx[:, None] != idx[None, :]
    zero = torch.zeros_like(sim)
    intra = torch.where(same_class & off_diag, sim, zero).sum(1)
    allc = torch.where(off_diag, sim, zero).sum(1)
    per_item = torch.log(torch.clamp(intra, min=1e-12)
                         / torch.clamp(allc, min=1e-12))
    return -per_item.sum() / n
