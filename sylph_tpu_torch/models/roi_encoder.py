"""ROIEncoder: the transformer code generator, NCHW (port of
sylph_tpu/models/roi_encoder.py).

  1. multilevel ROIAlign of one support box per image -> (S, 256, 7, 7)
     float32, then ``fusion_conv`` (3x3) + ``fusion_gn`` + relu;
  2. context: every FPN level pooled to 7x7 (``F.adaptive_avg_pool2d``,
     the semantics of the JAX package's ``_adaptive_avg_pool``) and averaged
     over the levels; ``ms_cam`` (MS-CAM) gates the pooled features with
     sigmoid(local(context) + global(mean of context));
  3. tokenizer: ``tok_conv{i}`` (+ ``tok_gn{i}``) and ``tok_fc{i}`` with
     relu, the map flattened in (h, w, c) order as the JAX package's NHWC
     reshape flattens it;
  4. ``encoder_layer{i}``: post-LN transformer layers over the K shots of
     each class (the JAX package's documented reading of the reference),
     multi-head attention with explicit ``query``/``key``/``value``/``out``
     projections (flax ``MultiHeadDotProductAttention``: the query scaled by
     1/sqrt(head_dim), softmax in float32), a relu FFN of 4 x d, dropout;
  5. the mean over shots, the ``weight_fc{i}`` and ``bias_fc{i}`` MLP heads;
     bias = focal prior + the predicted delta.

The codes it emits are final: ``normalize_code`` is refused for it.

Dropout (``training`` with TRANSFORMER_ENCODER.DROPOUT > 0) draws its masks
from the ``generator`` the caller passes (a CPU ``torch.Generator``; the
train step seeds one per iteration and micro-group), so the same seed gives
the same masks on any device and a resumed run draws what an uninterrupted
one does. The masks follow flax: keep with probability 1 - p, scale kept
values by 1 / (1 - p); the attention weights' mask is shared across the
batch and the heads (flax ``broadcast_dropout``).

The projections keep the flax leaves' shapes where the optimizer reads them
(``query``/``key``/``value`` biases are (heads, head_dim), decayed as JAX's
2-D leaves are), so ``state_dict_from_jax`` carries the 3-D ``DenseGeneral``
kernels across by reshaping.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.roi_align import multilevel_roi_align
from .layers import Conv2d, GroupNorm


def _dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator],
             shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1 - p (a mask of ``shape``,
    broadcast against x, drawn on the CPU), scale kept values by 1/(1 - p);
    the identity when ``gen`` is None."""
    if gen is None or p == 0.0:
        return x
    keep = 1.0 - p
    u = torch.rand(tuple(shape or x.shape), generator=gen)
    mask = (u < keep).to(device=x.device, dtype=x.dtype)
    return x * mask / keep


class MSCAM(nn.Module):
    """Multi-scale channel attention: ``{local,global}_conv{1,2}`` (1x1) with
    ``{local,global}_gn{1,2}``."""

    def __init__(self, channels: int = 256, reduction: int = 4):
        super().__init__()
        inter = channels // reduction
        for prefix in ("local", "global"):
            self.add_module(f"{prefix}_conv1", Conv2d(channels, inter, 1))
            self.add_module(f"{prefix}_gn1", GroupNorm(32, inter))
            self.add_module(f"{prefix}_conv2", Conv2d(inter, channels, 1))
            self.add_module(f"{prefix}_gn2", GroupNorm(32, channels))

    def _att(self, y: torch.Tensor, prefix: str) -> torch.Tensor:
        y = F.relu(getattr(self, f"{prefix}_gn1")(
            getattr(self, f"{prefix}_conv1")(y)))
        return getattr(self, f"{prefix}_gn2")(
            getattr(self, f"{prefix}_conv2")(y))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        local = self._att(context, "local")
        glob = self._att(context.mean(dim=(2, 3), keepdim=True), "global")
        return x * torch.sigmoid(local + glob)


class _HeadsProjection(nn.Linear):
    """flax ``DenseGeneral(features=(heads, head_dim))``: ``weight``
    (heads * head_dim, d) and a (heads, head_dim) ``bias``; returns
    (..., heads, head_dim)."""

    def __init__(self, d: int, heads: int):
        super().__init__(d, d)
        self.heads = heads
        self.bias = nn.Parameter(torch.empty(heads, d // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias.reshape(-1))
        return y.reshape(*x.shape[:-1], self.heads, -1)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(x, x)`` with ``qkv_features`` =
    d: ``query``, ``key``, ``value`` and ``out`` (an ``nn.Linear`` from the
    concatenated heads)."""

    def __init__(self, d: int, heads: int, dropout: float):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.query = _HeadsProjection(d, heads)
        self.key = _HeadsProjection(d, heads)
        self.value = _HeadsProjection(d, heads)
        self.out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, L, h, hd)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), -1)
        w = _dropout(w, self.dropout, gen, (1, 1, *w.shape[-2:]))
        att = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
        return self.out(att.reshape(*x.shape[:-1], -1))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with torch's defaults (relu FFN): ``self_attn``,
    ``norm1``, ``ff1``, ``ff2``, ``norm2``."""

    def __init__(self, d: int, heads: int, ff_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = SelfAttention(d, heads, dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ff1 = nn.Linear(d, ff_dim)
        self.ff2 = nn.Linear(ff_dim, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        att = _dropout(self.self_attn(x, gen), self.dropout, gen)
        x = self.norm1(x + att)
        ff = _dropout(F.relu(self.ff1(x)), self.dropout, gen)
        ff = _dropout(self.ff2(ff), self.dropout, gen)
        return self.norm2(x + ff)


class ROIEncoder(nn.Module):
    """Configured from MODEL.META_LEARN.CODE_GENERATOR.{ROI_BOX, TOKENIZER,
    TRANSFORMER_ENCODER, HEAD}."""

    def __init__(self, strides: Sequence[int] = (8, 16, 32, 64, 128),
                 pooler_resolution: int = 7, feature_channels: int = 256,
                 tokenizer_num_conv: int = 0, tokenizer_conv_dim: int = 256,
                 tokenizer_norm: str = "", tokenizer_num_fc: int = 1,
                 tokenizer_fc_dim: int = 256, transformer_layers: int = 1,
                 transformer_heads: int = 8, transformer_dropout: float = 0.1,
                 head_num_fc: int = 1, head_fc_dim: int = 512,
                 head_output_dim: int = 256, prior_prob: float = 0.01,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if tokenizer_norm not in ("", "GN"):
            raise NotImplementedError(f"tokenizer norm {tokenizer_norm}")
        self.strides = tuple(strides)
        self.p = pooler_resolution
        self.compute_dtype = compute_dtype
        self.fc_dim = tokenizer_fc_dim
        self.dropout = transformer_dropout
        self.prior = -math.log((1 - prior_prob) / prior_prob)
        c = feature_channels
        self.fusion_conv = Conv2d(c, c, 3)
        self.fusion_gn = GroupNorm(32, c)
        self.ms_cam = MSCAM(c)
        self.tok_num_conv = tokenizer_num_conv
        self.tok_gn = tokenizer_norm == "GN"
        for i in range(tokenizer_num_conv):
            self.add_module(f"tok_conv{i}", Conv2d(
                c, tokenizer_conv_dim, 3, bias=not self.tok_gn))
            if self.tok_gn:
                self.add_module(f"tok_gn{i}",
                                GroupNorm(32, tokenizer_conv_dim))
            c = tokenizer_conv_dim
        dim = c * pooler_resolution ** 2
        self.tok_num_fc = tokenizer_num_fc
        for i in range(tokenizer_num_fc):
            self.add_module(f"tok_fc{i}", nn.Linear(dim, tokenizer_fc_dim))
            dim = tokenizer_fc_dim
        self.num_layers = transformer_layers
        for i in range(transformer_layers):
            self.add_module(f"encoder_layer{i}", TransformerEncoderLayer(
                tokenizer_fc_dim, transformer_heads, tokenizer_fc_dim * 4,
                transformer_dropout))
        self.head_num_fc = head_num_fc
        for prefix, out_dim in (("weight", head_output_dim), ("bias", 1)):
            d = tokenizer_fc_dim
            for i in range(head_num_fc):
                last = i == head_num_fc - 1
                self.add_module(f"{prefix}_fc{i}", nn.Linear(
                    d, out_dim if last else head_fc_dim))
                d = head_fc_dim

    def _mlp_head(self, y: torch.Tensor, prefix: str) -> torch.Tensor:
        for i in range(self.head_num_fc):
            y = getattr(self, f"{prefix}_fc{i}")(y)
            if i < self.head_num_fc - 1:
                y = F.relu(y)
        return y

    def forward(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                box_valid: torch.Tensor, num_shots: int,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """features: per-level (S, C, H_l, W_l); boxes (S, 4), one per image
        -> final codes {cls_conv (S / shots, 256), cls_bias (S / shots,)}.
        With ``training`` and a dropout rate above 0, ``generator`` must be
        given."""
        s = boxes.shape[0]
        assert s % num_shots == 0, (s, num_shots)
        drop = training and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("ROIEncoder training with dropout needs a "
                             "generator (seeded per step and micro-group)")
        gen = generator if drop else None
        feats = [f.to(self.compute_dtype) for f in features]
        pooled = multilevel_roi_align(
            feats, self.strides, boxes, box_valid,
            torch.arange(s, device=boxes.device), output_size=self.p)
        x = F.relu(self.fusion_gn(self.fusion_conv(pooled)))
        ctx = torch.stack([F.adaptive_avg_pool2d(f, self.p)
                           for f in feats]).mean(0)
        x = self.ms_cam(x, ctx.float())

        for i in range(self.tok_num_conv):
            x = getattr(self, f"tok_conv{i}")(x)
            if self.tok_gn:
                x = getattr(self, f"tok_gn{i}")(x)
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(s, -1).float()
        for i in range(self.tok_num_fc):
            x = F.relu(getattr(self, f"tok_fc{i}")(x))

        tokens = x.reshape(-1, num_shots, self.fc_dim)
        for i in range(self.num_layers):
            tokens = getattr(self, f"encoder_layer{i}")(tokens, gen)
        class_tokens = tokens.mean(1)                     # (n_class, C)
        weights = self._mlp_head(class_tokens, "weight")
        delta = self._mlp_head(class_tokens, "bias").reshape(-1)
        return {"cls_conv": weights, "cls_bias": self.prior + delta}
