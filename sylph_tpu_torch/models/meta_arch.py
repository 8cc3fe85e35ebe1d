"""MetaOneStageDetector: the top-level few-shot detector (port of
sylph_tpu/models/meta_arch.py).

  * ``forward_base``        — base detector with the trained ``cls_logits``
                              (pretraining and plain evaluation);
  * ``forward_episodic_train`` — support set -> normalized codes ->
                              conditioned query head, one training episode
                              batch;
  * ``forward_class_code``  — support set -> raw class codes;
  * ``normalize_code``      — post-hoc code normalization (refused for the
                              ROIEncoder, whose codes are final);
  * ``forward_instances``   — conditioned inference with a code bank.

Input contract as in the JAX package: images are float32 (or uint8)
**NHWC BGR** canvases, already resized and padded; normalization
``(x - mean) / std`` happens here, then the model runs NCHW.

Episode semantics: the E episodes of a call are the "way": codes are made
for their E classes and every query is classified against all E of them.
With ``stop_backbone_grad`` (MODEL.BACKBONE.FREEZE) the backbone and FPN run
without an autograd graph, so their activations are not kept;
``remat_backbone`` recomputes the backbone's activations in the backward
pass (``torch.utils.checkpoint``, non-reentrant).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .code_generator import CodeGeneratorHead
from .fcos_head import FCOSHead, HeadOutputs
from .fpn import FPN
from .resnet import ResNet, resnet_feature_channels
from .roi_encoder import ROIEncoder


class MetaOneStageDetector(nn.Module):
    """Backbone + FPN + FCOS head + code generator."""

    def __init__(self, depth: int = 50,
                 backbone_out_features: Sequence[str] = ("res3", "res4",
                                                         "res5"),
                 fpn_out_channels: int = 256, fpn_top_levels: int = 2,
                 num_classes: int = 80, num_cls_convs: int = 4,
                 num_box_convs: int = 4, num_share_convs: int = 0,
                 fcos_norm: str = "GN", use_scale: bool = True,
                 prior_prob: float = 0.01, cls_kernel_size: int = 1,
                 l2_norm_cls_weight: bool = False,
                 use_deformable: bool = False,
                 fpn_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 code_generator_name: Optional[str] = "CodeGenerator",
                 code_generator_kwargs: Optional[Dict[str, Any]] = None,
                 pixel_mean: Sequence[float] = (103.530, 116.280, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 s2d_stem: bool = False, remat_backbone: bool = False,
                 stop_backbone_grad: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat_backbone = remat_backbone
        self.stop_backbone_grad = stop_backbone_grad
        self.code_generator_name = code_generator_name
        self.backbone = ResNet(depth=depth,
                               out_features=tuple(backbone_out_features),
                               compute_dtype=compute_dtype,
                               s2d_stem=s2d_stem)
        self.fpn = FPN(resnet_feature_channels(),
                       in_features=tuple(backbone_out_features),
                       out_channels=fpn_out_channels,
                       top_levels=fpn_top_levels,
                       compute_dtype=compute_dtype)
        self.fcos_head = FCOSHead(
            num_classes=num_classes, in_channels=fpn_out_channels,
            num_cls_convs=num_cls_convs, num_box_convs=num_box_convs,
            num_share_convs=num_share_convs, norm=fcos_norm,
            use_scale=use_scale, cls_kernel_size=cls_kernel_size,
            l2_norm_cls_weight=l2_norm_cls_weight,
            use_deformable=use_deformable, num_levels=len(fpn_strides),
            compute_dtype=compute_dtype)
        kwargs = dict(code_generator_kwargs or {})
        kwargs.setdefault("strides", tuple(fpn_strides))
        kwargs.setdefault("prior_prob", prior_prob)
        kwargs.setdefault("compute_dtype", compute_dtype)
        if code_generator_name == "CodeGenerator":
            self.code_generator = CodeGeneratorHead(in_channels=fpn_out_channels,
                                                    **kwargs)
        elif code_generator_name in ("none", None, ""):
            self.code_generator = None
        elif code_generator_name == "ROIEncoder":
            kwargs.pop("prior_prob", None)  # its own focal prior, as in JAX
            self.code_generator = ROIEncoder(
                feature_channels=fpn_out_channels, **kwargs)
        else:
            raise NotImplementedError(code_generator_name)
        self.pixel_mean = tuple(float(m) for m in pixel_mean)
        self.pixel_std = tuple(float(s) for s in pixel_std)
        self._mean_std: Dict[torch.device, tuple] = {}

    # -------------------------------------------------------------- plumbing
    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) BGR canvas -> normalized (B, 3, H, W) compute dtype.
        The mean and std are made once per device: a host-to-device copy
        from pageable memory waits for the card's queued work."""
        dev = images.device
        if dev not in self._mean_std:
            self._mean_std[dev] = (torch.tensor(self.pixel_mean, device=dev),
                                   torch.tensor(self.pixel_std, device=dev))
        mean, std = self._mean_std[dev]
        x = (images.float() - mean) / std
        return x.to(self.compute_dtype).permute(0, 3, 1, 2)

    def extract_features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images (B, H, W, 3) BGR canvas -> list of 5 FPN maps (NCHW)."""
        if self.stop_backbone_grad:
            with torch.no_grad():
                return self.fpn(self.backbone(self._normalize(images)))
        x = self._normalize(images)
        if self.remat_backbone and torch.is_grad_enabled():
            feats = checkpoint(self.backbone, x, use_reentrant=False)
        else:
            feats = self.backbone(x)
        return self.fpn(feats)

    # ----------------------------------------------------------------- modes
    def forward_base(self, images: torch.Tensor) -> HeadOutputs:
        return self.fcos_head(self.extract_features(images))

    def _codes(self, feats, boxes, box_valid, num_shots: int, training: bool,
               generator: Optional[torch.Generator]):
        kw = ({"generator": generator}
              if isinstance(self.code_generator, ROIEncoder) else {})
        return self.code_generator(feats, boxes, box_valid,
                                   num_shots=num_shots, training=training,
                                   **kw)

    def forward_class_code(self, support_images: torch.Tensor,
                           support_boxes: torch.Tensor,
                           support_box_valid: torch.Tensor, num_shots: int,
                           training: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict[str, torch.Tensor]:
        """Support set (S images, one box each) -> codes (S // shots rows).
        ``generator``: the ROIEncoder's dropout draws when ``training``."""
        feats = self.extract_features(support_images)
        return self._codes(feats, support_boxes, support_box_valid,
                           num_shots, training, generator)

    def normalize_code(self, codes: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        if isinstance(self.code_generator, ROIEncoder):
            raise ValueError("the ROIEncoder emits final codes; they take no "
                             "normalize_code")
        return self.code_generator.normalize(codes)

    def forward_episodic_train(
        self, support_images: torch.Tensor, support_boxes: torch.Tensor,
        support_box_valid: torch.Tensor, query_images: torch.Tensor,
        num_shots: int, generator: Optional[torch.Generator] = None
    ) -> Tuple[HeadOutputs, Dict[str, torch.Tensor]]:
        """support_images (E*num_shots, H, W, 3), query_images (E*Q, H', W',
        3) -> the conditioned query head outputs (E logit channels) and the
        normalized codes (for the distillation and snnl losses).
        ``generator``: the ROIEncoder's dropout draws."""
        sfeats = self.extract_features(support_images)
        codes = self._codes(sfeats, support_boxes, support_box_valid,
                            num_shots, True, generator)
        qfeats = self.extract_features(query_images)
        return self.fcos_head(qfeats, class_code=codes), codes

    def forward_instances(self, images: torch.Tensor,
                          class_code: Dict[str, torch.Tensor]) -> HeadOutputs:
        """Conditioned dense predictions for decoding (query path)."""
        return self.fcos_head(self.extract_features(images),
                              class_code=class_code)

    def forward(self, images: torch.Tensor) -> HeadOutputs:
        return self.forward_base(images)
