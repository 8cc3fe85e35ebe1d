"""The whole reference paths the cells compare: Meta-FCOS and Meta Faster
R-CNN query images against a code bank, and Meta-FCOS registration.

Settings come from a configuration's ``cfg`` table (``configs/*.json``),
keyed as the published YAML keys them; images are the uint8 BGR canvases
(B, H, W, 3) both sides are given, normalized here as ``(x - mean) / std``.
Every function works on the images it is handed; callers give a few at a
time so that the float32 activations fit beside nothing else.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch

from .arith import Arith
from .box_head import ROIOutputs, box_head
from .code_generator import class_codes
from .fcos_decode import Grid, detect, location_grid
from .fcos_head import Dense, fcos_head
from .fpn import fpn
from .nms import multiclass_nms
from .resnet import resnet
from .roi_align import multilevel_roi_align
from .rpn import anchors, proposals, rpn_head


def normalize(images: torch.Tensor, cfg: Dict) -> torch.Tensor:
    mean = torch.tensor(cfg["MODEL.PIXEL_MEAN"], device=images.device)
    std = torch.tensor(cfg["MODEL.PIXEL_STD"], device=images.device)
    return ((images.float() - mean) / std).permute(0, 3, 1, 2)


def pyramid(sd, images: torch.Tensor, cfg: Dict, family: str,
            arith: Arith) -> List[torch.Tensor]:
    """uint8 canvases -> the family's pyramid maps, finest first."""
    feats_in = cfg["MODEL.FPN.IN_FEATURES"]
    feats = resnet(sd, normalize(images, cfg), arith,
                   cfg["MODEL.RESNETS.DEPTH"], feats_in)
    if family == "fcos":
        return fpn(sd, feats, arith, feats_in, "p6p7",
                   cfg["MODEL.FPN.TOP_LEVELS"])
    return fpn(sd, feats, arith, feats_in, "maxpool")


# ------------------------------------------------------------------ FCOS
def fcos_dense(sd, images, bank, cfg, arith) -> Dense:
    return fcos_head(sd, pyramid(sd, images, cfg, "fcos", arith), bank,
                     arith, cfg["MODEL.FCOS.NUM_CLS_CONVS"])


def fcos_grid(cfg, device) -> Grid:
    return location_grid(cfg["TPU.EVAL_CANVAS"], cfg["MODEL.FCOS.FPN_STRIDES"],
                         device)


def fcos_detect(dense: Dense, b: int, grid: Grid, image_hw, cfg):
    f = "MODEL.FCOS."
    return detect(dense, b, grid, image_hw, cfg[f + "INFERENCE_TH_TEST"],
                  cfg[f + "PRE_NMS_TOPK_TEST"], cfg[f + "NMS_TH"],
                  cfg[f + "POST_NMS_TOPK_TEST"])


# ------------------------------------------------------------- R-CNN
class RCNNImage(NamedTuple):
    """One image's ROI stage: its proposals, probabilities and boxes, and
    the kept (proposal, class) pairs in pick order."""
    proposals: torch.Tensor
    roi: ROIOutputs
    keep_prop: torch.Tensor
    keep_cls: torch.Tensor


ROI_STRIDES = (4, 8, 16, 32)
RPN_STRIDES = (4, 8, 16, 32, 64)


def rcnn_proposals(sd, feats, image_sizes: Sequence, cfg,
                   arith: Arith) -> List[torch.Tensor]:
    """The RPN's proposals (P, 4) of each image of the pyramid ``feats``."""
    logits, deltas = rpn_head(sd, feats, arith)
    anc, counts = anchors(cfg["TPU.EVAL_CANVAS"], RPN_STRIDES,
                          [s[0] for s in cfg["MODEL.ANCHOR_GENERATOR.SIZES"]],
                          cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0],
                          feats[0].device)
    return [proposals(logits, deltas, anc, counts, b, image_sizes[b],
                      cfg["MODEL.RPN.PRE_NMS_TOPK_TEST"],
                      cfg["MODEL.RPN.POST_NMS_TOPK_TEST"],
                      cfg["MODEL.RPN.NMS_THRESH"])
            for b in range(feats[0].shape[0])]


def rcnn_roi(sd, feats, b: int, props: torch.Tensor, image_hw, bank, cfg,
             arith: Arith) -> RCNNImage:
    """The ROI stage of image ``b`` on proposals ``props`` (P, 4): pooled
    features, box head, candidates above the threshold, NMS."""
    pooled = multilevel_roi_align(feats[:4], b, props, ROI_STRIDES,
                                  cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"])
    roi = box_head(sd, pooled, props, bank, image_hw, arith)
    n = roi.probs.shape[1]
    flat = roi.probs.reshape(-1)
    alive = torch.nonzero(flat > cfg["MODEL.ROI_HEADS.SCORE_THRESH_TEST"]
                          ).flatten()
    prop, cls = alive // n, alive % n
    keep = multiclass_nms(roi.boxes[prop], flat[alive], cls,
                          torch.ones_like(cls, dtype=torch.bool),
                          cfg["MODEL.ROI_HEADS.NMS_THRESH_TEST"],
                          cfg["TEST.DETECTIONS_PER_IMAGE"])
    return RCNNImage(props, roi, prop[keep], cls[keep])


def rcnn_detect(sd, images, image_sizes: Sequence, bank, cfg,
                arith: Arith) -> List[RCNNImage]:
    """Both stages of each image, on the reference's own proposals."""
    feats = pyramid(sd, images, cfg, "rcnn", arith)
    props = rcnn_proposals(sd, feats, image_sizes, cfg, arith)
    return [rcnn_roi(sd, feats, b, p, image_sizes[b], bank, cfg, arith)
            for b, p in enumerate(props)]


# ------------------------------------------------------- registration
def fcos_register(sd, images, boxes, cfg, arith) -> Dict[str, torch.Tensor]:
    """S support canvases and their boxes -> raw codes of S/shots classes."""
    feats = pyramid(sd, images, cfg, "fcos", arith)
    towers = len(cfg["MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS"])
    return class_codes(sd, feats, boxes.float(),
                       cfg["MODEL.FCOS.FPN_STRIDES"],
                       cfg["MODEL.META_LEARN.EVAL_SHOT"], arith, towers)
