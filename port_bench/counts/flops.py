"""Model FLOPs of the cells' work, counted from a configuration's shapes.

Two FLOPs a multiply-add, over every convolution (backbone, FPN, FCOS
towers and heads, RPN head, code generator), the box head's fully connected
layers and ``bbox_pred``, and the conditional classifier's products (with
Faster R-CNN's background column). Norms, activations, ROIAlign, decoding
and NMS are left out. The count depends on the configuration alone, not on
which kernels do the work. ``cfg`` is a configuration's ``cfg`` table.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..reference.resnet import BLOCKS

Shape = Tuple[int, int, int]  # (channels, height, width)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet_macs(depth: int, h: int, w: int) -> Tuple[int, Dict[str, Shape]]:
    """Multiply-adds of the ResNet on an (h, w) canvas, and each stage's
    output shape."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs = h * w * 64 * 3 * 49
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    c, out_c, mid, shapes = 64, 256, 64, {}
    for si, n in enumerate(BLOCKS[depth]):
        for bi in range(n):
            s = 2 if (si > 0 and bi == 0) else 1
            h, w = _out(h, 1, s, 0), _out(w, 1, s, 0)
            macs += h * w * mid * (c + 9 * mid + out_c)
            if bi == 0:
                macs += h * w * out_c * c
            c = out_c
        shapes[f"res{si + 2}"] = (c, h, w)
        out_c, mid = out_c * 2, mid * 2
    return macs, shapes


def fpn_macs(shapes: Dict[str, Shape], in_features: Sequence[str],
             top: str, top_levels: int = 2, channels: int = 256
             ) -> Tuple[int, List[Tuple[int, int]]]:
    """Multiply-adds of the FPN, and each output level's (height, width)."""
    macs, sizes = 0, []
    for f in in_features:
        c, h, w = shapes[f]
        macs += h * w * channels * (c + 9 * channels)
        sizes.append((h, w))
    h, w = sizes[-1]
    for _ in range(top_levels if top == "p6p7" else 1):
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        if top == "p6p7":
            macs += h * w * channels * channels * 9
        sizes.append((h, w))
    return macs, sizes


def pyramid_macs(cfg: Dict, canvas: Sequence[int]
                 ) -> Tuple[int, List[Tuple[int, int]]]:
    """Multiply-adds of the backbone and FPN, and each level's (height,
    width): convolved P6/P7 where ``cfg`` holds ``MODEL.FPN.TOP_LEVELS``, a
    max-pooled P6 otherwise (as ``reference/detector.py::pyramid``)."""
    bb, shapes = resnet_macs(cfg["MODEL.RESNETS.DEPTH"], *canvas)
    if "MODEL.FPN.TOP_LEVELS" in cfg:
        fp, sizes = fpn_macs(shapes, cfg["MODEL.FPN.IN_FEATURES"], "p6p7",
                             cfg["MODEL.FPN.TOP_LEVELS"])
    else:
        fp, sizes = fpn_macs(shapes, cfg["MODEL.FPN.IN_FEATURES"], "maxpool")
    return bb + fp, sizes


def fcos_query_flops(cfg: Dict, bank_rows: int) -> Dict[str, int]:
    """One query image of Meta-FCOS at the eval canvas."""
    bb, sizes = pyramid_macs(cfg, cfg["TPU.EVAL_CANVAS"])
    head, convs = 0, cfg["MODEL.FCOS.NUM_CLS_CONVS"]
    for h, w in sizes:
        head += h * w * 256 * (2 * convs * 256 * 9 + (4 + 1 + 1) * 9
                               + bank_rows)
    return {"backbone_fpn": 2 * bb, "head": 2 * head,
            "total": 2 * (bb + head)}


def rcnn_query_flops(cfg: Dict, bank_rows: int) -> Dict[str, int]:
    """One query image of Meta Faster R-CNN at the eval canvas, with
    ``MODEL.RPN.POST_NMS_TOPK_TEST`` proposals through the box head."""
    bb, sizes = pyramid_macs(cfg, cfg["TPU.EVAL_CANVAS"])
    a = len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])
    rpn = sum(h * w * 256 * (256 * 9 + a + 4 * a) for h, w in sizes)
    p = cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]
    fc = cfg["MODEL.ROI_BOX_HEAD.FC_DIM"]
    res = cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    box = p * fc * (256 * res * res + fc + (bank_rows + 1) + 4)
    return {"backbone_fpn": 2 * bb, "rpn": 2 * rpn, "box_head": 2 * box,
            "total": 2 * (bb + rpn + box)}


def fcos_register_flops(cfg: Dict) -> Dict[str, int]:
    """One class registered by Meta-FCOS: ``EVAL_SHOT`` support canvases
    through the backbone and FPN, and the code generator on each shot's
    pooled 7 x 7 box."""
    shots = cfg["MODEL.META_LEARN.EVAL_SHOT"]
    bb, _ = pyramid_macs(cfg, cfg["TPU.SUPPORT_CANVAS"])
    width = cfg["MODEL.META_LEARN.CODE_GENERATOR.OUT_CHANNEL"]
    towers = len(cfg["MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS"])
    cg = 49 * 256 * 9 * (towers * 256 + width + 1)
    return {"backbone_fpn": 2 * shots * bb, "code_generator": 2 * shots * cg,
            "total": 2 * shots * (bb + cg)}
