"""Module-by-module parity of sylph_tpu_torch against sylph_tpu (CPU, fp32).

Each flax module is initialized, its params are replaced by seeded random
values, and the same params go to the port through
``state_dict_from_jax``; the same numpy inputs go through both.
Tolerances: ROIAlign atol 1e-5; ResNet + FPN rtol/atol 1e-4; the FCOS head
and the CodeGenerator rtol 1e-3, atol 5e-3 (XLA and torch sum the conv
products in different orders); decode equal in indices and flags, boxes
and scores to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models.code_generator import CodeGeneratorHead as JaxCodeGen
from sylph_tpu.models.fcos_head import FCOSHead as JaxHead
from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu.ops.decode import DecodeCfg as JaxDecodeCfg
from sylph_tpu.ops.decode import decode_proposals as jax_decode
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel
from sylph_tpu.ops.roi_align import roi_align as jax_roi_align
from sylph_tpu_torch.models.code_generator import CodeGeneratorHead
from sylph_tpu_torch.models.fcos_head import FCOSHead
from sylph_tpu_torch.models.meta_arch import MetaOneStageDetector
from sylph_tpu_torch.ops.decode import DecodeCfg, decode_proposals
from sylph_tpu_torch.ops.locations import build_location_grid
from sylph_tpu_torch.ops.roi_align import multilevel_roi_align, roi_align
from sylph_tpu_torch.utils.convert_weights import (load_jax_params,
                                                   state_dict_from_jax)

from test_ops import np_roi_align
from torch_port_util import randomize

STRIDES = (8, 16, 32, 64, 128)
CANVAS = (64, 128)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def flat_levels(level_shapes, rng, c=256, b=2):
    """Random NHWC FPN maps for the given (h, w) levels."""
    return [rng.randn(b, h, w, c).astype(np.float32) for h, w in level_shapes]


# ------------------------------------------------------------------ ROIAlign
ROI_BOXES = np.array([
    [10.0, 12.0, 60.0, 50.0],     # grid 1x1
    [2.0, 2.0, 150.0, 110.0],     # mixed axes
    [-8.0, -4.0, 150.0, 100.0],   # partially outside
    [0.0, 0.0, 158.0, 126.0],     # grid 5x6: capped at 4, exact at 6
    [30.0, 20.0, 30.0, 80.0],     # degenerate width -> zeros
    [-40.0, -30.0, 400.0, 300.0],  # grid above the max_grid=4 cap
], np.float32)


def test_roi_align_matches_jax_with_cap():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 32, 40, 8).astype(np.float32)
    bidx = np.array([0, 1, 0, 1, 0, 1])
    want = np.stack([
        np.asarray(jax_roi_align(jnp.asarray(feat[b]), jnp.asarray(box[None]),
                                 spatial_scale=0.25, output_size=7))[0]
        for b, box in zip(bidx, ROI_BOXES)])
    got = roi_align(nchw(feat), torch.from_numpy(ROI_BOXES),
                    torch.from_numpy(bidx), spatial_scale=0.25,
                    output_size=7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)
    assert np.all(got[4].numpy() == 0)


def test_roi_align_matches_detectron2_oracle():
    """Exact adaptive grids (max_grid large enough) against np_roi_align."""
    rng = np.random.RandomState(3)
    feat = rng.randn(1, 32, 40, 8).astype(np.float32)
    boxes = ROI_BOXES[:5]
    got = roi_align(nchw(feat), torch.from_numpy(boxes),
                    torch.zeros(len(boxes), dtype=torch.long),
                    spatial_scale=0.25, output_size=7, max_grid=6)
    want = np_roi_align(feat[0], boxes, 0.25, 7, 0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_multilevel_roi_align_matches_jax():
    rng = np.random.RandomState(1)
    feats = [rng.randn(64 // 2 ** i, 64 // 2 ** i, 4).astype(np.float32)
             for i in range(5)]
    boxes = np.array([[0, 0, 50, 50], [3, 5, 500, 450], [10, 10, 200, 90],
                      [20, 20, 20, 60]], np.float32)
    valid = np.array([True, True, False, True])
    want = jax_multilevel([jnp.asarray(f) for f in feats], STRIDES,
                          jnp.asarray(boxes), jnp.asarray(valid),
                          output_size=7)
    got = multilevel_roi_align(
        [nchw(f[None]) for f in feats], STRIDES, torch.from_numpy(boxes),
        torch.from_numpy(valid), torch.zeros(4, dtype=torch.long),
        output_size=7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    assert np.all(got[2].numpy() == 0)


# ------------------------------------------------------------ ResNet + FPN
def test_backbone_fpn_matches_jax():
    rng = np.random.RandomState(4)
    # Pixels scattered around the BGR mean, so activations stay O(1) and
    # the 1e-4 tolerance measures the port, not fp32 rounding of O(100)
    # activations.
    mean = np.array([103.530, 116.280, 123.675], np.float32)
    images = (mean + 2.0 * rng.randn(2, *CANVAS, 3)).astype(np.float32)
    jmodel = JaxDetector(depth=18, num_classes=4, compute_dtype=jnp.float32,
                         code_generator_name="none")
    params = randomize(jmodel.init(jax.random.PRNGKey(0),
                                   jnp.asarray(images))["params"], rng)
    want = jmodel.apply({"params": params}, jnp.asarray(images),
                        method=JaxDetector.extract_features)
    model = MetaOneStageDetector(depth=18, num_classes=4,
                                 compute_dtype=torch.float32,
                                 code_generator_name="none")
    load_jax_params(model, params)
    with torch.no_grad():
        got = model.extract_features(torch.from_numpy(images))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- FCOS head
@pytest.mark.parametrize("conditional", [False, True])
def test_fcos_head_matches_jax(conditional):
    rng = np.random.RandomState(5)
    levels = [(8, 16), (4, 8), (2, 4), (1, 2), (1, 1)]
    feats = flat_levels(levels, rng)
    code = {"cls_conv": rng.randn(7, 256).astype(np.float32) / 16,
            "cls_bias": rng.randn(7).astype(np.float32)}
    jhead = JaxHead(num_classes=6, num_cls_convs=2, num_box_convs=2,
                    compute_dtype=jnp.float32)
    params = randomize(jhead.init(jax.random.PRNGKey(0),
                                  [jnp.asarray(f) for f in feats])["params"],
                       rng)
    jcode = ({k: jnp.asarray(v) for k, v in code.items()}
             if conditional else None)
    want = jhead.apply({"params": params}, [jnp.asarray(f) for f in feats],
                       class_code=jcode)
    head = FCOSHead(num_classes=6, num_cls_convs=2, num_box_convs=2,
                    compute_dtype=torch.float32)
    head.load_state_dict(state_dict_from_jax(params), strict=True)
    tcode = ({k: torch.from_numpy(v) for k, v in code.items()}
             if conditional else None)
    with torch.no_grad():
        got = head([nchw(f) for f in feats], class_code=tcode)
    assert got.logits.shape == (2, 8 * 16 + 32 + 8 + 2 + 1,
                                7 if conditional else 6)
    for name in ("logits", "reg", "ctrness", "iou"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-3, atol=5e-3, err_msg=name)


# ------------------------------------------------------------ CodeGenerator
CODEGEN_VARIANTS = {
    "finetune": dict(),
    "compress_code_w_max": dict(compress_code_w_max=True, bias_layer=()),
    "weight_layer": dict(weight_layer=("", "", 1), scale_layer=()),
    "gn_ln_tanh_meta_bias": dict(
        tower_layers=(("GN", "ReLU"), ("LN", "Tanh")),
        cls_layer=("GN", "", 1), bias_layer=("GN", "", 1), meta_bias=True),
}


@pytest.mark.parametrize("variant", sorted(CODEGEN_VARIANTS))
def test_code_generator_matches_jax(variant):
    rng = np.random.RandomState(sorted(CODEGEN_VARIANTS).index(variant))
    shots, n_cls = 3, 2
    s = shots * n_cls
    levels = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    feats = flat_levels(levels, rng, b=s)
    xy = rng.uniform(0, 60, (s, 2))
    wh = rng.uniform(8, 120, (s, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    valid = np.ones((s,), bool)
    kwargs = CODEGEN_VARIANTS[variant]
    jgen = JaxCodeGen(compute_dtype=jnp.float32, **kwargs)
    jfeats = [jnp.asarray(f) for f in feats]
    params = randomize(jgen.init(
        jax.random.PRNGKey(0), jfeats, jnp.asarray(boxes),
        jnp.asarray(valid), num_shots=shots, training=True)["params"], rng)
    raw = jgen.apply({"params": params}, jfeats, jnp.asarray(boxes),
                     jnp.asarray(valid), num_shots=shots, training=False)
    norm = jgen.apply({"params": params}, class_codes=raw)

    gen = CodeGeneratorHead(compute_dtype=torch.float32, **kwargs)
    gen.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got_raw = gen([nchw(f) for f in feats], torch.from_numpy(boxes),
                      torch.from_numpy(valid), num_shots=shots)
        got_norm = gen.normalize(got_raw)
    assert set(got_raw) == set(raw)
    for key in raw:
        np.testing.assert_allclose(got_raw[key].numpy(), np.asarray(raw[key]),
                                   rtol=1e-3, atol=5e-3, err_msg=key)
    for key in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(got_norm[key].numpy(),
                                   np.asarray(norm[key]), rtol=1e-3,
                                   atol=5e-3, err_msg=key)
    assert got_norm["cls_conv"].shape == (n_cls, 256)


# ------------------------------------------------------------------- decode
DECODE_VARIANTS = {
    "default": dict(),
    "iou": dict(box_quality=("iou",)),
    "ctrness_iou": dict(box_quality=("ctrness", "iou")),
    "thresh_with_ctr": dict(thresh_with_ctr=True),
    "owd": dict(owd=True),
    "class_valid": dict(),
    "small_topk": dict(pre_nms_topk=7, post_nms_topk=5),
}


@pytest.mark.parametrize("variant", sorted(DECODE_VARIANTS))
def test_decode_matches_jax(variant):
    rng = np.random.RandomState(sorted(DECODE_VARIANTS).index(variant) + 40)
    canvas = (96, 160)
    grid = jax_grid(canvas, STRIDES, [64, 128, 256, 512])
    tgrid = build_location_grid(canvas, STRIDES, [64, 128, 256, 512])
    for f in ("locations", "strides", "level_ids", "size_ranges"):
        np.testing.assert_array_equal(getattr(tgrid, f), getattr(grid, f))
    assert tgrid.level_sizes == grid.level_sizes
    b, k, n = 2, grid.num_locations, 5
    logits = (rng.randn(b, k, n) * 2 - 2).astype(np.float32)
    reg = np.abs(rng.randn(b, k, 4) * 3).astype(np.float32)
    ctr = rng.randn(b, k).astype(np.float32)
    iou = rng.randn(b, k).astype(np.float32)
    sizes = np.array([[90, 150], [96, 120]], np.int32)
    class_valid = (np.array([True, False, True, True, False])
                   if variant == "class_valid" else None)
    splits = tuple(h * w for h, w in grid.level_sizes)
    kwargs = dict(pre_nms_topk=60, post_nms_topk=30)
    kwargs.update(DECODE_VARIANTS[variant])

    want = jax_decode(
        jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(ctr),
        jnp.asarray(iou), jnp.asarray(grid.locations),
        jnp.asarray(grid.strides), jnp.asarray(grid.level_ids),
        jnp.asarray(sizes), JaxDecodeCfg(**kwargs), splits,
        class_valid=None if class_valid is None else jnp.asarray(class_valid))
    got = decode_proposals(
        torch.from_numpy(logits), torch.from_numpy(reg),
        torch.from_numpy(ctr), torch.from_numpy(iou),
        torch.from_numpy(tgrid.locations), torch.from_numpy(tgrid.strides),
        torch.from_numpy(sizes), DecodeCfg(**kwargs), splits,
        class_valid=None if class_valid is None
        else torch.from_numpy(class_valid)).numpy()
    want = jax.tree.map(np.asarray, want)

    np.testing.assert_array_equal(got.valid, want.valid)
    keep = want.valid
    assert keep.sum() > 0
    np.testing.assert_array_equal(got.classes[keep], want.classes[keep])
    np.testing.assert_array_equal(got.fpn_levels[keep], want.fpn_levels[keep])
    np.testing.assert_array_equal(got.locations[keep], want.locations[keep])
    np.testing.assert_allclose(got.boxes[keep], want.boxes[keep], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    if class_valid is not None:
        assert class_valid[got.classes[keep]].all()
