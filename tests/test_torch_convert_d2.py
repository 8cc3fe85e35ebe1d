"""The port's detectron2 conversion (sylph_tpu_torch/utils/convert_d2.py)
against the JAX package's, leaf for leaf, on the in-memory detectron2-shaped
state dicts of tests/test_convert.py and tests/test_roi_encoder_convert.py:

  * the FCOS family (backbone with FrozenBN folding, FPN, towers, heads,
    scales), the CodeGenerator, the ROIEncoder and the two-stage
    ``rpn_head`` / ``box_head`` (linear and TFA cosine): equal trees, equal
    ``state_dict_from_jax`` results and equal ``conversion_report``s;
  * ``.pth`` and ``.pkl`` files read alike by both ``load_torch_state_dict``;
  * the ROIEncoder converted from a ``.pth`` gives JAX's codes in the port;
  * MODEL.WEIGHTS naming a ``.pth`` or a ``.pkl`` loads into a port model.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models.roi_encoder import ROIEncoder as JaxROIEncoder
from sylph_tpu.utils import convert_weights as jconv
from sylph_tpu_torch.models.roi_encoder import ROIEncoder
from sylph_tpu_torch.utils import convert_d2
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from test_convert import _rand_bn_stats
from test_roi_encoder_convert import _state_dict, _torch_roi_encoder_modules
from torch_port_util import (few_torch_threads, flat_paths,  # noqa: F401
                             shrink_meta_cfg)


def _fcos_sd(rng):
    """A bottleneck, the FPN, 2-conv GN towers, the four heads, scales, a
    misnamed tower key and bookkeeping keys, under detectron2 names."""
    sd = {}
    for name, (i, o, k) in {"conv1": (8, 4, 1), "conv2": (4, 4, 3),
                            "conv3": (4, 16, 1),
                            "shortcut": (8, 16, 1)}.items():
        sd[f"backbone.bottom_up.res2.0.{name}.weight"] = \
            rng.randn(o, i, k, k).astype(np.float32)
        for kk, vv in _rand_bn_stats(rng, o).items():
            sd[f"backbone.bottom_up.res2.0.{name}.norm.{kk}"] = vv
    sd["backbone.bottom_up.stem.conv1.weight"] = \
        rng.randn(8, 3, 7, 7).astype(np.float32)
    for kk, vv in _rand_bn_stats(rng, 8).items():
        sd[f"backbone.bottom_up.stem.conv1.norm.{kk}"] = vv
    for lvl in (3, 4, 5):
        for kind in ("lateral", "output"):
            sd[f"backbone.fpn_{kind}{lvl}.weight"] = \
                rng.randn(8, 8, 1, 1).astype(np.float32)
            sd[f"backbone.fpn_{kind}{lvl}.bias"] = \
                rng.randn(8).astype(np.float32)
    for p in (6, 7):
        sd[f"backbone.top_block.p{p}.weight"] = \
            rng.randn(8, 8, 3, 3).astype(np.float32)
        sd[f"backbone.top_block.p{p}.bias"] = rng.randn(8).astype(np.float32)
    head = "proposal_generator.fcos_head"
    for tower in ("cls_tower", "bbox_tower"):
        for i in range(2):
            sd[f"{head}.{tower}.{3 * i}.weight"] = \
                rng.randn(8, 8, 3, 3).astype(np.float32)
            sd[f"{head}.{tower}.{3 * i}.bias"] = \
                rng.randn(8).astype(np.float32)
            sd[f"{head}.{tower}.{3 * i + 1}.weight"] = \
                rng.randn(8).astype(np.float32)
            sd[f"{head}.{tower}.{3 * i + 1}.bias"] = \
                rng.randn(8).astype(np.float32)
    for mod, o in (("cls_logits", 5), ("bbox_pred", 4), ("ctrness", 1),
                   ("iou_overlap", 1)):
        sd[f"{head}.{mod}.weight"] = rng.randn(o, 8, 3, 3).astype(np.float32)
        sd[f"{head}.{mod}.bias"] = rng.randn(o).astype(np.float32)
    for i in range(5):
        sd[f"{head}.scales.{i}.scale"] = rng.rand(1).astype(np.float32)
    sd[f"{head}.cls_towerr.0.weight"] = rng.randn(8, 8, 3, 3).astype(
        np.float32)
    sd["pixel_mean"] = np.zeros(3, np.float32)
    sd[f"{head}.cls_tower.0.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def _codegen_sd(rng):
    cg = "code_generator.code_generator_head"
    sd = {}
    for ci, gi in ((0, 1), (3, 4)):
        sd[f"{cg}.support_set_shared_tower.{ci}.weight"] = \
            rng.randn(16, 16, 3, 3).astype(np.float32)
        sd[f"{cg}.support_set_shared_tower.{ci}.bias"] = \
            rng.randn(16).astype(np.float32)
        sd[f"{cg}.support_set_shared_tower.{gi}.weight"] = \
            rng.randn(16).astype(np.float32)
        sd[f"{cg}.support_set_shared_tower.{gi}.bias"] = \
            rng.randn(16).astype(np.float32)
    for d2 in ("support_set_cls_conv", "support_set_cls_bias"):
        sd[f"{cg}.{d2}.0.weight"] = rng.randn(16, 16, 3, 3).astype(np.float32)
        sd[f"{cg}.{d2}.0.bias"] = rng.randn(16).astype(np.float32)
    sd[f"{cg}.post_norm.weight"] = rng.randn(16).astype(np.float32)
    sd[f"{cg}.post_norm.bias"] = rng.randn(16).astype(np.float32)
    sd[f"{cg}.conv_scale.scale"] = np.asarray(1.5, np.float32)
    sd[f"{cg}.bias_scale.scale"] = np.asarray(0.7, np.float32)
    return sd


def _rcnn_sd(rng, cosine):
    c, p, fc = 8, 7, 16
    sd = {"roi_heads.box_head.fc1.weight":
          rng.randn(fc, c * p * p).astype(np.float32),
          "roi_heads.box_head.fc1.bias": rng.randn(fc).astype(np.float32),
          "roi_heads.box_head.fc2.weight": rng.randn(fc, fc).astype(
              np.float32),
          "roi_heads.box_head.fc2.bias": rng.randn(fc).astype(np.float32),
          "roi_heads.box_predictor.cls_score.weight":
          rng.randn(6, fc).astype(np.float32),
          "roi_heads.box_predictor.bbox_pred.weight":
          rng.randn(4, fc).astype(np.float32),
          "roi_heads.box_predictor.bbox_pred.bias":
          rng.randn(4).astype(np.float32)}
    if cosine:
        sd["roi_heads.box_predictor.scale"] = np.asarray([20.0], np.float32)
    else:
        sd["roi_heads.box_predictor.cls_score.bias"] = \
            rng.randn(6).astype(np.float32)
    for d2, o in (("conv", c), ("objectness_logits", 3),
                  ("anchor_deltas", 12)):
        sd[f"proposal_generator.rpn_head.{d2}.weight"] = \
            rng.randn(o, c, 3 if d2 == "conv" else 1,
                      3 if d2 == "conv" else 1).astype(np.float32)
        sd[f"proposal_generator.rpn_head.{d2}.bias"] = \
            rng.randn(o).astype(np.float32)
    return sd


def _roi_encoder_sd(rng):
    return _state_dict(_torch_roi_encoder_modules(rng))


FAMILIES = {"fcos": (_fcos_sd, dict(num_tower_convs=2)),
            "code_generator": (_codegen_sd, {}),
            "roi_encoder": (_roi_encoder_sd, {}),
            "rcnn_linear": (lambda r: _rcnn_sd(r, False),
                            dict(roi_box_channels=8)),
            "rcnn_cosine": (lambda r: _rcnn_sd(r, True),
                            dict(roi_box_channels=8))}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_conversion_equals_jax_leaf_for_leaf(family):
    make, kw = FAMILIES[family]
    sd = make(np.random.RandomState(sorted(FAMILIES).index(family)))
    jrep, trep = {}, {}
    want = jconv.convert_detectron2_checkpoint(dict(sd), report=jrep, **kw)
    got = convert_d2.convert_detectron2_checkpoint(dict(sd), report=trep, **kw)
    fw, fg = flat_paths(want), flat_paths(got)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert np.asarray(fg[k]).dtype == np.asarray(fw[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(fw[k]),
                                      err_msg=k)
    assert trep == jrep
    sw, sg = state_dict_from_jax(want), state_dict_from_jax(got)
    assert sorted(sg) == sorted(sw)
    for k in sw:
        assert torch.equal(sg[k], sw[k]), k
    if family == "fcos":
        assert "proposal_generator.fcos_head.cls_towerr.0.weight" \
            in trep["unmatched"] and "pixel_mean" in trep["ignored"]
    else:
        assert not trep["unmatched"], trep["unmatched"]


def test_unknown_backbone_scheme_raises_in_both():
    sd = {"module.backbone.body.res2.0.conv1.weight":
          np.zeros((64, 64, 1, 1), np.float32)}
    for conv in (jconv, convert_d2):
        with pytest.raises(ValueError, match="name schemes"):
            conv.convert_detectron2_checkpoint(sd)


def test_pth_and_pkl_files_read_alike(tmp_path):
    """A ``{'model': sd}`` ``.pth`` of tensors and an ImageNet-scheme
    ``.pkl`` of numpy arrays (no ``backbone.bottom_up.`` prefix) load and
    convert to the same trees in both packages."""
    rng = np.random.RandomState(9)
    sd = _fcos_sd(rng)
    torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}}, tmp_path / "m.pth")
    pkl = {k[len("backbone.bottom_up."):]: v for k, v in sd.items()
           if k.startswith("backbone.bottom_up.")}
    with open(tmp_path / "r.pkl", "wb") as f:
        pickle.dump({"model": pkl, "__author__": "x"}, f)
    for name in ("m.pth", "r.pkl"):
        path = str(tmp_path / name)
        a = jconv.load_torch_state_dict(path)
        b = convert_d2.load_torch_state_dict(path)
        assert sorted(a) == sorted(b)
        fa = flat_paths(jconv.convert_detectron2_checkpoint(a,
                                                            num_tower_convs=2))
        fb = flat_paths(convert_d2.convert_detectron2_checkpoint(
            b, num_tower_convs=2))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    assert "stem_conv1" in convert_d2.convert_detectron2_checkpoint(
        convert_d2.load_torch_state_dict(str(tmp_path / "r.pkl")))["backbone"]


def test_roi_encoder_from_pth_gives_jax_codes(tmp_path):
    """The reference-named ROIEncoder (a GN-free tokenizer conv, two encoder
    layers, two-FC heads) saved as a ``.pth``, converted, loaded with
    ``strict=True``: the port's codes equal JAX's from the same tree."""
    sd = _roi_encoder_sd(np.random.RandomState(0))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "enc.pth")
    tree = convert_d2.convert_detectron2_checkpoint(
        convert_d2.load_torch_state_dict(str(tmp_path / "enc.pth")))
    kw = dict(tokenizer_num_conv=1, tokenizer_num_fc=1, transformer_layers=2,
              head_num_fc=2)
    port = ROIEncoder(compute_dtype=torch.float32, **kw)
    port.load_state_dict(state_dict_from_jax(tree["code_generator"]),
                         strict=True)
    rng = np.random.RandomState(1)
    feats = [rng.randn(4, h, h, 256).astype(np.float32)
             for h in (8, 4, 2, 1, 1)]
    boxes = np.tile(np.array([[4, 6, 40, 50]], np.float32), (4, 1))
    valid = np.ones((4,), bool)
    jm = JaxROIEncoder(compute_dtype=jnp.float32, **kw)
    want = jax.jit(lambda p, f: jm.apply(
        {"params": p}, f, jnp.asarray(boxes), jnp.asarray(valid), 2,
        training=False))(tree["code_generator"],
                         [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([torch.from_numpy(f.transpose(0, 3, 1, 2).copy())
                    for f in feats], torch.from_numpy(boxes),
                   torch.from_numpy(valid), 2)
    for k in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_model_weights_pth_and_pkl_load(tmp_path):
    """MODEL.WEIGHTS = a ``.pth`` of the model's head (detectron2 names) or
    an ImageNet ``.pkl`` of its stem: ``build_model`` loads the converted
    leaves and keeps the rest of the seeded init."""
    from sylph_tpu_torch import get_default_cfg
    from sylph_tpu_torch.runner import MetaFCOSRunner

    rng = np.random.RandomState(2)
    head = "proposal_generator.fcos_head"
    sd = {f"{head}.bbox_pred.weight": rng.randn(4, 256, 3, 3),
          f"{head}.bbox_pred.bias": rng.randn(4)}
    torch.save({"model": {k: torch.from_numpy(v.astype(np.float32))
                          for k, v in sd.items()}}, tmp_path / "h.pth")
    stem = {"stem.conv1.weight": rng.randn(64, 3, 7, 7).astype(np.float32),
            **{f"stem.conv1.norm.{k}": v
               for k, v in _rand_bn_stats(rng, 64).items()}}
    with open(tmp_path / "s.pkl", "wb") as f:
        pickle.dump({"model": stem}, f, protocol=2)
    runner = MetaFCOSRunner(device="cpu")
    cfg = shrink_meta_cfg(get_default_cfg(), episodic=False)
    fresh = runner.build_model(cfg).state_dict()
    for name, keys in (("h.pth", ("fcos_head.bbox_pred.weight",
                                  "fcos_head.bbox_pred.bias")),
                       ("s.pkl", ("backbone.stem_conv1.weight",
                                  "backbone.stem_bn1.scale",
                                  "backbone.stem_bn1.bias"))):
        cfg.MODEL.WEIGHTS = str(tmp_path / name)
        got = runner.build_model(cfg).state_dict()
        want = state_dict_from_jax(convert_d2.convert_detectron2_checkpoint(
            convert_d2.load_torch_state_dict(cfg.MODEL.WEIGHTS)))
        for k, v in got.items():
            ref = want[k] if k in keys else fresh[k]
            assert torch.equal(v, ref), k
