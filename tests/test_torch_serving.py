"""The port's serving slice as a whole against the JAX package (CPU, fp32).

R-50 weights come from ``tests/torch_reference.py::make_meta_fcos_sd``,
go to the JAX package through ``convert_detectron2_checkpoint`` (as in
``tests/test_golden_full.py``) and on to the port through
``state_dict_from_jax``. Then register -> serve runs in both packages on the
same numpy inputs: raw codes, normalized codes and dense outputs agree to
rtol 1e-3 / atol 5e-3, detections as test_golden_full holds them (equal
counts > 0, boxes to 0.05, scores to 1e-3, equal classes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.config import get_default_cfg as jax_default_cfg
from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu.ops.decode import decode_proposals as jax_decode
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.predictor import SylphPredictor as JaxPredictor
from sylph_tpu.runner.meta_fcos_runner import \
    _decode_cfg as jax_decode_cfg
from sylph_tpu.runner.meta_fcos_runner import \
    build_model_from_cfg as jax_build_model
from sylph_tpu.train.checkpoint import merge_params
from sylph_tpu.utils.convert_weights import convert_detectron2_checkpoint
from sylph_tpu_torch import build_model_from_cfg, get_default_cfg
from sylph_tpu_torch.ops.decode import decode_proposals
from sylph_tpu_torch.predictor import ClassCodeBank, SylphPredictor
from sylph_tpu_torch.runner import _decode_cfg
from sylph_tpu_torch.utils.convert_weights import load_jax_params

from torch_port_util import merge_trees, to_numpy
from torch_reference import make_meta_fcos_sd

CONFIG = "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml"
CANVAS = (128, 256)
SUPPORT_CANVAS = (128, 128)
SHOTS, N_CLS = 2, 2
TOL = dict(rtol=1e-3, atol=5e-3)


def shrink(cfg):
    """The finetune config at test size: fp32, small canvases. With random
    weights the class scores stay below 0.02, so the candidate threshold
    drops to 0.01 to leave a handful of detections to compare."""
    cfg.merge_from_file(CONFIG)
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.01
    cfg.TPU.EVAL_CANVAS = list(CANVAS)
    cfg.TPU.SUPPORT_CANVAS = list(SUPPORT_CANVAS)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.INPUT.MIN_SIZE_TEST = CANVAS[0]
    cfg.INPUT.MAX_SIZE_TEST = CANVAS[1]
    return cfg


@pytest.fixture(scope="module")
def both():
    rng = np.random.RandomState(7)
    sd = make_meta_fcos_sd(rng, num_classes=60)
    jcfg = shrink(jax_default_cfg())
    jmodel = jax_build_model(jcfg)
    query = (rng.rand(1, *CANVAS, 3) * 255).astype(np.float32)
    support = (rng.rand(SHOTS * N_CLS, *SUPPORT_CANVAS, 3) * 255) \
        .astype(np.float32)
    boxes = np.array([[12.0, 10.0, 80.0, 90.0],
                      [30.0, 20.0, 100.0, 110.0],
                      [5.0, 6.0, 120.0, 96.0],
                      [40.0, 32.0, 104.0, 120.0]], np.float32)
    key = jax.random.PRNGKey(0)
    base_init = jax.jit(lambda r: jmodel.init(r, jnp.asarray(query)))(key)
    epi_init = jax.jit(lambda r: jmodel.init(
        r, jnp.asarray(support), jnp.asarray(boxes),
        jnp.ones((len(boxes),), bool), jnp.asarray(query), SHOTS,
        method=JaxDetector.forward_episodic_train))(key)
    params = merge_params(
        merge_trees(to_numpy(base_init["params"]),
                    to_numpy(epi_init["params"])),
        convert_detectron2_checkpoint(sd))

    tcfg = shrink(get_default_cfg())
    model = load_jax_params(build_model_from_cfg(tcfg, device="cpu"), params)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, tcfg=tcfg,
                model=model, query=query, support=support, boxes=boxes)


def assert_detections_match(got, want):
    """test_golden_full's per-box criterion on (boxes, scores, classes)."""
    kg, kw = got["valid"], want["valid"]
    assert kg.sum() == kw.sum() and kw.sum() > 0
    np.testing.assert_allclose(got["boxes"][kg], want["boxes"][kw],
                               atol=0.05)
    np.testing.assert_allclose(got["scores"][kg], want["scores"][kw],
                               atol=1e-3)
    np.testing.assert_array_equal(got["classes"][kg], want["classes"][kw])


def test_register_then_serve_matches_jax(both):
    jmodel, params = both["jmodel"], both["params"]
    query, support, boxes = both["query"], both["support"], both["boxes"]
    valid = np.ones((len(boxes),), bool)

    def jax_chain(p, q, s, b):
        raw = jmodel.apply({"params": p}, s, b, jnp.asarray(valid), SHOTS,
                           False, method=JaxDetector.forward_class_code)
        code = jmodel.apply({"params": p}, raw,
                            method=JaxDetector.normalize_code)
        out = jmodel.apply({"params": p}, q, code,
                           method=JaxDetector.forward_instances)
        return raw, code, out

    raw, code, out = jax.jit(jax_chain)(params, jnp.asarray(query),
                                        jnp.asarray(support),
                                        jnp.asarray(boxes))
    model = both["model"]
    with torch.no_grad():
        t_raw = model.forward_class_code(
            torch.from_numpy(support), torch.from_numpy(boxes),
            torch.from_numpy(valid), SHOTS)
        t_code = model.normalize_code(t_raw)
        t_out = model.forward_instances(torch.from_numpy(query), t_code)

    for key in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(t_raw[key].numpy(), np.asarray(raw[key]),
                                   err_msg=f"raw {key}", **TOL)
        np.testing.assert_allclose(t_code[key].numpy(),
                                   np.asarray(code[key]),
                                   err_msg=f"normalized {key}", **TOL)
    for name in ("logits", "reg", "ctrness", "iou"):
        np.testing.assert_allclose(getattr(t_out, name).numpy(),
                                   np.asarray(getattr(out, name)),
                                   err_msg=name, **TOL)

    grid = jax_grid(CANVAS, (8, 16, 32, 64, 128), [64, 128, 256, 512])
    splits = tuple(h * w for h, w in grid.level_sizes)
    size = np.array([[CANVAS[0], CANVAS[1]]], np.int32)
    det_j = jax.tree.map(np.asarray, jax_decode(
        out.logits, out.reg, out.ctrness, out.iou,
        jnp.asarray(grid.locations), jnp.asarray(grid.strides),
        jnp.asarray(grid.level_ids), jnp.asarray(size),
        jax_decode_cfg(both["jcfg"]), splits))
    det_t = decode_proposals(
        t_out.logits, t_out.reg, t_out.ctrness, t_out.iou,
        torch.from_numpy(grid.locations), torch.from_numpy(grid.strides),
        torch.from_numpy(size), _decode_cfg(both["tcfg"]), splits).numpy()
    assert_detections_match(
        {k: getattr(det_t, k)[0] for k in ("valid", "boxes", "scores",
                                           "classes")},
        {k: getattr(det_j, k)[0] for k in ("valid", "boxes", "scores",
                                           "classes")})


def test_predictor_matches_jax(both):
    rng = np.random.RandomState(3)
    jpred = JaxPredictor(cfg=both["jcfg"], model=both["jmodel"],
                         params=both["params"], max_classes=8)
    tpred = SylphPredictor(cfg=both["tcfg"], model=both["model"],
                           max_classes=8, device="cpu")
    for name in ("widget", "gadget"):
        imgs = [rng.randint(0, 255, (150, 120, 3), np.uint8),
                rng.randint(0, 255, (90, 140, 3), np.uint8)]
        bxs = [np.array([10, 12, 100, 130], np.float32),
               np.array([20, 5, 120, 80], np.float32)]
        assert jpred.register_class(name, imgs, bxs) == \
            tpred.register_class(name, imgs, bxs)
    assert tpred.bank.num_classes == 2
    np.testing.assert_allclose(tpred.bank.conv.numpy(),
                               np.asarray(jpred.bank.conv), **TOL)
    np.testing.assert_allclose(tpred.bank.bias.numpy(),
                               np.asarray(jpred.bank.bias), **TOL)

    image = rng.randint(0, 255, (100, 230, 3), np.uint8)
    want, got = jpred(image), tpred(image)
    assert got["class_names"] == want["class_names"]
    assert_detections_match(
        dict(got, valid=np.ones(len(got["scores"]), bool)),
        dict(want, valid=np.ones(len(want["scores"]), bool)))
    assert set(got["class_names"]) <= {"widget", "gadget"}


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """No fallback: asking for the default device where there is no CUDA
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = shrink(get_default_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model_from_cfg(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SylphPredictor(cfg=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassCodeBank(4)
