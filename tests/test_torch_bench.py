"""The port's flagship entry point and benchmark query path against the
root ``__graft_entry__.py`` and ``bench.py`` on the CPU.

  * ``sylph_tpu_torch.entry.entry()`` on ``__graft_entry__.entry()``'s
    parameters (converted): dense outputs at the bf16 tolerance of
    tests/test_torch_bf16.py (5% of each output's range; the zero bank's
    logits exactly 0 in both), and in float32 (``_flagship_model(
    jnp.float32)``, the same grid and decode) detections equal: boxes 1e-3,
    scores 1e-4, classes and valid flags equal;
  * bench.py's ``make_bank`` and ``query_path``, rebuilt from the same
    ``sylph_tpu`` calls at depth 18, 128x256 and batch 2 in float32,
    against ``tools/bench.py``'s functions on the same parameters
    (detectron2-scaled random values, 6 classes): the bank to 1e-5,
    detections as above at a score threshold of 0.02 (random codes score
    about 0.03, under decode's 0.05);
  * the port's bench JSON line has bench.py's keys;
  * ``dryrun_multichip(2)`` on two gloo ranks.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu.ops.decode import DecodeCfg as JaxDecodeCfg
from sylph_tpu.ops.decode import decode_proposals as jax_decode
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu_torch import entry as port_entry
from sylph_tpu_torch.ops.decode import DecodeCfg
from sylph_tpu_torch.tools import bench
from sylph_tpu_torch.tools.bench_common import (QueryPath, bank_inputs,
                                                flagship_model, make_bank,
                                                query_images)
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import few_torch_threads, randomize  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402

REL_TOL = 0.05       # tests/test_torch_bf16.py: 5% of each output's range
STRIDES = (8, 16, 32, 64, 128)
SOI = [64, 128, 256, 512]
# Normalized codes from random weights sit at the focal prior (logits near
# -3.5, scores 0.03: bench.py's "logit floor"), under decode's 0.05; the
# query-path test lowers the threshold so that detections are compared.
DCFG = DecodeCfg(pre_nms_thresh=0.02)
BANK_CLASSES = 6
# bench.py:154-167
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA_KEYS = {"canvas", "batch", "codegen_ms_per_class",
                    "codegen_ms_per_class_single_dispatch", "device"}


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_detect(jmodel, params, images, bank, canvas, dcfg=JaxDecodeCfg()):
    """bench.py's ``query_path`` body: forward_instances, then decode on
    the canvas's grid."""
    grid = jax_grid(canvas, STRIDES, SOI)
    splits = tuple(h * w for h, w in grid.level_sizes)
    sizes = jnp.tile(jnp.asarray([list(canvas)]), (images.shape[0], 1))
    out = jax.jit(lambda p, x, b: jmodel.apply(
        {"params": p}, x, b, method=JaxDetector.forward_instances))(
        params, images, bank)
    return jax.tree.map(np.asarray, jax_decode(
        out.logits, out.reg, out.ctrness, out.iou,
        jnp.asarray(grid.locations), jnp.asarray(grid.strides),
        jnp.asarray(grid.level_ids), sizes, dcfg, splits))


def _load_query_params(model, params):
    """``params`` from an init that never calls the base classifier (and,
    through ``forward_instances``, not the code generator): flax makes
    leaves on use, so those stay the port's own; every converted leaf
    loads."""
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params),
                                                strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith(("fcos_head.cls_logits.", "code_generator."))
               for k in missing), missing
    return model


def _detections_equal(got, want):
    got = got.numpy()
    np.testing.assert_array_equal(got.valid, want.valid)
    k = want.valid
    assert k.any()
    np.testing.assert_array_equal(got.classes[k], want.classes[k])
    np.testing.assert_allclose(got.boxes[k], want.boxes[k], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got.scores[k], want.scores[k], atol=1e-4,
                               rtol=0)


@pytest.fixture(scope="module")
def flagship():
    """``__graft_entry__.entry()``'s forward and arguments (R-50 at 512²,
    bf16, the zero 20-class bank)."""
    fn, args = graft.entry()
    return fn, jax.tree.map(np.asarray, args[0]), args


def test_entry_dense_outputs_match_jax_bf16(flagship):
    _, params, (_, images, conv, bias, _) = flagship
    jmodel = graft._flagship_model()
    want = jax.jit(lambda p, x, b: jmodel.apply(
        {"params": p}, x, b, method=JaxDetector.forward_instances))(
        params, images, {"cls_conv": conv, "cls_bias": bias})
    fn, (model, timages, tconv, tbias, sizes) = port_entry.entry("cpu")
    _load_query_params(model, params)
    assert model.compute_dtype == torch.bfloat16
    assert tuple(timages.shape) == tuple(images.shape)
    with torch.inference_mode():
        got = model.forward_instances(timages, {"cls_conv": tconv,
                                                "cls_bias": tbias})
    # a zero bank gives logits of exactly 0 at every location and class
    assert not np.asarray(want.logits).any() and not got.logits.any()
    errs = {name: _rel_err(getattr(got, name).float(), getattr(want, name))
            for name in ("reg", "ctrness", "iou")}
    assert max(errs.values()) <= REL_TOL, errs
    det = fn(model, timages, tconv, tbias, sizes)
    assert tuple(det.boxes.shape) == (1, 100, 4) and bool(det.valid.all())


def test_entry_detections_match_jax_float32(flagship):
    fn, params, (_, images, conv, bias, sizes) = flagship
    want = _jax_detect(graft._flagship_model(jnp.float32), params, images,
                       {"cls_conv": conv, "cls_bias": bias},
                       port_entry.ENTRY_CANVAS)
    tfn, targs = port_entry.entry("cpu", dtype=torch.float32)
    _load_query_params(targs[0], params)
    got = tfn(*targs)
    # every location passes the threshold, so NMS sees the full K
    assert want.valid.all()
    _detections_equal(got, want)


@pytest.fixture(scope="module")
def bench_pair():
    """bench.py's model at depth 18 in float32, its parameter tree made as
    bench.py makes it, and the port's model on the same parameters."""
    jmodel = JaxDetector(depth=18, num_classes=60, compute_dtype=jnp.float32,
                         code_generator_name="CodeGenerator")
    params = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 4)),
        jnp.ones((1,), bool), jnp.zeros((1, 128, 128, 3)), 1,
        method=JaxDetector.forward_episodic_train))(
        jax.random.PRNGKey(0))["params"]
    # detectron2-scaled values: flax's initial head at depth 18 scores no
    # location above the threshold on these images
    params = randomize(params, np.random.RandomState(0))
    model = _load_query_params(flagship_model("cpu", depth=18,
                                              dtype=torch.float32), params)
    return jmodel, params, model


def _jax_bank(jmodel, params, sup, boxes):
    """bench.py's ``make_bank``."""
    raw = jmodel.apply({"params": params}, sup, boxes,
                       jnp.ones((sup.shape[0],), bool), 1, False,
                       method=JaxDetector.forward_class_code)
    return jmodel.apply({"params": params},
                        {"cls_conv": raw["cls_conv"],
                         "cls_bias": raw["cls_bias"]},
                        method=JaxDetector.normalize_code)


def test_bench_bank_and_query_path_match_jax(bench_pair):
    jmodel, params, model = bench_pair
    sup, boxes = bank_inputs(BANK_CLASSES)
    want_bank = jax.jit(lambda p, x, b: _jax_bank(jmodel, p, x, b))(
        params, jnp.asarray(sup), jnp.asarray(boxes))
    bank = make_bank(model, torch.from_numpy(sup), torch.from_numpy(boxes))
    for key in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(bank[key].numpy(),
                                   np.asarray(want_bank[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    canvas = (128, 256)
    images = query_images(2, canvas, "cpu")
    want = _jax_detect(jmodel, params, jnp.asarray(images.numpy()),
                       want_bank, canvas, JaxDecodeCfg(pre_nms_thresh=0.02))
    got = QueryPath(model, bank, canvas, 2, DCFG)(images)
    _detections_equal(got, want)


def test_bench_line_has_bench_py_keys():
    line = bench.run("cpu", depth=18, canvas=(128, 256), batch=2, shots=2,
                     support_canvas=(64, 64), class_batch=2, iters=1,
                     warmup=1, batched_iters=1, bank_size=64)
    assert BENCH_KEYS <= set(line)
    assert BENCH_EXTRA_KEYS <= set(line["extra"])
    assert line["metric"] == "meta_fcos_r50_query_images_per_sec_per_chip"
    assert line["unit"] == "images/sec" and line["value"] > 0
    assert line["extra"]["device"] == "cpu"
    # a device share is never reported from a CPU run
    assert line["extra"]["bf16_dense_peak_share"] is None
    # one image at 128x256 through R-18: the towers' 8 convs over 682
    # locations alone are 8 * 2 * 9 * 256² * 682 FLOP
    assert line["extra"]["gflop_per_image_head"] > 8 * 2 * 9 * 256 ** 2 \
        * 682 / 1e9


def test_dryrun_multichip_on_two_gloo_ranks():
    result = port_entry.dryrun_multichip(2)
    assert result["step"] == 2
    assert len(result["metrics"]) == 2
    for m in result["metrics"]:
        assert set(m) == {"loss_fcos_cls", "loss_fcos_loc",
                          "loss_fcos_ctr"}
        assert all(np.isfinite(v) for v in m.values())
