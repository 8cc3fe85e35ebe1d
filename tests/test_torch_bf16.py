"""The port in bfloat16 against the JAX package as it serves on an accelerator.

The JAX package serves with ``TPU.EVAL_BF16_RESIDENT``: every float32
parameter is cast to bfloat16 (``sylph_tpu.utils.precision.bf16_resident``;
on the CPU ``eval_resident_params`` skips it, so the tests apply it here) and
activations run in ``compute_dtype=bfloat16``. Here the port keeps float32
parameters (its own policy, ``sylph_tpu_torch/utils/precision.py``, is off on
the CPU too; tests/test_torch_eval_bf16.py holds it) and runs
``TPU.COMPUTE_DTYPE = "bfloat16"``. Where the two differ
by construction the port follows the JAX package, and two tests hold each
such place on its own, tightly:

  * GroupNorm normalizes in float32 with bf16-rounded scale and bias;
  * the conditional classifier multiplies bf16 operands and accumulates and
    returns float32 (``preferred_element_type=float32``).

The whole register -> serve slice then runs in both on the ``both`` fixture's
R-50 weights (tests/test_torch_serving.py). Tolerance for the codes and the
dense outputs: max |port - jax| <= 5% of max |jax|, per output. Two bf16
pipelines round at different places (XLA fuses and rounds once where torch
rounds after each op); on these inputs the port differs from JAX-bf16 by at
most 2.4% (reg, ctrness, iou; 0.6% for the logits), while JAX-bf16 itself
differs from JAX-float32 by up to 3.1%. Detections: the counts may differ by
two near the score threshold; every detection of the shorter list has one in
the other with the same class and FPN level, coordinates within a tenth of
the level's stride (the regression is stride-normalized) and score within
0.005 (scores ~0.1 here).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.config import get_default_cfg as jax_default_cfg
from sylph_tpu.models.fcos_head import FCOSHead as JaxHead
from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu.ops.decode import decode_proposals as jax_decode
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.runner.meta_fcos_runner import \
    _decode_cfg as jax_decode_cfg
from sylph_tpu.runner.meta_fcos_runner import \
    build_model_from_cfg as jax_build_model
from sylph_tpu.utils.precision import bf16_resident
from sylph_tpu_torch import build_model_from_cfg, get_default_cfg
from sylph_tpu_torch.models.fcos_head import FCOSHead
from sylph_tpu_torch.models.layers import GroupNorm
from sylph_tpu_torch.ops.decode import decode_proposals
from sylph_tpu_torch.runner import _decode_cfg
from sylph_tpu_torch.utils.convert_weights import (load_jax_params,
                                                   state_dict_from_jax)

from test_torch_serving import CANVAS, SHOTS, both, shrink  # noqa: F401
from torch_port_util import randomize

REL_TOL = 0.05
STRIDES = (8, 16, 32, 64, 128)


def bf16_values(x):
    """float32 numpy values that bfloat16 holds exactly."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_groupnorm_uses_bf16_rounded_affine():
    """flax GroupNorm(dtype=float32) with bf16 parameters on a bf16 input,
    against the port's GroupNorm on the same input: the same float32
    arithmetic on the same values, so equal up to one bf16 rounding of the
    output (the two sum the group statistics in different orders)."""
    rng = np.random.RandomState(0)
    x = bf16_values(rng.randn(2, 6, 5, 64) * 3 + 1)
    scale = (1.0 + 0.3 * rng.randn(64)).astype(np.float32)
    bias = (0.3 * rng.randn(64)).astype(np.float32)
    params = bf16_resident({"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)})
    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.float32)
    want = gn.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)) \
        .astype(jnp.bfloat16).astype(jnp.float32)

    tgn = GroupNorm(32, 64)
    with torch.no_grad():
        tgn.weight.copy_(torch.from_numpy(scale))
        tgn.bias.copy_(torch.from_numpy(bias))
        got = tgn(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    ulp = np.abs(want) * 2.0 ** -7  # bf16 keeps 8 significant bits
    assert (np.abs(got - want) <= ulp + 1e-30).all()
    assert np.mean(got == want) > 0.99


def test_conditional_classifier_bf16_operands():
    """No tower convs, so the classifier sees the bf16 features themselves:
    the logits are bf16 x bf16 products summed in float32 on both sides."""
    rng = np.random.RandomState(1)
    levels = [(4, 8), (2, 4), (1, 2), (1, 1), (1, 1)]
    feats = [bf16_values(rng.randn(2, h, w, 256)) for h, w in levels]
    code = {"cls_conv": rng.randn(7, 256).astype(np.float32) / 16,
            "cls_bias": rng.randn(7).astype(np.float32)}
    jhead = JaxHead(num_classes=6, num_cls_convs=0, num_box_convs=0,
                    compute_dtype=jnp.bfloat16)
    jfeats = [jnp.asarray(f) for f in feats]
    params = randomize(jhead.init(jax.random.PRNGKey(0), jfeats)["params"],
                       rng)
    want = jhead.apply({"params": bf16_resident(params)}, jfeats,
                       class_code={k: jnp.asarray(v) for k, v in code.items()})
    head = FCOSHead(num_classes=6, num_cls_convs=0, num_box_convs=0,
                    compute_dtype=torch.bfloat16)
    head.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
                   class_code={k: torch.from_numpy(v)
                               for k, v in code.items()})
    assert got.logits.dtype == torch.float32
    # float32 sums of the same 256 exact products, in another order
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _match_detections(det_t, det_j):
    """Every detection of the shorter list in the other: same class and
    level, coordinates within stride / 10, score within 0.005."""
    def rows(d):
        k = d.valid[0]
        return list(zip(d.classes[0][k], d.fpn_levels[0][k],
                        d.boxes[0][k], d.scores[0][k]))
    a, b = rows(det_t), rows(det_j)
    assert abs(len(a) - len(b)) <= 2 and min(len(a), len(b)) > 0
    short, other = (a, b) if len(a) <= len(b) else (b, a)
    free = list(range(len(other)))
    for cls, lvl, box, score in short:
        tol = STRIDES[lvl] / 10
        hit = [i for i in free if other[i][0] == cls and other[i][1] == lvl
               and np.abs(other[i][2] - box).max() <= tol
               and abs(other[i][3] - score) <= 0.005]
        assert hit, f"no counterpart for class {cls} box {box} score {score}"
        free.remove(hit[0])


def test_serving_bf16_matches_jax(both):  # noqa: F811
    jcfg = shrink(jax_default_cfg())
    jcfg.TPU.COMPUTE_DTYPE = "bfloat16"
    jmodel = jax_build_model(jcfg)
    tcfg = shrink(get_default_cfg())
    tcfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = load_jax_params(build_model_from_cfg(tcfg, device="cpu"),
                            both["params"])
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

    params = bf16_resident(jax.tree.map(jnp.asarray, both["params"]))
    raw, code, out = jax.jit(jax_chain)(params, jnp.asarray(query),
                                        jnp.asarray(support),
                                        jnp.asarray(boxes))
    with torch.no_grad():
        t_raw = model.forward_class_code(
            torch.from_numpy(support), torch.from_numpy(boxes),
            torch.from_numpy(valid), SHOTS)
        t_code = model.normalize_code(t_raw)
        t_out = model.forward_instances(torch.from_numpy(query), t_code)

    errs = {}
    for key in ("cls_conv", "cls_bias"):
        errs[f"raw {key}"] = _rel_err(t_raw[key], raw[key])
        errs[f"normalized {key}"] = _rel_err(t_code[key], code[key])
    for name in ("logits", "reg", "ctrness", "iou"):
        assert getattr(t_out, name).dtype == torch.float32
        errs[name] = _rel_err(getattr(t_out, name), getattr(out, name))
    assert max(errs.values()) <= REL_TOL, errs

    grid = jax_grid(CANVAS, STRIDES, [64, 128, 256, 512])
    splits = tuple(h * w for h, w in grid.level_sizes)
    size = np.array([[CANVAS[0], CANVAS[1]]], np.int32)
    det_j = jax.tree.map(np.asarray, jax_decode(
        out.logits, out.reg, out.ctrness, out.iou,
        jnp.asarray(grid.locations), jnp.asarray(grid.strides),
        jnp.asarray(grid.level_ids), jnp.asarray(size),
        jax_decode_cfg(jcfg), splits))
    det_t = decode_proposals(
        t_out.logits, t_out.reg, t_out.ctrness, t_out.iou,
        torch.from_numpy(grid.locations), torch.from_numpy(grid.strides),
        torch.from_numpy(size), _decode_cfg(tcfg), splits).numpy()
    _match_detections(det_t, det_j)
