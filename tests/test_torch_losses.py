"""The port's loss primitives, FCOS assigner and FCOS losses against the JAX
package's, values and gradients, in float32 on the CPU.

Inputs come from a numpy seed and go to both packages; gradients are
``jax.grad`` against torch autograd of the summed loss. Tolerances: values
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6; the assigner's
labels and ``target_inds`` must be identical (area ties included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.ops import assigner as jassigner
from sylph_tpu.ops import fcos_losses as jfl
from sylph_tpu.ops import losses as jlosses
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.structures import GTBoxes
from sylph_tpu_torch.ops import assigner, fcos_losses as tfl, losses

from torch_port_util import few_torch_threads  # noqa: F401

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)



def _ltrb(rng, shape, lo=0.0, hi=6.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _primitive_cases():
    return {
        "focal": (lambda m: lambda x, t: m.sigmoid_focal_loss(x, t, 0.25,
                                                             2.0), "logit"),
        "focal_no_alpha": (lambda m: lambda x, t: m.sigmoid_focal_loss(
            x, t, -1.0, 1.5), "logit"),
        "bce": (lambda m: m.bce_with_logits, "logit"),
        "smooth_l1": (lambda m: lambda x, t: m.smooth_l1(x, t, 0.5), "box"),
        "iou": (lambda m: lambda x, t: m.iou_loss_ltrb(x, t, "iou"), "ltrb"),
        "linear_iou": (lambda m: lambda x, t: m.iou_loss_ltrb(
            x, t, "linear_iou"), "ltrb"),
        "giou": (lambda m: lambda x, t: m.iou_loss_ltrb(x, t, "giou"),
                 "ltrb"),
        "compute_ious": (lambda m: m.compute_ious_ltrb, "ltrb"),
    }


@pytest.mark.parametrize("name", sorted(_primitive_cases()))
def test_loss_primitive_and_grad_match_jax(name):
    make, kind = _primitive_cases()[name]
    rng = np.random.RandomState(sorted(_primitive_cases()).index(name))
    if kind == "logit":
        x = rng.randn(7, 5).astype(np.float32) * 3
        t = (rng.rand(7, 5) > 0.7).astype(np.float32)
        t[0] = rng.rand(5)  # soft targets too
    elif kind == "box":
        x = rng.randn(7, 4).astype(np.float32)
        t = rng.randn(7, 4).astype(np.float32)
    else:
        x, t = _ltrb(rng, (9, 4)), _ltrb(rng, (9, 4), 0.5)
    jf, tf = make(jlosses), make(losses)
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(t)))
    xt = torch.tensor(x, requires_grad=True)
    got = tf(xt, torch.tensor(t))
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    gwant = np.asarray(jax.grad(lambda a: jnp.sum(jf(a, jnp.asarray(t))))(
        jnp.asarray(x)))
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gwant, **GRAD)


def _grid(canvas=(64, 96)):
    return jax_grid(canvas, (8, 16, 32, 64, 128), [64, 128, 256, 512])


def _gt(rng, b=3, m=6, ties=True):
    xy = rng.uniform(0, 60, (b, m, 2))
    wh = rng.uniform(4, 60, (b, m, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if ties:
        # equal-area pairs that both contain the same locations
        boxes[:, 1] = boxes[:, 0] + np.array([2, 0, 2, 0], np.float32)
        boxes[:, 2] = boxes[:, 0]
    labels = rng.randint(0, 5, (b, m)).astype(np.int32)
    valid = rng.rand(b, m) > 0.2
    valid[:, :3] = True
    valid[-1] = False  # a GT-free image
    return boxes, labels, valid


def _assign_both(grid, boxes, labels, valid, center_sample):
    want = jassigner.assign_fcos_targets_batch(
        jnp.asarray(grid.locations), jnp.asarray(grid.strides),
        jnp.asarray(grid.size_ranges),
        GTBoxes(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid)),
        center_sample=center_sample, radius=1.5)
    got = assigner.assign_fcos_targets(
        torch.as_tensor(grid.locations), torch.as_tensor(grid.strides),
        torch.as_tensor(grid.size_ranges), torch.as_tensor(boxes),
        torch.as_tensor(labels), torch.as_tensor(valid),
        center_sample=center_sample, radius=1.5)
    return want, got


@pytest.mark.parametrize("center_sample", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_assigner_matches_jax_exactly(center_sample, seed):
    grid = _grid()
    boxes, labels, valid = _gt(np.random.RandomState(seed))
    want, got = _assign_both(grid, boxes, labels, valid, center_sample)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.target_inds.numpy(),
                                  np.asarray(want.target_inds))
    np.testing.assert_allclose(got.reg_targets.numpy(),
                               np.asarray(want.reg_targets), **VAL)
    assert (got.labels >= 0).sum() > 10
    # the tie rule: box 2 duplicates box 0, so index 2 never wins
    assert not (got.target_inds == 2).any()
    np.testing.assert_allclose(
        assigner.compute_ctrness_targets(got.reg_targets).numpy(),
        np.asarray(jassigner.compute_ctrness_targets(want.reg_targets)),
        **VAL)


def _head_inputs(rng, b, k, c):
    logits = rng.randn(b, k, c).astype(np.float32) * 2 - 2
    reg = rng.uniform(0, 4, (b, k, 4)).astype(np.float32)
    ctr = rng.randn(b, k).astype(np.float32)
    iou = rng.randn(b, k).astype(np.float32)
    return logits, reg, ctr, iou


def _targets_both(seed=3):
    grid = _grid()
    boxes, labels, valid = _gt(np.random.RandomState(seed))
    want, got = _assign_both(grid, boxes, labels, valid, True)
    return want, got, grid.num_locations


def _grads_match(jfun, tfun, arrays):
    """Values and gradients of sum(losses) w.r.t. every input array."""
    jv = jfun(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfun(*ts)
    assert list(tv) == list(jv)
    for k in jv:
        np.testing.assert_allclose(tv[k].item(), float(jv[k]), rtol=1e-5,
                                   err_msg=k)
    jg = jax.grad(lambda *a: sum(jfun(*a).values()),
                  argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    sum(tv.values()).backward()
    for i, (t, g) in enumerate(zip(ts, jg)):
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(g)
        assert np.isfinite(got).all(), i
        np.testing.assert_allclose(got, np.asarray(g), **GRAD)


PRETRAIN_CASES = {
    "ctrness_giou": dict(box_quality=("ctrness",)),
    "iou_iou": dict(box_quality=("iou",), loc_loss_type="iou"),
    "both_linear": dict(box_quality=("ctrness", "iou"),
                        loc_loss_type="linear_iou", iou_mask=True),
    "owd": dict(box_quality=("ctrness", "iou"), owd=True),
    "frozen_box_branch": dict(box_branch_loss_on=False,
                              freeze_cls_logits=False),
}


@pytest.mark.parametrize("case", sorted(PRETRAIN_CASES))
def test_pretrain_losses_match_jax(case):
    kw = PRETRAIN_CASES[case]
    jt, tt, k = _targets_both()
    rng = np.random.RandomState(7)
    arrays = _head_inputs(rng, 3, k, 5)
    jcfg, tcfg = jfl.FCOSLossCfg(**kw), tfl.FCOSLossCfg(**kw)
    _grads_match(
        lambda *a: jfl.fcos_pretrain_losses(*a, jt, jcfg),
        lambda *a: tfl.fcos_pretrain_losses(*a, tt, tcfg), arrays)


@pytest.mark.parametrize("distill", [0.0, 0.5])
def test_episodic_losses_match_jax(distill):
    jt, tt, k = _targets_both(seed=4)
    rng = np.random.RandomState(8)
    logits, reg, ctr, _ = _head_inputs(rng, 3, k, 3)
    ids = np.array([1, 3, 4], np.int32)
    code_w = rng.randn(3, 16).astype(np.float32)
    code_b = rng.randn(3).astype(np.float32)
    kern = (rng.randn(6, 16).astype(np.float32),
            rng.randn(6).astype(np.float32))
    kw = dict(distill_weight=distill)

    def jfun(lg, rg, ct, w, b):
        return jfl.fcos_episodic_losses(
            lg, rg, ct, jt, jnp.asarray(ids), jfl.FCOSLossCfg(**kw),
            class_code={"cls_conv": w, "cls_bias": b},
            pretrained_kernel=tuple(map(jnp.asarray, kern)))

    def tfun(lg, rg, ct, w, b):
        return tfl.fcos_episodic_losses(
            lg, rg, ct, tt, torch.as_tensor(ids), tfl.FCOSLossCfg(**kw),
            class_code={"cls_conv": w, "cls_bias": b},
            pretrained_kernel=tuple(map(torch.as_tensor, kern)))

    _grads_match(jfun, tfun, (logits, reg, ctr, code_w, code_b))


def test_negative_targets_at_masked_locations_keep_grads_finite():
    """A negative location whose ltrb target makes area_union + 1 = 0: the
    double-where guard keeps every gradient finite in both packages."""
    b, k = 1, 4
    reg = np.full((b, k, 4), 1.0, np.float32)
    targets = np.array([[[2, 2, 2, 2], [-1, -1, -1, -1], [-3, 1, 0.5, -1],
                         [1, 1, 1, 1]]], np.float32)
    labels = np.array([[0, -1, -1, 2]], np.int32)
    logits = np.zeros((b, k, 3), np.float32)
    ctr = np.zeros((b, k), np.float32)
    iou = np.zeros((b, k), np.float32)
    jt = jassigner.FCOSTargets(jnp.asarray(labels), jnp.asarray(targets),
                               jnp.asarray(labels))
    tt = assigner.FCOSTargets(torch.as_tensor(labels),
                              torch.as_tensor(targets),
                              torch.as_tensor(labels))
    for lt in ("giou", "iou", "linear_iou"):
        kw = dict(box_quality=("ctrness", "iou"), loc_loss_type=lt)
        _grads_match(
            lambda *a: jfl.fcos_pretrain_losses(*a, jt,
                                                jfl.FCOSLossCfg(**kw)),
            lambda *a: tfl.fcos_pretrain_losses(*a, tt,
                                                tfl.FCOSLossCfg(**kw)),
            (logits, reg, ctr, iou))
