"""The port's two-stage training pieces (sylph_tpu_torch/models/rcnn.py)
against the JAX package's, in float32 on the CPU, on the same inputs and
the same uniforms (the JAX keys' draws, replayed by
``torch_port_util.JaxDraws``):

  * exact: ``pairwise_iou``, ``match_anchors`` (a low-quality tie, an image
    with no valid GT), ``subsample_labels`` weights, ``sample_rois``' four
    outputs with equal priorities everywhere;
  * rtol 1e-5: ``rpn_losses`` and ``roi_losses``;
  * rtol 1e-4: the loss dicts of ``forward_episodic_train``, with and
    without snnl (``forward_pretrain_train`` is in
    test_torch_rcnn_train_plain.py and test_torch_rcnn_train_tfa.py);
  * ``SampleDraws``: a source is a function of (seed, iteration, group).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu import structures as jstructures
from sylph_tpu.models import rcnn as jrcnn
from sylph_tpu_torch import structures
from sylph_tpu_torch.models import rcnn

from torch_port_util import (JaxDraws, few_torch_threads,  # noqa: F401
                             rcnn_pair, rcnn_train_batch, rcnn_train_cfg)

J = jnp.asarray
T = torch.from_numpy


def gt_pair(boxes, labels, valid):
    return (jstructures.GTBoxes(J(boxes), J(labels), J(valid)),
            structures.GTBoxes(T(boxes), T(labels).long(), T(valid)))


def random_gt(rng, m=6, n_valid=4, hw=128):
    xy = rng.uniform(0, hw - 60, (m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(16, 60, (m, 2))],
                           -1).astype(np.float32)
    valid = np.arange(m) < n_valid
    return boxes, rng.randint(0, 5, m).astype(np.int32), valid


def test_pairwise_iou_equals_jax():
    rng = np.random.RandomState(0)
    a = random_gt(rng, 40)[0]
    b = random_gt(rng, 7)[0]
    b[0] = b[0, [0, 1, 0, 1]]                     # an empty box: union > 0
    b[1] = a[3]                                   # an identical one
    want = np.asarray(jstructures.pairwise_iou(J(a), J(b)))
    got = structures.pairwise_iou(T(a), T(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3, 1] == 1.0
    zero = np.zeros((2, 4), np.float32)
    assert structures.pairwise_iou(T(zero), T(zero)).eq(0).all()


def test_match_anchors_equals_jax():
    """The anchors of a 128x128 canvas against six GT slots (four valid),
    one GT a duplicate anchor's box so that two anchors tie for its best
    IoU (both become positive); then an image with no valid GT (all 0)."""
    anchors = jrcnn.build_anchor_grid((128, 128)).anchors
    rng = np.random.RandomState(1)
    boxes, labels, valid = random_gt(rng)
    boxes[2] = anchors[100] + np.float32([0.3, 0.2, -0.1, 0.4])
    anchors = np.concatenate([anchors, anchors[100:101]])   # the tie
    for v in (valid, np.zeros_like(valid)):
        jg, tg = gt_pair(boxes, labels, v)
        w_idx, w_label = jrcnn.match_anchors(J(anchors), jg)
        g_idx, g_label = rcnn.match_anchors(T(anchors), tg)
        np.testing.assert_array_equal(g_label.numpy(), np.asarray(w_label))
        np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    jg, tg = gt_pair(boxes, labels, valid)
    label = rcnn.match_anchors(T(anchors), tg)[1]
    assert label[100] == 1 and label[-1] == 1
    assert (label == -1).any() and (label == 0).any()


@pytest.mark.parametrize("k_pos_avail", [3, 200])
def test_subsample_labels_equals_jax(k_pos_avail):
    """Fewer positives than the quota (all kept, negatives fill) and more
    (the quota by priority), with ignored anchors between."""
    rng = np.random.RandomState(k_pos_avail)
    label = rng.choice([-1, 0], 2000).astype(np.int32)
    label[rng.choice(2000, k_pos_avail, replace=False)] = 1
    key = jax.random.PRNGKey(k_pos_avail)
    want = np.asarray(jrcnn.subsample_labels(J(label), 256, 0.5, key))
    r = T(np.array(jax.random.uniform(key, label.shape)))
    got = rcnn.subsample_labels(T(label).long(), 256, 0.5, r).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 256
    assert got[label == 1].sum() == min(k_pos_avail, 128)
    assert got[label == -1].sum() == 0
    # batched rows sample each row alone
    both = rcnn.subsample_labels(T(np.stack([label, label])).long(), 256, 0.5,
                                 torch.stack([r, r.flip(0)]))
    np.testing.assert_array_equal(both[0].numpy(), want)


def test_sample_rois_equals_jax_with_equal_priorities(monkeypatch):
    """Proposals around the GT with every subsample and tie-break priority
    equal: the stable sorts alone decide, and must decide alike. Then the
    batched call on two images equals the per-image calls."""
    rng = np.random.RandomState(2)
    boxes, labels, valid = random_gt(rng, m=6)
    props = np.concatenate([boxes[rng.randint(0, 4, 40)]
                            + rng.uniform(-12, 12, (40, 4)),
                            rng.uniform(0, 120, (24, 4))]).astype(np.float32)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 4)
    pvalid = rng.uniform(size=64) > 0.1
    jg, tg = gt_pair(boxes, labels, valid)
    n = 64 + 6
    key = jax.random.PRNGKey(0)

    with monkeypatch.context() as mp:  # every JAX priority 0.5
        mp.setattr(jax.random, "uniform", lambda k, shape, *a, **kw:
                   jnp.full(shape, 0.5, jnp.float32))
        want = jrcnn.sample_rois(J(props), J(pvalid), jg, key, batch_size=32)
    half = torch.full((n,), 0.5)
    got = rcnn.sample_rois(T(props), T(pvalid), tg, half, half, batch_size=32)
    for g, w, name in zip(got, want, ("rois", "idx", "is_pos", "sampled")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # ties keep every positive and negative: the sort fills S with them
    assert int(got[2].sum()) > 0 and int(got[3].sum()) == 32

    draws = JaxDraws(key)
    u_sub, u_tie = draws.roi(2, n)
    batched = rcnn.sample_rois(
        T(np.stack([props, props[::-1].copy()])),
        T(np.stack([pvalid, pvalid[::-1].copy()])),
        structures.GTBoxes(*(torch.stack([t, t]) for t in (
            tg.boxes, tg.labels, tg.valid))), u_sub, u_tie, batch_size=32)
    for i, p in enumerate((props, props[::-1].copy())):
        pv = pvalid if i == 0 else pvalid[::-1].copy()
        one = rcnn.sample_rois(T(p), T(pv), tg, u_sub[i], u_tie[i],
                               batch_size=32)
        for a, b in zip(batched, one):
            assert torch.equal(a[i], b)


def test_rpn_and_roi_losses_match_jax():
    """``rpn_losses`` on two images (one with no valid GT) and
    ``roi_losses`` on one image's sampled ROIs, from random logits and
    deltas: rtol 1e-5."""
    grid = jrcnn.build_anchor_grid((128, 128))
    k = grid.anchors.shape[0]
    rng = np.random.RandomState(3)
    gts = [random_gt(rng), random_gt(rng)]
    gts[1][2][:] = False
    boxes, labels, valid = (np.stack(x) for x in zip(*gts))
    logits = rng.normal(0, 2, (2, k)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (2, k, 4)).astype(np.float32)
    jg, tg = gt_pair(boxes, labels, valid)
    key = jax.random.PRNGKey(4)
    want = jrcnn.rpn_losses(J(logits), J(deltas), J(grid.anchors), jg, key)
    priorities = T(np.stack([np.asarray(jax.random.uniform(kk, (k,)))
                             for kk in jax.random.split(key, 2)]))
    got = rcnn.rpn_losses(T(logits), T(deltas), T(grid.anchors), tg,
                          priorities)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(got["loss_rpn_loc"]) > 0

    # roi_losses on one image: 32 rois, 7 score columns
    g1 = jstructures.GTBoxes(jg.boxes[0], jg.labels[0], jg.valid[0])
    t1 = tg[0]
    props = np.concatenate([boxes[0][:4].repeat(8, 0)
                            + rng.uniform(-6, 6, (32, 4))]).astype(np.float32)
    u = jax.random.split(jax.random.PRNGKey(5))
    rois, midx, is_pos, samp = jrcnn.sample_rois(
        J(props), jnp.ones(32, bool), g1, u[0], batch_size=32)
    scores = rng.normal(0, 1, (32, 7)).astype(np.float32)
    rdeltas = rng.normal(0, 0.5, (32, 4)).astype(np.float32)
    targets = np.array(g1.labels[midx])
    want = jrcnn.roi_losses(J(scores), J(rdeltas), rois, g1, midx, is_pos,
                            samp, J(targets))
    got = rcnn.roi_losses(T(scores), T(rdeltas), T(np.array(rois)), t1,
                          T(np.array(midx)).long(),
                          T(np.array(is_pos)), T(np.array(samp)),
                          T(targets).long())
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(got["loss_box_reg"]) > 0


@pytest.fixture(scope="module")
def episodic():
    return rcnn_pair(episodic=True, seed=4)


def forward_both(pair_, episodic, snnl=False, seed=0):
    """One training forward in both packages on ``rcnn_train_batch``
    (two images or episodes) with the same key: the two loss dicts."""
    jcfg, jmodel, params, tcfg, tmodel = pair_
    cfg = rcnn_train_cfg(tcfg)
    batch = rcnn_train_batch(episodic, seed=seed)
    grid = jrcnn.build_anchor_grid(tuple(cfg.TPU.TRAIN_CANVAS))
    sizes = np.tile(np.int32(cfg.TPU.TRAIN_CANVAS), (2, 1))
    rpn = cfg.MODEL.RPN
    kw = dict(rpn_post_nms=rpn.POST_NMS_TOPK_TRAIN,
              roi_batch=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
              rpn_pre_nms=rpn.PRE_NMS_TOPK_TRAIN)
    key = jax.random.PRNGKey(seed + 11)
    pre = "query_" if episodic else ""
    jg, tg = gt_pair(batch[pre + "gt_boxes"], batch[pre + "gt_labels"],
                     batch[pre + "gt_valid"])
    img = batch[pre + "images"].astype(np.float32)
    common = (J(grid.anchors), grid.level_splits, J(sizes))
    if snnl:
        jmodel = jmodel.clone(code_generator_kwargs=dict(
            jmodel.code_generator_kwargs, contrastive_loss="snnl"))
        tmodel.code_generator.contrastive_loss = "snnl"
    try:
        if episodic:
            sup = [batch[k] for k in ("support_images", "support_boxes",
                                      "support_box_valid")]
            sup[0] = sup[0].astype(np.float32)
            ids = batch["episode_class_ids"]
            want = jax.jit(lambda p: jmodel.apply(
                {"params": p}, *map(J, sup), J(img), jg, J(ids), key,
                *common, 2, None, method=jrcnn.FewShotRCNN
                .forward_episodic_train, **kw))(params)
            got = tmodel.forward_episodic_train(
                *map(T, sup), T(img), tg, T(ids).long(), JaxDraws(key),
                T(grid.anchors), grid.level_splits, T(sizes), 2, **kw)
        else:
            want = jax.jit(lambda p: jmodel.apply(
                {"params": p}, J(img), jg, key, *common, None,
                method=jrcnn.FewShotRCNN.forward_pretrain_train,
                **kw))(params)
            got = tmodel.forward_pretrain_train(
                T(img), tg, JaxDraws(key), T(grid.anchors),
                grid.level_splits, T(sizes), **kw)
    finally:
        if snnl:
            tmodel.code_generator.contrastive_loss = ""
    return ({k: float(v) for k, v in want.items()},
            {k: float(v.detach()) for k, v in got.items()})


def check_losses(want, got, keys):
    assert sorted(got) == sorted(want) == sorted(keys)
    for k in want:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


LOSSES = ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"]


@pytest.mark.parametrize("snnl", [False, True])
def test_forward_episodic_train_matches_jax(episodic, snnl):
    want, got = forward_both(episodic, True, snnl=snnl)
    check_losses(want, got, LOSSES + (["loss_snnl"] if snnl else []))


def test_sample_draws_are_a_function_of_seed_iteration_group():
    a = rcnn.SampleDraws.for_step(0, 5, 1, "cpu")
    b = rcnn.SampleDraws.for_step(0, 5, 1, "cpu")
    c = rcnn.SampleDraws.for_step(0, 5, 2, "cpu")
    ra, rb, rc = a.rpn(2, 300), b.rpn(2, 300), c.rpn(2, 300)
    assert torch.equal(ra, rb) and not torch.equal(ra, rc)
    assert ra.dtype == torch.float32 and 0 <= float(ra.min()) < 1
    sub, tie = a.roi(2, 50)
    assert sub.shape == tie.shape == (2, 50) and not torch.equal(sub, tie)
    assert torch.equal(sub, b.roi(2, 50)[0])
