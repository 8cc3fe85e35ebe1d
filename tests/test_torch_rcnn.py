"""The port's two-stage detector (sylph_tpu_torch/models/rcnn.py) against the
JAX package's FewShotRCNN on the same weights and inputs, in float32 on the
CPU: anchors exactly, the box transform, the RPN head and proposals, the
three box-head classifiers, class codes, the weight names and the
detections of ``forward_instances`` (code bank). The plain path
(``forward_base_instances``) is in test_torch_rcnn_base.py.

Tolerances: dense outputs rtol/atol 1e-4 (XLA and torch sum convolutions in
other orders); detections boxes 1e-3, scores 1e-4, classes and valid equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models import rcnn as jrcnn
from sylph_tpu.ops.boxes import decode_deltas as jax_decode
from sylph_tpu.ops.boxes import encode_deltas as jax_encode
from sylph_tpu_torch.models import rcnn
from sylph_tpu_torch.ops.boxes import decode_deltas, encode_deltas
from sylph_tpu_torch.utils.convert_weights import (load_jax_params,
                                                   state_dict_from_jax)

from torch_port_util import few_torch_threads, rcnn_pair, to_numpy  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def episodic():
    return rcnn_pair(episodic=True, seed=3)


def query_images(rng, b, hw):
    """Pixels near the BGR mean: R-18 activations stay O(1), where float32
    sums in two orders agree to the stated tolerance."""
    mean = np.float32([103.530, 116.280, 123.675])
    return (mean + rng.uniform(-20, 20, (b, *hw, 3))).astype(np.float32)


def test_anchor_grid_equals_jax():
    for canvas in ((64, 96), (100, 130), (1024, 1344)):
        want = jrcnn.build_anchor_grid(canvas)
        got = rcnn.build_anchor_grid(canvas)
        np.testing.assert_array_equal(got.anchors, want.anchors)
        assert got.level_splits == want.level_splits
        assert got.num_anchors_per_loc == want.num_anchors_per_loc


def test_boxes_round_trip_and_match_jax():
    rng = np.random.RandomState(0)
    src = np.concatenate([rng.uniform(0, 50, (16, 2)),
                          rng.uniform(60, 100, (16, 2))], -1)
    tgt = src + rng.uniform(-5, 5, src.shape)
    tgt[:, 2:] = np.maximum(tgt[:, 2:], tgt[:, :2] + 2)
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    w = rcnn.ROI_DELTA_WEIGHTS
    d = encode_deltas(torch.from_numpy(src), torch.from_numpy(tgt), w)
    np.testing.assert_allclose(d.numpy(), np.asarray(jax_encode(src, tgt, w)),
                               **TOL)
    back = decode_deltas(torch.from_numpy(src), d, w)
    np.testing.assert_allclose(back.numpy(), tgt, rtol=1e-4, atol=1e-3)
    big = rng.normal(0, 30, (16, 4)).astype(np.float32)  # the clamp bites
    np.testing.assert_allclose(
        decode_deltas(torch.from_numpy(src), torch.from_numpy(big), w).numpy(),
        np.asarray(jax_decode(src, big, w)), rtol=1e-5, atol=1e-3)


def test_rpn_head_matches_jax(episodic):
    jcfg, jmodel, params, _, tmodel = episodic
    imgs = query_images(np.random.RandomState(1), 2, (64, 96))
    want = jmodel.apply({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(imgs))
    for g, w, name in zip(got, want, ("logits", "deltas")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
        assert float(np.abs(np.asarray(w)).std()) > 0.05, name  # not flat


@pytest.mark.parametrize("ties", [False, True])
def test_rpn_proposals_match_jax(ties):
    """Decode, clip, min_size and the level-aware NMS on shared inputs;
    with ``ties`` the logits take 5 values, so the per-level top-k and the
    NMS both break ties by index."""
    rng = np.random.RandomState(4 + ties)
    grid = rcnn.build_anchor_grid((64, 96))
    b, k = 2, grid.anchors.shape[0]
    logits = rng.normal(0, 1.5, (b, k)).astype(np.float32)
    if ties:
        logits = np.round(logits).clip(-2, 2).astype(np.float32)
    deltas = rng.normal(0, 0.3, (b, k, 4)).astype(np.float32)
    sizes = np.array([[64, 96], [50, 70]], np.int32)
    kw = dict(pre_nms_topk=100, post_nms_topk=50, nms_thresh=0.7,
              min_size=2.0)
    want = jrcnn.rpn_proposals(jnp.asarray(logits), jnp.asarray(deltas),
                               jnp.asarray(grid.anchors), grid.level_splits,
                               jnp.asarray(sizes), **kw)
    got = rcnn.rpn_proposals(torch.from_numpy(logits),
                             torch.from_numpy(deltas),
                             torch.from_numpy(grid.anchors),
                             grid.level_splits, torch.from_numpy(sizes), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    assert got[2].sum() > 20


@pytest.mark.parametrize("kind", ["linear", "cosine", "conditional"])
def test_box_head_classifiers_match_jax(kind):
    """All three classifiers (the NHWC flatten into fc1, float32)."""
    rng = np.random.RandomState(2)
    feats = rng.normal(0, 1, (12, 7, 7, 16)).astype(np.float32)
    code = None
    if kind == "conditional":
        code = {"cls_conv": rng.normal(0, 1, (5, 32)).astype(np.float32),
                "cls_bias": rng.normal(0, 1, (5,)).astype(np.float32)}
    head = jrcnn.ROIBoxHead(fc_dim=32, num_classes=4,
                            cosine_sim=kind == "cosine")
    variables = head.init(jax.random.PRNGKey(0), jnp.asarray(feats), code)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(
            np.float32), to_numpy(variables["params"]))
    want = head.apply({"params": params}, jnp.asarray(feats), code)
    port = load_jax_params(rcnn.ROIBoxHead(
        7 * 7 * 16, fc_dim=32, num_classes=4,
        conditional=kind == "conditional", cosine_sim=kind == "cosine"),
        params)
    with torch.no_grad():
        got = port(torch.from_numpy(feats).permute(0, 3, 1, 2),
                   None if code is None else
                   {k: torch.from_numpy(v) for k, v in code.items()})
    assert got[0].shape == (12, 6 if kind == "conditional" else 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_codes_match_jax(episodic):
    """Raw codes (class-batched: 2 classes x 2 shots) and the normalized
    bank, 64 wide."""
    jcfg, jmodel, params, _, tmodel = episodic
    rng = np.random.RandomState(6)
    sup = query_images(rng, 4, (64, 64))
    boxes = np.concatenate([rng.uniform(2, 20, (4, 2)),
                            rng.uniform(35, 60, (4, 2))], -1).astype(
                                np.float32)
    valid = np.ones((4,), bool)
    want = jmodel.apply({"params": params}, jnp.asarray(sup),
                        jnp.asarray(boxes), jnp.asarray(valid), 2,
                        method=jrcnn.FewShotRCNN.forward_class_code)
    with torch.no_grad():
        got = tmodel.forward_class_code(torch.from_numpy(sup),
                                        torch.from_numpy(boxes),
                                        torch.from_numpy(valid), 2)
    for key in ("cls_conv", "cls_bias"):
        assert got[key].shape == np.shape(want[key])
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)
    raw = {k: np.array(want[k]) for k in ("cls_conv", "cls_bias")}
    want_n = jmodel.apply({"params": params},
                          {k: jnp.asarray(v) for k, v in raw.items()},
                          method=jrcnn.FewShotRCNN.normalize_code)
    with torch.no_grad():
        got_n = tmodel.normalize_code({k: torch.from_numpy(v)
                                       for k, v in raw.items()})
    assert got_n["cls_conv"].shape == (2, 64)
    for key in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(got_n[key].numpy(),
                                   np.asarray(want_n[key]), err_msg=key,
                                   **TOL)


def assert_detections_close(got, want):
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(got.classes.numpy()[gv],
                                  np.asarray(want.classes)[wv])
    np.testing.assert_allclose(got.boxes.numpy()[gv],
                               np.asarray(want.boxes)[wv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)
    assert not got.locations.any() and not got.fpn_levels.any()
    assert gv.sum() > 5


def test_forward_instances_matches_jax(episodic):
    """Conditioned two-stage inference against a 3-row bank; the second
    image's content is smaller than the canvas (the clip)."""
    jcfg, jmodel, params, _, tmodel = episodic
    rng = np.random.RandomState(8)
    imgs = query_images(rng, 2, (64, 96))
    sizes = np.array([[64, 96], [48, 80]], np.int32)
    code = {"cls_conv": (rng.normal(0, 1, (3, 64)) / 8).astype(np.float32),
            "cls_bias": rng.normal(0, 0.5, (3,)).astype(np.float32)}
    grid = rcnn.build_anchor_grid((64, 96))
    kw = dict(rpn_post_nms=50, score_thresh=1e-4, nms_thresh=0.5,
              max_dets=20, rpn_pre_nms=100)
    want = jmodel.apply({"params": params}, jnp.asarray(imgs),
                        {k: jnp.asarray(v) for k, v in code.items()},
                        jnp.asarray(grid.anchors), grid.level_splits,
                        jnp.asarray(sizes),
                        method=jrcnn.FewShotRCNN.forward_instances, **kw)
    with torch.no_grad():
        got = tmodel.forward_instances(
            torch.from_numpy(imgs),
            {k: torch.from_numpy(v) for k, v in code.items()},
            torch.from_numpy(grid.anchors), grid.level_splits,
            torch.from_numpy(sizes), **kw)
    assert_detections_close(got, want)
    assert set(got.classes.numpy()[got.valid.numpy()]) <= {0, 1, 2}


def test_state_dict_names_cover_the_jax_tree(episodic):
    """Every leaf of the episodic JAX tree maps to a port tensor of the same
    shape and back: Dense kernels transposed, bg_weight/bg_bias kept."""
    _, _, params, _, tmodel = episodic
    sd = state_dict_from_jax(params)
    own = tmodel.state_dict()
    assert set(sd) == set(own)
    assert sd["box_head.fc1.weight"].shape == (64, 7 * 7 * 256)
    np.testing.assert_array_equal(
        sd["box_head.fc1.weight"].numpy(),
        params["box_head"]["fc1"]["kernel"].T)
    assert sd["box_head.bg_bias"].shape == ()
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
