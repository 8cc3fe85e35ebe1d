"""Device preprocessing of the port against the JAX package (CPU, fp32).

``resize_shortest_edge_device`` and its batched form take the same staged
frames as ``sylph_tpu.ops.image_ops``: the content size must be equal and
the canvas within 1e-3 on the 0-255 scale. The sizes cover landscape and
portrait frames, a frame whose resize the max size caps, and frames whose
resized side lands exactly on .5 in float32 (round half to even). Then
``SylphPredictor.__call__(device_preprocess=True)`` is held against the
JAX predictor's on the same weights, for a frame that fits the eval canvas
(the card's path) and one that does not (the host path in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.ops.image_ops import preprocess_batch_device as jax_batch
from sylph_tpu.ops.image_ops import \
    resize_shortest_edge_device as jax_resize
from sylph_tpu.predictor import SylphPredictor as JaxPredictor
from sylph_tpu_torch.ops.image_ops import (preprocess_batch_device,
                                           resize_shortest_edge_device)
from sylph_tpu_torch.predictor import SylphPredictor

from torch_port_util import tiny_model_pair

OUT_HW, SHORT, MAX_SIZE = (128, 160), 96, 160
SIZES = {
    "landscape": (60, 80),
    "portrait": (80, 60),
    "max_size_capped": (30, 150),
    "half_to_even_down": (21, 64),   # 52.5 -> 52
    "half_to_even_up": (23, 64),     # 57.5 -> 58
    "half_long_side": (22, 128),     # 27.5 -> 28
    "upscale_square": (50, 50),
    "full_canvas": (128, 160),
}
TOL = dict(rtol=1e-3, atol=5e-3)


def staged(rng, h, w):
    staging = np.zeros((*OUT_HW, 3), np.uint8)
    staging[:h, :w] = rng.randint(0, 256, (h, w, 3))
    # junk beyond the frame must not leak into the canvas
    staging[h:, :] = 255
    staging[:, w:] = 255
    return staging


@pytest.mark.parametrize("name", sorted(SIZES))
def test_resize_shortest_edge_device_matches_jax(name):
    h, w = SIZES[name]
    staging = staged(np.random.RandomState(h * 1000 + w), h, w)
    kw = dict(out_hw=OUT_HW, short=SHORT, max_size=MAX_SIZE)
    want, want_hw = jax_resize(jnp.asarray(staging),
                               jnp.asarray([h, w], jnp.int32), **kw)
    got, got_hw = resize_shortest_edge_device(torch.from_numpy(staging),
                                              (h, w), **kw)
    np.testing.assert_array_equal(got_hw.numpy(), np.asarray(want_hw))
    assert got.dtype == torch.float32 and got.shape == (*OUT_HW, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_preprocess_batch_device_matches_jax():
    rng = np.random.RandomState(0)
    hws = [SIZES[k] for k in sorted(SIZES)]
    staging = np.stack([staged(rng, h, w) for h, w in hws])
    kw = dict(out_hw=OUT_HW, short=SHORT, max_size=MAX_SIZE)
    want, want_hw = jax_batch(jnp.asarray(staging),
                              jnp.asarray(hws, jnp.int32), **kw)
    got, got_hw = preprocess_batch_device(torch.from_numpy(staging),
                                          np.asarray(hws), **kw)
    np.testing.assert_array_equal(got_hw.numpy(), np.asarray(want_hw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


@pytest.fixture(scope="module")
def predictors():
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=1)
    jpred = JaxPredictor(cfg=jcfg, model=jmodel, params=params,
                         max_classes=8)
    tpred = SylphPredictor(cfg=tcfg, model=tmodel, max_classes=8,
                           device="cpu")
    rng = np.random.RandomState(4)
    for name in ("widget", "gadget"):
        imgs = [rng.randint(0, 255, (90, 70, 3), np.uint8),
                rng.randint(0, 255, (60, 100, 3), np.uint8)]
        bxs = [np.array([5, 8, 60, 80], np.float32),
               np.array([10, 4, 90, 50], np.float32)]
        assert jpred.register_class(name, imgs, bxs) == \
            tpred.register_class(name, imgs, bxs)
    np.testing.assert_allclose(tpred.bank.conv.numpy(),
                               np.asarray(jpred.bank.conv), **TOL)
    return jpred, tpred


@pytest.mark.parametrize("hw,on_card", [((100, 120), True),
                                        ((200, 260), False)])
def test_predictor_device_preprocess_matches_jax(predictors, hw, on_card):
    """A frame that fits the eval canvas is resized by
    ``resize_shortest_edge_device``; a larger one takes the host path."""
    jpred, tpred = predictors
    image = np.random.RandomState(hw[0]).randint(0, 255, (*hw, 3), np.uint8)
    assert (tpred.prepare_device(image) is not None) == on_card
    want = jpred(image, device_preprocess=True)
    got = tpred(image, device_preprocess=True)
    n = len(want["scores"])
    assert n > 0 and len(got["scores"]) == n
    assert got["class_names"] == want["class_names"]
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.05)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    if not on_card:  # the host path is the one __call__ takes by default
        plain = tpred(image)
        np.testing.assert_array_equal(plain["boxes"], got["boxes"])
