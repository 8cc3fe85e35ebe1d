"""The port's device RandAugment against the JAX package's
``rand_augment_device``: uint8-equal, op by op and on a batch, at odd
content sizes inside zero-padded BGR canvases, on the CPU."""

import numpy as np
import pytest
import torch

from sylph_tpu.data import transforms as JT
from sylph_tpu.ops.image_aug import rand_augment_device as jax_aug
from sylph_tpu_torch.data import transforms as T
from sylph_tpu_torch.ops.image_aug import rand_augment_device

from torch_port_util import few_torch_threads  # noqa: F401

H, W = 48, 64  # canvas
SIZES = [(37, 53), (48, 64), (3, 5), (1, 1), (29, 64)]
PARAMS = {"autocontrast": 0.0, "equalize": 0.0, "color": 1.37,
          "contrast": 0.61, "brightness": 1.24, "sharpness": 0.55,
          "posterize": 3.0, "solarize": 77.0}



def _canvases(rng, sizes, low=0, high=256):
    out = np.zeros((len(sizes), H, W, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        out[i, :h, :w] = rng.randint(low, high, (h, w, 3))
    return out


def _both(canvas, ops, params, sizes):
    want = np.asarray(jax_aug(canvas, ops, params, sizes, bgr=True))
    got = rand_augment_device(torch.as_tensor(canvas), ops, params, sizes,
                              bgr=True)
    assert got.dtype == torch.uint8
    return want, got.numpy()


def test_op_ids_in_lockstep_with_jax():
    assert T._COLOR_OPS == JT._COLOR_OPS


@pytest.mark.parametrize("name", T._COLOR_OPS)
@pytest.mark.parametrize("size", SIZES)
def test_each_op_matches_jax(name, size):
    op = T._COLOR_OPS.index(name)
    rng = np.random.RandomState(op * 7 + size[0])
    for low, high in ((0, 256), (90, 140)):  # full range, narrow histogram
        canvas = _canvases(rng, [size], low, high)
        want, got = _both(canvas, np.array([[op]], np.int32),
                          np.array([[PARAMS[name]]], np.float32),
                          np.array([size], np.int32))
        np.testing.assert_array_equal(got, want)
        h, w = size
        assert got[0, h:].max(initial=0) == 0
        assert got[0, :, w:].max(initial=0) == 0


def test_constant_image_keeps_identity_branches():
    """hi <= lo (autocontrast) and step == 0 (equalize) leave pixels be."""
    canvas = np.zeros((2, H, W, 3), np.uint8)
    canvas[:, :20, :30] = 77
    for op in (0, 1):
        want, got = _both(canvas, np.full((2, 1), op, np.int32),
                          np.zeros((2, 1), np.float32),
                          np.array([[20, 30], [20, 30]], np.int32))
        np.testing.assert_array_equal(got, want)
        assert (got[:, :20, :30] == 77).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drawn_batch_matches_jax(seed):
    """A batch of sizes with two drawn ops each, as the mapper draws them."""
    rng = np.random.RandomState(seed)
    sizes = np.array([(rng.randint(1, H + 1), rng.randint(1, W + 1))
                      for _ in range(6)], np.int32)
    canvas = _canvases(rng, sizes)
    drawn = [T.draw_rand_augment(np.random.RandomState(seed * 10 + i))
             for i in range(6)]
    jdrawn = [JT.draw_rand_augment(np.random.RandomState(seed * 10 + i))
              for i in range(6)]
    for (a, b), (c, d) in zip(drawn, jdrawn):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    ops = np.stack([d[0] for d in drawn])
    params = np.stack([d[1] for d in drawn])
    want, got = _both(canvas, ops, params, sizes)
    np.testing.assert_array_equal(got, want)
