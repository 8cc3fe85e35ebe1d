"""Two config switches of the port against the JAX package, on the CPU
(the third, ``TPU.EVAL_BF16_RESIDENT``, is in tests/test_torch_eval_bf16.py):

  * ``TPU.S2D_STEM``: the port's ResNet-18 + FPN with the space-to-depth
    stem against JAX's ``s2d_stem=True`` on the same weights (1e-4, pixels
    near the BGR mean as in tests/test_torch_modules.py) and against the
    port's own 7x7 model on the converted weights; ``stem_kernel_to_s2d`` /
    ``stem_kernel_from_s2d`` equal to JAX's exactly, and their round trip;
    a 7x7 checkpoint into an s2d model and back through ``merge_state_dict``
    and ``state_dict_from_jax``;
  * ``DFConv2d(dilation=2)`` against JAX's layer at float32, through
    tests/test_torch_deform_conv.py's float32 subclass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models import resnet as jresnet
from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu_torch.models import resnet
from sylph_tpu_torch.models.meta_arch import MetaOneStageDetector
from sylph_tpu_torch.ops.deform_conv import DFConv2d
from sylph_tpu_torch.runner import init_random_weights
from sylph_tpu_torch.train.checkpoint import merge_state_dict
from sylph_tpu_torch.utils.convert_weights import (jax_params_from_state_dict,
                                                   load_jax_params,
                                                   state_dict_from_jax)

from test_torch_deform_conv import _JaxDFConv2dF32, _nchw, _nhwc
from torch_port_util import few_torch_threads, randomize  # noqa: F401

CANVAS = (64, 128)
STEM = "backbone.stem_conv1.weight"


# ------------------------------------------------------------ s2d stem
def _images(seed, b=2, hw=CANVAS):
    mean = np.array([103.530, 116.280, 123.675], np.float32)
    rng = np.random.RandomState(seed)
    return (mean + 2.0 * rng.randn(b, *hw, 3)).astype(np.float32)


def _jax_r18(s2d):
    return JaxDetector(depth=18, num_classes=4, compute_dtype=jnp.float32,
                       code_generator_name="none", s2d_stem=s2d)


def _jax_init(s2d, images, seed):
    return jax.jit(lambda r, x: _jax_r18(s2d).init(r, x))(
        jax.random.PRNGKey(seed), jnp.asarray(images))["params"]


def _port_r18(s2d):
    return MetaOneStageDetector(depth=18, num_classes=4,
                                compute_dtype=torch.float32,
                                code_generator_name="none", s2d_stem=s2d)


def _features(model, images):
    with torch.no_grad():
        return [f.permute(0, 2, 3, 1).numpy()
                for f in model.extract_features(torch.from_numpy(images))]


def test_s2d_backbone_fpn_matches_jax_and_the_7x7_model():
    images = _images(4)
    rng = np.random.RandomState(4)
    p7 = randomize(_jax_init(False, images, 0), rng)
    # the s2d params: the same tree with the converted stem kernel
    p4 = jax.tree.map(lambda x: x, p7)
    p4["backbone"]["stem_conv1"]["kernel"] = jresnet.stem_kernel_to_s2d(
        p7["backbone"]["stem_conv1"]["kernel"])
    want = jax.jit(lambda p, x: _jax_r18(True).apply(
        {"params": p}, x, method=JaxDetector.extract_features))(
            p4, jnp.asarray(images))
    model = load_jax_params(_port_r18(True), p4)
    assert tuple(model.state_dict()[STEM].shape) == (64, 12, 4, 4)
    got = _features(model, images)
    plain = _features(load_jax_params(_port_r18(False), p7), images)
    assert len(got) == len(want) == len(plain) == 5
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g, p, rtol=1e-4, atol=1e-4)


def test_s2d_refuses_an_odd_canvas():
    with pytest.raises(ValueError, match="space_to_depth"):
        resnet.space_to_depth(torch.zeros(1, 3, 6, 7))


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(1).randn(2, 6, 8, 3).astype(np.float32)
    want = np.asarray(jresnet.space_to_depth(jnp.asarray(x)))
    got = resnet.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_stem_kernels_match_jax_exactly_and_round_trip():
    w7 = np.random.RandomState(2).randn(7, 7, 3, 64).astype(np.float32)
    w4 = jresnet.stem_kernel_to_s2d(w7)
    t7 = torch.from_numpy(w7.transpose(3, 2, 0, 1).copy())
    t4 = resnet.stem_kernel_to_s2d(t7)
    np.testing.assert_array_equal(t4.permute(2, 3, 1, 0).numpy(), w4)
    np.testing.assert_array_equal(
        resnet.stem_kernel_from_s2d(t4).permute(2, 3, 1, 0).numpy(),
        jresnet.stem_kernel_from_s2d(w4))
    assert torch.equal(resnet.stem_kernel_from_s2d(t4), t7)
    # the scatter is injective: 49 taps x 3 channels land, the rest are 0
    assert int((t4 != 0).sum()) == int((t7 != 0).sum())


@pytest.mark.parametrize("to_s2d", [True, False])
def test_checkpoints_cross_between_stems(to_s2d):
    """A 7x7 checkpoint (a flax tree, ``state_dict_from_jax``, then
    ``merge_state_dict``) loads into an s2d model and an s2d one into a 7x7
    model; either way the features equal the source model's, and the
    stem's round trip is exact. The s2d source's stem has its taps on the
    7x7 support (an s2d checkpoint made from a 7x7 one): the 4x4 corner
    taps that a 7x7 kernel cannot hold are dropped going back, as in JAX's
    ``stem_kernel_from_s2d``."""
    images = _images(5)
    src = init_random_weights(_port_r18(not to_s2d), 5)
    if not to_s2d:
        with torch.no_grad():
            w = src.backbone.stem_conv1.weight
            w.copy_(resnet.stem_kernel_to_s2d(resnet.stem_kernel_from_s2d(w)))
    params = jax_params_from_state_dict(src.state_dict())
    dst = merge_state_dict(_port_r18(to_s2d), state_dict_from_jax(params))
    for g, w in zip(_features(dst, images), _features(src, images)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    back = merge_state_dict(_port_r18(not to_s2d), dst.state_dict())
    for k, v in src.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# ------------------------------------------------------------ dilated DCN
def test_dilated_dfconv_matches_jax():
    """dilation 2: the offset conv dilated and padded dilation*(k-1)//2 as
    in JAX, the taps 2 apart; the offset head at randomized weights, so the
    samples fall between pixels and past the border."""
    x = np.random.RandomState(12).randn(2, 9, 10, 3).astype(np.float32)
    jm = _JaxDFConv2dF32(4, dilation=2)
    params = randomize(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
                       ["params"], np.random.RandomState(13))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = DFConv2d(3, 4, dilation=2)
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = _nhwc(m(_nchw(x)))
    assert got.shape == want.shape == (2, 9, 10, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = DFConv2d(3, 4)
    plain.load_state_dict(m.state_dict())
    with torch.no_grad():
        assert not np.allclose(_nhwc(plain(_nchw(x))), got, atol=1e-3)
