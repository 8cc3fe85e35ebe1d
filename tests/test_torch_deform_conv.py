"""The port's DCNv2 (sylph_tpu_torch/ops/deform_conv.py) against the JAX
package's ``deform_conv2d`` / ``DFConv2d`` and the numpy oracle of
tests/test_deform_conv.py, its gradients against ``jax.grad``, and the FCOS
head with ``use_deformable`` against JAX's.

The JAX ``_Tower`` builds its ``DFConv2d`` without a compute dtype, so the
JAX layer always samples in bfloat16; the port samples in the model's
compute dtype. The float32 head comparison therefore runs JAX's layer at
float32 (a subclass with that default, swapped in for the test).
"""

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sylph_tpu.ops import deform_conv as jdc
from sylph_tpu_torch.ops.deform_conv import DFConv2d, deform_conv2d
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax
from test_deform_conv import _oracle
from torch_port_util import few_torch_threads, randomize, to_numpy  # noqa: F401


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _port(x, offset, mask, kernel, bias):
    """The port's deform_conv2d on the JAX layout's numpy inputs."""
    return deform_conv2d(
        _nchw(x), _nchw(offset), None if mask is None else _nchw(mask),
        torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        None if bias is None else torch.from_numpy(bias))


def _inputs(seed, b=2, h=5, w=6, c=3, cout=4, scale=1.7):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            (rng.randn(b, h, w, 18) * scale).astype(np.float32),
            rng.rand(b, h, w, 9).astype(np.float32),
            (rng.randn(3, 3, c, cout) * 0.3).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.mark.parametrize("modulated", [True, False])
def test_matches_jax_and_the_numpy_oracle(modulated):
    """Offsets of std 1.7 make every tap fractional and carry samples past
    the border, where the corners read zero."""
    x, offset, mask, kernel, bias = _inputs(0)
    mask = mask if modulated else None
    got = _nhwc(_port(x, offset, mask, kernel, bias))
    want = np.asarray(jax.jit(jdc.deform_conv2d)(
        jnp.asarray(x), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask), jnp.asarray(kernel),
        jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _oracle(x, offset, mask, kernel, bias),
                               rtol=2e-4, atol=2e-4)


def test_zero_offset_equals_plain_conv():
    x, _, _, kernel, bias = _inputs(1, b=1, h=7, w=8, c=5, cout=6)
    got = _port(x, np.zeros((1, 7, 8, 18), np.float32),
                np.ones((1, 7, 8, 9), np.float32), kernel, bias)
    want = F.conv2d(_nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1)),
                    torch.from_numpy(bias), padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_integer_offset_is_a_shift():
    """dx = +1 at every tap is the conv over the input shifted left by one
    column (column 0 differs by construction: SAME padding zeroes a column
    the sampler still reaches)."""
    x, _, _, kernel, _ = _inputs(2, b=1, h=6, w=6, c=2, cout=3)
    offset = np.zeros((1, 6, 6, 18), np.float32)
    offset[..., 1::2] = 1.0
    got = _port(x, offset, None, kernel, None)
    shifted = np.concatenate([x[:, :, 1:], np.zeros((1, 6, 1, 2),
                                                    np.float32)], 2)
    want = F.conv2d(_nchw(shifted),
                    torch.from_numpy(kernel.transpose(3, 2, 0, 1)), padding=1)
    np.testing.assert_allclose(got.numpy()[..., 1:], want.numpy()[..., 1:],
                               rtol=1e-5, atol=1e-5)


def test_dfconv_init_is_half_a_plain_conv_and_matches_jax():
    """With the offset head at 0 the layer is 0.5 x the plain conv plus the
    bias; with JAX's parameters (offset head randomized) it equals JAX's
    ``DFConv2d`` at float32."""
    x = np.random.RandomState(3).randn(2, 6, 6, 3).astype(np.float32)
    m = DFConv2d(3, 4)
    with torch.no_grad():
        m.offset.weight.zero_()
        m.offset.bias.zero_()
        m.weight.copy_(torch.randn(4, 3, 3, 3))
        m.bias.copy_(torch.randn(4))
    want = 0.5 * F.conv2d(_nchw(x), m.weight, padding=1) \
        + m.bias[None, :, None, None]
    np.testing.assert_allclose(m(_nchw(x)).detach().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=1e-5)

    jm = jdc.DFConv2d(4, compute_dtype=jnp.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
                       ["params"], np.random.RandomState(4))
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    got = _nhwc(m(_nchw(x)))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gradients_match_jax():
    """d(sum(out * r)) by the input, the offsets, the mask, the kernel and
    the bias against ``jax.grad`` (1e-4)."""
    x, offset, mask, kernel, bias = _inputs(5)
    r = np.random.RandomState(6).randn(2, 5, 6, 4).astype(np.float32)

    def jloss(*args):
        return jnp.sum(jdc.deform_conv2d(*args) * r)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, offset, mask, kernel, bias)))
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, offset, mask, kernel, bias)]
    out = deform_conv2d(ts[0].permute(0, 3, 1, 2), ts[1].permute(0, 3, 1, 2),
                        ts[2].permute(0, 3, 1, 2), ts[3].permute(3, 2, 0, 1),
                        ts[4])
    (out.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    for name, t, w in zip(("x", "offset", "mask", "kernel", "bias"), ts,
                          want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


class _JaxDFConv2dF32(jdc.DFConv2d):
    compute_dtype: Any = jnp.float32


def test_fcos_head_with_deformable_towers_matches_jax(monkeypatch):
    """Two-conv towers whose last conv is deformable, JAX's parameters with
    the offset heads randomized (fractional offsets of O(1)): every dense
    output equals JAX's at float32 (1e-4)."""
    from sylph_tpu.models.fcos_head import FCOSHead as JaxHead
    from sylph_tpu_torch.models.fcos_head import FCOSHead

    monkeypatch.setattr(jdc, "DFConv2d", _JaxDFConv2dF32)
    rng = np.random.RandomState(7)
    feats = [rng.randn(1, s, s, 256).astype(np.float32)
             for s in (8, 4, 2, 1, 1)]
    jhead = JaxHead(num_classes=5, num_cls_convs=2, num_box_convs=2,
                    use_deformable=True, compute_dtype=jnp.float32)
    jfeats = [jnp.asarray(f) for f in feats]
    params = randomize(jax.jit(jhead.init)(jax.random.PRNGKey(0), jfeats)
                       ["params"], rng)
    assert "offset" in params["cls_tower"]["conv1"]
    want = jax.jit(lambda p, f: jhead.apply({"params": p}, f))(params,
                                                               jfeats)
    head = FCOSHead(5, num_cls_convs=2, num_box_convs=2, use_deformable=True,
                    compute_dtype=torch.float32)
    head.load_state_dict(state_dict_from_jax(to_numpy(params)), strict=True)
    assert isinstance(head.cls_tower.conv1, DFConv2d)
    with torch.no_grad():
        got = head([_nchw(f) for f in feats])
    for name in ("logits", "reg", "ctrness", "iou"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
