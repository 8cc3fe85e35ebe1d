"""The port's ROIEncoder (sylph_tpu_torch/models/roi_encoder.py) against the
JAX package's (CPU, fp32):

  * the bare module at the LVIS config's depth (two GN tokenizer convs, two
    FCs, two encoder layers, two-FC heads): codes at eval within 1e-5; the
    R-18 model on the COCO ROIEncoder config within the backbone's 1e-4;
  * ``_adaptive_avg_pool`` against ``F.adaptive_avg_pool2d`` at odd sizes;
  * the flax ``DenseGeneral`` leaves of the attention crossing by
    ``state_dict_from_jax`` with ``strict=True``;
  * episodic train steps at DROPOUT 0.0 against JAX's (losses rtol 1e-4,
    parameters as tests/test_torch_train_episodic.py holds them);
  * with DROPOUT 0.1: eval deterministic, training draws reproducible from
    the generator's seed and different across seeds, and no training
    without a generator; ``normalize_code`` refused in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sylph_tpu.models import roi_encoder as jre
from sylph_tpu_torch.models.roi_encoder import ROIEncoder
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (check_run, episodic_batch,  # noqa: F401
                             few_torch_threads, randomize, run_steps,
                             tiny_model_pair, to_numpy)

LVIS_KW = dict(tokenizer_num_conv=2, tokenizer_norm="GN", tokenizer_num_fc=2,
               transformer_layers=2, head_num_fc=2)
SHOTS = 3


def _support_inputs(seed, classes=2):
    """FPN maps of 64x64 support canvases (P3-P7), one box per image."""
    rng = np.random.RandomState(seed)
    s = classes * SHOTS
    feats = [rng.randn(s, h, h, 256).astype(np.float32)
             for h in (8, 4, 2, 1, 1)]
    xy = rng.uniform(0, 24, (s, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(12, 40, (s, 2))],
                           -1).astype(np.float32)
    return feats, boxes, np.ones((s,), bool)


def _torch_feats(feats):
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
            for f in feats]


@pytest.fixture(scope="module")
def encoders():
    """JAX's module at the LVIS depth, its randomized params, the port's
    module with those params (dropout 0.1 in both)."""
    jm = jre.ROIEncoder(compute_dtype=jnp.float32, **LVIS_KW)
    feats, boxes, valid = _support_inputs(0)
    params = randomize(jax.jit(
        lambda r: jm.init(r, [jnp.asarray(f) for f in feats],
                          jnp.asarray(boxes), jnp.asarray(valid), SHOTS,
                          training=False))(jax.random.PRNGKey(0))["params"],
        np.random.RandomState(1))
    tm = ROIEncoder(compute_dtype=torch.float32, **LVIS_KW)
    tm.load_state_dict(state_dict_from_jax(to_numpy(params)), strict=True)
    return jm, params, tm.eval()


def test_codes_match_jax_at_eval(encoders):
    jm, params, tm = encoders
    feats, boxes, valid = _support_inputs(2)
    want = jax.jit(lambda p, f, b, v: jm.apply(
        {"params": p}, f, b, v, SHOTS, training=False))(
        params, [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        jnp.asarray(valid))
    with torch.no_grad():
        got = tm(_torch_feats(feats), torch.from_numpy(boxes),
                 torch.from_numpy(valid), SHOTS)
    assert got["cls_conv"].shape == (2, 256) and got["cls_bias"].shape == (2,)
    for k in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_dense_general_leaves_cross_strictly(encoders):
    """query/key/value kernels (d, heads, head_dim) and the out kernel
    (heads, head_dim, d) become the port's projection weights; the
    (heads, head_dim) biases keep their shape."""
    _, params, tm = encoders
    att = params["encoder_layer1"]["self_attn"]
    port = tm.encoder_layer1.self_attn
    for name in ("query", "key", "value"):
        k = np.asarray(att[name]["kernel"])
        assert k.shape == (256, 8, 32)
        np.testing.assert_array_equal(
            getattr(port, name).weight.detach().numpy(),
            k.reshape(256, 256).T)
        np.testing.assert_array_equal(getattr(port, name).bias.detach(),
                                      np.asarray(att[name]["bias"]))
    np.testing.assert_array_equal(port.out.weight.detach().numpy(),
                                  np.asarray(att["out"]["kernel"])
                                  .reshape(256, 256).T)


@pytest.mark.parametrize("hw", [(5, 9), (13, 7), (3, 3), (1, 1), (8, 4)])
def test_adaptive_avg_pool_matches_jax(hw):
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jre._adaptive_avg_pool(jnp.asarray(x), 7))
    got = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_dropout_draws_come_from_the_generator(encoders):
    """Eval ignores dropout; a training call draws its masks from the
    generator: the same seed gives the same codes, another seed others, and
    a training call without a generator is refused."""
    _, _, tm = encoders
    feats, boxes, valid = _support_inputs(3)
    args = (_torch_feats(feats), torch.from_numpy(boxes),
            torch.from_numpy(valid), SHOTS)

    def run(training, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tm(*args, training=training, generator=gen)["cls_conv"]

    assert torch.equal(run(False), run(False, 5))
    a, b, c = run(True, 5), run(True, 5), run(True, 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, run(False))
    with pytest.raises(ValueError, match="generator"):
        run(True)


def _roi_encoder(dropout):
    def tweak(cfg):
        cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"
        cfg.MODEL.META_LEARN.CODE_GENERATOR.TRANSFORMER_ENCODER.DROPOUT = \
            dropout
    return tweak


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(seed=3, tweak=_roi_encoder(0.0))


def test_model_codes_match_jax_and_refuse_normalization(pair):
    """R-18 on the COCO ROIEncoder config: ``forward_class_code`` within
    1e-4 of JAX's, the backbone's tolerance (tests/test_torch_modules.py:
    pixels near the BGR mean, so the tolerance measures the port and not
    fp32 rounding of O(100) activations); ``normalize_code`` refused by both
    models."""
    from sylph_tpu.models.meta_arch import MetaOneStageDetector

    jcfg, jmodel, params, _, tmodel = pair
    rng = np.random.RandomState(4)
    mean = np.array([103.530, 116.280, 123.675], np.float32)
    sup = (mean + 2.0 * rng.randn(2 * 2, 64, 64, 3)).astype(np.float32)
    boxes = np.tile(np.array([[6, 8, 50, 44]], np.float32), (4, 1))
    valid = np.ones((4,), bool)
    want = jax.jit(lambda p, s, b, v: jmodel.apply(
        {"params": p}, s, b, v, 2,
        method=MetaOneStageDetector.forward_class_code))(
        params, jnp.asarray(sup), jnp.asarray(boxes), jnp.asarray(valid))
    with torch.no_grad():
        got = tmodel.forward_class_code(torch.from_numpy(sup),
                                        torch.from_numpy(boxes),
                                        torch.from_numpy(valid), 2)
    for k in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    with pytest.raises(AssertionError):
        jmodel.apply({"params": params}, {k: jnp.asarray(v.numpy())
                                          for k, v in got.items()},
                     method=MetaOneStageDetector.normalize_code)
    with pytest.raises(ValueError, match="final codes"):
        tmodel.normalize_code(got)


def test_episodic_steps_match_jax_at_dropout_zero(pair):
    """Three episodic steps with the finetune freezing: losses within rtol
    1e-4, the ROIEncoder (its attention included) trained to JAX's
    parameters, the backbone and the bbox branch unchanged."""
    result = run_steps(pair, True, episodic_batch(1))
    trainable = check_run(result, pair[4])
    assert {"code_generator.encoder_layer0.self_attn.query.weight",
            "code_generator.tok_fc0.weight",
            "code_generator.ms_cam.local_conv1.weight"} <= trainable
    assert "fcos_head.bbox_tower.conv0.weight" not in trainable
