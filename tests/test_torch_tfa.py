"""The port's TFA one-stage baseline against the JAX package (CPU, fp32):

  * the cosine classifier (MODEL.FCOS.L2_NORM_CLS_WEIGHT) against JAX's head
    (1e-5), with the scale invariance and bounded logits of
    tests/test_tfa.py, and no ``cls_logits`` parameters;
  * ``TFAFewShotDetectionRunner._preload_cls_logits`` from a flat ``.npz``,
    a port ``.pt`` and a detectron2 ``.pth``, each equal to what JAX's
    surgery writes; the loud skip; the cosine head meeting a checkpoint
    with ``cls_logits`` (JAX: KeyError; the port: a ValueError that says
    so);
  * TFA finetune steps through the plain path with the cosine head and the
    config's freezing, against JAX's losses (rtol 1e-4) and parameters.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models.fcos_head import FCOSHead as JaxHead
from sylph_tpu.runner.meta_fcos_runner import \
    TFAFewShotDetectionRunner as JaxTFARunner
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.models.fcos_head import FCOSHead
from sylph_tpu_torch.runner import TFAFewShotDetectionRunner
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (check_run, few_torch_threads,  # noqa: F401
                             pretrain_batch, randomize, register_both,
                             run_steps, tiny_model_pair, to_numpy)


def _feats(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(1, s, s, 256) * scale).astype(np.float32)
            for s in (8, 4, 2, 1, 1)]


def _nchw(feats):
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
            for f in feats]


@pytest.fixture(scope="module")
def cosine_heads():
    jhead = JaxHead(num_classes=4, num_cls_convs=1, num_box_convs=1,
                    l2_norm_cls_weight=True, compute_dtype=jnp.float32)
    feats = [jnp.asarray(f) for f in _feats(0)]
    params = randomize(jax.jit(jhead.init)(jax.random.PRNGKey(0), feats)
                       ["params"], np.random.RandomState(1))
    head = FCOSHead(4, num_cls_convs=1, num_box_convs=1,
                    l2_norm_cls_weight=True, compute_dtype=torch.float32)
    head.load_state_dict(state_dict_from_jax(to_numpy(params)), strict=True)
    return jhead, params, head


def test_cosine_head_matches_jax(cosine_heads):
    """Same weights, same features: every dense output within 1e-5; neither
    package has ``cls_logits`` on this path."""
    jhead, params, head = cosine_heads
    assert "cls_logits" not in params
    assert not any(k.startswith("cls_logits") for k in head.state_dict())
    feats = _feats(2)
    want = jax.jit(lambda p, f: jhead.apply({"params": p}, f))(
        params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = head(_nchw(feats))
    for name in ("logits", "reg", "ctrness", "iou"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_cosine_head_scale_invariance_and_bounded_logits(cosine_heads):
    """Scaling the raw weight 10x changes nothing (GN + L2 cancel it, the
    weights being O(1) so the GN eps is negligible); features of 100x give
    finite logits."""
    _, _, head = cosine_heads
    feats = _nchw(_feats(3))
    with torch.no_grad():
        w = head.cosine_weight.clone()
        head.cosine_weight.copy_(torch.randn(w.shape, generator=torch.
                                             Generator().manual_seed(3)))
        out1 = head(feats).logits
        head.cosine_weight.mul_(10.0)
        out2 = head(feats).logits
        head.cosine_weight.copy_(w)
        big = head(_nchw(_feats(4, scale=100.0))).logits
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.isfinite(big).all()


# ---------------------------------------------------------------- surgery
@pytest.fixture()
def tfa_coco(tmp_path):
    root = str(tmp_path / "coco")
    make_synthetic_coco(root)
    register_both(root)
    return root


def _cfgs(weights):
    """The surgery's config in each package: (jax cfg, port cfg)."""
    out = []
    for cls in (JaxTFARunner, TFAFewShotDetectionRunner):
        cfg = cls.get_default_cfg()
        cfg.MODEL.WEIGHTS = str(weights)
        cfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS = True
        cfg.DATASETS.BASE_CLASSES_SPLIT = "coco_pretrain_train_base"
        cfg.DATASETS.TRAIN = ["coco_pretrain_train_all"]
        out.append(cfg)
    return out


def _port_model(cosine=False):
    """A stand-in with the one attribute the surgery reads: a 6-class head
    on 8 channels, zeroed."""
    head = FCOSHead(6, in_channels=8, num_cls_convs=0, num_box_convs=0,
                    norm="", l2_norm_cls_weight=cosine,
                    compute_dtype=torch.float32)
    for p in head.parameters():
        torch.nn.init.zeros_(p)
    return types.SimpleNamespace(fcos_head=head)


def _jax_params():
    return {"fcos_head": {"cls_logits": {
        "kernel": np.zeros((1, 1, 8, 6), np.float32),
        "bias": np.zeros((6,), np.float32)}}}


BASE_K = np.arange(8 * 3, dtype=np.float32).reshape(1, 1, 8, 3)
BASE_B = np.asarray([10.0, 20.0, 30.0], np.float32)


def _write(kind, path):
    """A base-classes checkpoint (3 classes on 8 channels) as a flat .npz,
    a port .pt or a detectron2 .pth."""
    w = torch.from_numpy(BASE_K.transpose(3, 2, 0, 1).copy())
    if kind == "npz":
        np.savez(path, **{"fcos_head/cls_logits/kernel": BASE_K,
                          "fcos_head/cls_logits/bias": BASE_B,
                          "fcos_head/ctrness/bias": np.zeros(1, np.float32)})
    elif kind == "pt":
        torch.save({"step": 3, "model": {
            "fcos_head.cls_logits.weight": w,
            "fcos_head.cls_logits.bias": torch.from_numpy(BASE_B)}}, path)
    else:
        torch.save({"model": {
            "proposal_generator.fcos_head.cls_logits.weight": w,
            "proposal_generator.fcos_head.cls_logits.bias":
                torch.from_numpy(BASE_B)}}, path)


@pytest.mark.parametrize("kind", ["npz", "pt", "pth"])
def test_surgery_matches_jax(tfa_coco, tmp_path, kind):
    """Base split {8, 10, 11} -> contiguous {0, 1, 2} in the checkpoint and
    {3, 4, 5} in the all-classes head; the port writes what JAX writes (JAX
    reads the .npz twin of the port's .pt)."""
    path = tmp_path / f"base.{kind}"
    _write(kind, path)
    jpath = path
    if kind == "pt":
        jpath = tmp_path / "base.npz"
        _write("npz", jpath)
    jcfg, _ = _cfgs(jpath)
    _, tcfg = _cfgs(path)
    want = JaxTFARunner()._preload_cls_logits(jcfg, _jax_params())
    model = _port_model()
    assert TFAFewShotDetectionRunner(device="cpu")._preload_cls_logits(
        tcfg, model)
    conv = model.fcos_head.cls_logits
    k = np.asarray(want["fcos_head"]["cls_logits"]["kernel"])
    np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv.bias.detach().numpy(),
                                  want["fcos_head"]["cls_logits"]["bias"])
    for bi, ci in ((0, 3), (1, 4), (2, 5)):
        np.testing.assert_array_equal(conv.weight[ci, :, 0, 0].detach(),
                                      BASE_K[0, 0, :, bi])
    assert not conv.weight[:3].any()


def test_surgery_skips_loudly_and_refuses_the_cosine_head(tfa_coco, tmp_path,
                                                          caplog):
    """An unreadable MODEL.WEIGHTS or a checkpoint without ``cls_logits``
    warns and writes nothing, as in JAX; a checkpoint with ``cls_logits``
    meeting the cosine head is an error in both packages."""
    runner = TFAFewShotDetectionRunner(device="cpu")
    model = _port_model()
    _, cfg = _cfgs(tmp_path / "missing_dir")
    with caplog.at_level(logging.WARNING):
        assert not runner._preload_cls_logits(cfg, model)
    assert any("SKIPPED" in r.message for r in caplog.records)
    caplog.clear()
    np.savez(tmp_path / "headless.npz",
             **{"fcos_head/ctrness/bias": np.zeros(1, np.float32)})
    _, cfg = _cfgs(tmp_path / "headless.npz")
    with caplog.at_level(logging.WARNING):
        assert not runner._preload_cls_logits(cfg, model)
    assert any("no fcos_head/cls_logits" in r.message
               for r in caplog.records)
    assert not model.fcos_head.cls_logits.weight.any()

    _write("npz", tmp_path / "base.npz")
    jcfg, tcfg = _cfgs(tmp_path / "base.npz")
    cosine_params = {"fcos_head": {"cosine_weight": np.zeros((6, 8),
                                                             np.float32)}}
    with pytest.raises(KeyError):
        JaxTFARunner()._preload_cls_logits(jcfg, cosine_params)
    with pytest.raises(ValueError, match="cosine classifier"):
        runner._preload_cls_logits(tcfg, _port_model(cosine=True))


# ------------------------------------------------------------------ steps
def _tfa_cosine(cfg):
    cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = True


def test_tfa_cosine_steps_match_jax():
    """Three plain-path steps with the cosine head under the TFA finetune's
    freezing (backbone, cls tower, bbox branch): losses within rtol 1e-4,
    the cosine leaves trained to JAX's values, the frozen ones unchanged."""
    pair = tiny_model_pair(episodic=False, seed=6, tweak=_tfa_cosine)
    assert "cosine_weight" in pair[2]["fcos_head"]
    result = run_steps(pair, False, pretrain_batch(2),
                       freeze_kw=dict(backbone=True, cls_tower=True,
                                      bbox_branch=True, episodic=False))
    trainable = check_run(result, pair[4])
    assert {f"fcos_head.cosine_{n}" for n in (
        "weight", "bias", "scale", "gn_scale", "gn_bias")} <= trainable
    assert not any(n.startswith(("backbone.", "fcos_head.cls_tower.",
                                 "fcos_head.bbox_")) for n in trainable)
