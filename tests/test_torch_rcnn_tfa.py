"""The port's plain two-stage evaluation and TFA-RCNN surgery against the
JAX package's (CPU, fp32): ``do_test`` with the base classifier
(``_do_test_plain_rcnn``) on a tiny synthetic LVIS tree, every
``eval_results`` key within 1e-4; the three surgery cases of
tests/test_tfa.py (linear -> cosine, linear -> linear, the loud skip) with
the transplanted parameters equal; and the surgery inside ``build_model``.
"""

import logging

import numpy as np
import pytest
import torch

from sylph_tpu.runner.meta_faster_rcnn_runner import \
    MetaFasterRCNNRunner as JaxRunner
from sylph_tpu.runner.meta_faster_rcnn_runner import \
    TFAFasterRCNNRunner as JaxTFARunner
from sylph_tpu_torch.meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                                     TFAFasterRCNNRunner)
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from test_torch_rcnn_meta_test import register_lvis_both
from torch_port_util import (assert_results_close, few_torch_threads,  # noqa: F401
                             flat_paths, rcnn_pair, register_both,
                             shrink_rcnn_cfg)


def test_plain_do_test_matches_jax(tmp_path):
    """lvis_pretrain_val_basev1 through the linear base classifier."""
    register_lvis_both(tmp_path)
    jcfg, jmodel, params, tcfg, tmodel = rcnn_pair(episodic=False, seed=2)
    for cfg in (jcfg, tcfg):
        cfg.DATASETS.TEST = ["lvis_pretrain_val_basev1"]
    want = JaxRunner().do_test(jcfg, jmodel, params)
    got = MetaFasterRCNNRunner(device="cpu").do_test(tcfg, tmodel)
    name = "lvis_pretrain_val_basev1"
    assert_results_close(got[name]["bbox"], want[name]["bbox"])
    assert np.isfinite(got[name]["bbox"]["AP"])


@pytest.fixture()
def tfa_coco(tmp_path):
    from sylph_tpu_torch.data.synthetic import make_synthetic_coco
    make_synthetic_coco(str(tmp_path / "coco"))
    register_both(str(tmp_path / "coco"))


def tfa_cfgs(weights, shrink=False):
    """JAX's and the port's TFA-RCNN config (at test size with ``shrink``):
    base split coco_pretrain_train_base ({8, 10, 11} -> 0-2), all classes
    coco_pretrain_train_all (8, 10, 11 -> 3-5)."""
    out = []
    for runner in (JaxTFARunner, TFAFasterRCNNRunner):
        cfg = runner.get_default_cfg()
        if shrink:
            shrink_rcnn_cfg(cfg, episodic=False)
        cfg.MODEL.WEIGHTS = str(weights)
        cfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS = True
        cfg.DATASETS.BASE_CLASSES_SPLIT = "coco_pretrain_train_base"
        cfg.DATASETS.TRAIN = ["coco_pretrain_train_all"]
        out.append(cfg)
    return out


def base_npz(path, fc=8, with_bias=True):
    base_k = np.arange(fc * 4, dtype=np.float32).reshape(fc, 4)
    leaves = {"box_head/cls_score/kernel": base_k}
    if with_bias:
        leaves["box_head/cls_score/bias"] = np.float32([1, 2, 3, 4])
    np.savez(path, **leaves)
    return base_k


@pytest.mark.parametrize("target", ["cosine", "linear"])
def test_surgery_matches_jax(tfa_coco, tmp_path, target):
    """The base detector's linear cls_score columns land as rows of the
    all-classes head, background row included, in both packages."""
    fc = 8
    base_k = base_npz(tmp_path / "rcnn_base.npz", fc)
    if target == "cosine":
        params = {"box_head": {"cosine_weight": np.zeros((7, fc),
                                                         np.float32)}}
    else:
        params = {"box_head": {"cls_score": {
            "kernel": np.zeros((fc, 7), np.float32),
            "bias": np.zeros((7,), np.float32)}}}
    jcfg, tcfg = tfa_cfgs(tmp_path / "rcnn_base.npz")
    want = JaxTFARunner()._preload_roi_cls_rows(
        jcfg, {"box_head": dict(params["box_head"])})
    state = state_dict_from_jax(params)
    got = TFAFasterRCNNRunner(device="cpu")._preload_roi_cls_rows(tcfg,
                                                                  state)
    want_sd = state_dict_from_jax(
        {"box_head": {k: (np.asarray(v) if not isinstance(v, dict) else
                          {kk: np.asarray(vv) for kk, vv in v.items()})
                      for k, v in want["box_head"].items()}})
    assert sorted(got) == sorted(want_sd)
    for k in got:
        assert torch.equal(got[k], want_sd[k]), k
    rows = got["box_head.cosine_weight" if target == "cosine"
               else "box_head.cls_score.weight"]
    for bi, ci in ((0, 3), (1, 4), (2, 5), (-1, -1)):
        np.testing.assert_array_equal(rows[ci].numpy(), base_k[:, bi])
    assert not rows[:3].any()                             # novel rows


def test_surgery_skips_loudly(tfa_coco, tmp_path, caplog):
    """An unreadable MODEL.WEIGHTS or one without a box-head classifier
    warns and leaves the head as it was; a detectron2 file is converted, not
    skipped, so a missing one raises as it does in JAX."""
    runner = TFAFasterRCNNRunner(device="cpu")
    state = {"box_head.cosine_weight": torch.zeros(7, 8)}
    _, cfg = tfa_cfgs(tmp_path / "missing_dir")
    with caplog.at_level(logging.WARNING):
        assert runner._preload_roi_cls_rows(cfg, state) is state
    assert any("SKIPPED" in r.message for r in caplog.records)
    caplog.clear()
    np.savez(tmp_path / "headless.npz",
             **{"box_head/bbox_pred/bias": np.zeros(4, np.float32)})
    _, cfg = tfa_cfgs(tmp_path / "headless.npz")
    with caplog.at_level(logging.WARNING):
        assert runner._preload_roi_cls_rows(cfg, state) is state
    assert any("no box_head classifier" in r.message
               for r in caplog.records)
    _, cfg = tfa_cfgs(tmp_path / "base.pth")
    with pytest.raises(FileNotFoundError):
        runner._preload_roi_cls_rows(cfg, state)


def test_build_model_performs_the_surgery(tfa_coco, tmp_path):
    """``TFAFasterRCNNRunner.build_model`` with a flat .npz of a 3-class
    base detector: the shared weights load, and the base rows land in the
    6-class linear head at the all-classes positions."""
    _, _, params, _, _ = rcnn_pair(episodic=False, seed=4)
    leaves = flat_paths(params)
    k = leaves["box_head/cls_score/kernel"]
    leaves["box_head/cls_score/kernel"] = k[:, [0, 1, 2, -1]]
    leaves["box_head/cls_score/bias"] = \
        leaves["box_head/cls_score/bias"][[0, 1, 2, -1]]
    np.savez(tmp_path / "base3.npz", **leaves)
    _, cfg = tfa_cfgs(tmp_path / "base3.npz", shrink=True)
    model = TFAFasterRCNNRunner(device="cpu").build_model(cfg)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["backbone.stem_conv1.weight"].numpy(),
                                  state_dict_from_jax(params)[
                                      "backbone.stem_conv1.weight"].numpy())
    w, b = sd["box_head.cls_score.weight"], sd["box_head.cls_score.bias"]
    for bi, ci in ((0, 3), (1, 4), (2, 5), (-1, -1)):
        np.testing.assert_array_equal(w[ci].numpy(), k[:, [0, 1, 2, -1][bi]])
        assert float(b[ci]) == float(
            params["box_head"]["cls_score"]["bias"][[0, 1, 2, -1][bi]])
