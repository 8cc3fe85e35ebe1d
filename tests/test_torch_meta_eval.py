"""The port's meta-test phase 1 and runner against the JAX package's (CPU,
fp32).

Tiny R-18 with one-conv towers, 64x64 support and 128x160 eval canvases,
2 shots, the same random weights in both packages (``tiny_model_pair``),
on one synthetic COCO tree registered in both catalogs
(``make_meta_env``):

  * raw codes (class_batch 1 and 3) and the normalized bank against JAX's
    at rtol 1e-3 / atol 5e-3; all-GT base-code accumulation likewise;
  * ``.npz`` codes written by either package load into the other's
    predictor and give the same bank;
  * ``MetaFCOSRunner.do_test`` on the plain (non-episodic) config against
    JAX's, every ``eval_results`` key within 1e-4;
  * every new entry point raises on ``device="cuda"`` without a card.

Phase 2 and the repeated driver are in ``test_torch_meta_test.py``.
"""

import os

import numpy as np
import pytest
import torch

from sylph_tpu.data.loader import build_support_set_loader as jax_sup_loader
from sylph_tpu.data.meta_dataset import MetaDataset as JaxMetaDataset
from sylph_tpu.evaluation import meta_eval as jax_meta_eval
from sylph_tpu.predictor import SylphPredictor as JaxPredictor
from sylph_tpu.runner.meta_fcos_runner import MetaFCOSRunner as JaxRunner
from sylph_tpu_torch.data.loader import build_support_set_loader
from sylph_tpu_torch.data.meta_dataset import MetaDataset
from sylph_tpu_torch.evaluation import meta_eval
from sylph_tpu_torch.predictor import SylphPredictor
from sylph_tpu_torch.runner import (MetaFCOSRunner, _decode_cfg, _eval_grid,
                                    create_runner)

from torch_port_util import (assert_results_close, datasets_both,
                             make_meta_env, tiny_model_pair)

TOL = dict(rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_meta_env(str(tmp_path_factory.mktemp("coco")))


def support_sets(name, seed=0):
    jd, td = datasets_both(name)
    return (JaxMetaDataset(jd, "episodic_test_supportset", num_shot=2,
                           meta_test_seed=seed),
            MetaDataset(td, "episodic_test_supportset", num_shot=2,
                        meta_test_seed=seed))


def assert_codes_close(got, want):
    assert sorted(got) == sorted(want)
    for cid in want:
        assert got[cid]["class_name"] == want[cid]["class_name"]
        for key, w in want[cid]["code"].items():
            g = got[cid]["code"][key]
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == np.float32, key
            np.testing.assert_allclose(g, w, err_msg=key, **TOL)


def assert_bank_close(got, want):
    for key in ("cls_conv", "cls_bias"):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("class_batch", [1, 3])
def test_codes_and_bank_match_jax(env, class_batch):
    jds, tds = support_sets("coco_meta_val_all")
    want = jax_meta_eval.generate_class_codes(
        env["jmodel"], env["params"], jax_sup_loader(jds, env["jmapper"]),
        class_batch=class_batch)
    got = meta_eval.generate_class_codes(
        env["tmodel"], build_support_set_loader(tds, env["mapper"]),
        class_batch=class_batch, device="cpu")
    assert len(got) == 6
    assert_codes_close(got, want)
    bank = meta_eval.normalize_class_codes(env["tmodel"], got, device="cpu")
    assert bank["cls_conv"].shape == (6, 256)
    assert_bank_close(bank, jax_meta_eval.normalize_class_codes(
        env["jmodel"], env["params"], want))
    if class_batch > 1:  # the batched form equals one class per call
        assert_codes_close(meta_eval.generate_class_codes(
            env["tmodel"], build_support_set_loader(tds, env["mapper"]),
            device="cpu"), got)


def test_base_code_accumulation_matches_jax(env):
    jds, tds = support_sets("coco_meta_val_all")
    kw = dict(chunk_size=4, max_records=8)
    want = jax_meta_eval.generate_base_class_codes(
        env["jmodel"], env["params"], jds, env["jmapper"], **kw)
    got = meta_eval.generate_base_class_codes(
        env["tmodel"], tds, env["mapper"], device="cpu", **kw)
    assert_codes_close(got, want)
    chunks = [{"cls_conv": np.full((1, 2), 1.0), "cls_bias": np.ones(1)},
              {"cls_conv": np.full((1, 2), 3.0), "cls_bias": np.zeros(1)}]
    acc = meta_eval.accumulate_base_codes(chunks, [0.25, 0.75])
    np.testing.assert_allclose(acc["cls_conv"], [[2.5, 2.5]])
    np.testing.assert_allclose(acc["cls_bias"], [0.25])
    merged = meta_eval.replace_with_base_codes({0: "few", 1: "few"},
                                               {1: "base"})
    assert merged == {0: "few", 1: "base"}


def test_npz_codes_cross_both_ways(env, tmp_path):
    jds, tds = support_sets("coco_meta_val_novel")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcodes = jax_meta_eval.generate_class_codes(
        env["jmodel"], env["params"], jax_sup_loader(jds, env["jmapper"]),
        save_dir=jdir)
    meta_eval.generate_class_codes(
        env["tmodel"], build_support_set_loader(tds, env["mapper"]),
        save_dir=tdir, class_batch=3, device="cpu")
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        ["cat1.npz", "cat2.npz", "cat3.npz"]
    for f in os.listdir(jdir):
        a, b = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and b[k].dtype == np.float32
    want = jax_meta_eval.normalize_class_codes(env["jmodel"], env["params"],
                                               jcodes)
    for path in (jdir, tdir):  # each directory into each predictor
        ours = SylphPredictor(cfg=env["tcfg"], model=env["tmodel"],
                              class_code_path=path, max_classes=4,
                              device="cpu")
        theirs = JaxPredictor(cfg=env["jcfg"], model=env["jmodel"],
                              params=env["params"], class_code_path=path,
                              max_classes=4)
        assert ours.bank.names == theirs.bank.names
        assert ours.bank.valid.tolist() == np.asarray(
            theirs.bank.valid).tolist()
        np.testing.assert_allclose(ours.bank.conv.numpy(),
                                   np.asarray(theirs.bank.conv), **TOL)
        np.testing.assert_allclose(ours.bank.bias.numpy(),
                                   np.asarray(theirs.bank.bias), **TOL)
        assert_bank_close({"cls_conv": ours.bank.conv[:3],
                           "cls_bias": ours.bank.bias[:3]}, want)


def test_predictor_registers_from_a_dataset(env):
    ours = SylphPredictor(cfg=env["tcfg"], model=env["tmodel"],
                          max_classes=8, device="cpu")
    theirs = JaxPredictor(cfg=env["jcfg"], model=env["jmodel"],
                          params=env["params"], max_classes=8)
    np.random.seed(5)
    assert ours.generate_class_codes_from_dataset("coco_meta_val_novel") == 3
    np.random.seed(5)
    assert theirs.generate_class_codes_from_dataset(
        "coco_meta_val_novel") == 3
    assert ours.bank.names == theirs.bank.names
    np.testing.assert_allclose(ours.bank.conv.numpy(),
                               np.asarray(theirs.bank.conv), **TOL)


def test_do_test_plain_matches_jax(env, tmp_path):
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(episodic=False,
                                                         seed=3)
    for cfg in (jcfg, tcfg):
        cfg.DATASETS.TEST = ["coco_pretrain_val_all"]
    tcfg.OUTPUT_DIR = str(tmp_path)
    want = JaxRunner().do_test(jcfg, jmodel, params)
    got = MetaFCOSRunner("cpu").do_test(tcfg, tmodel)
    bbox = got["coco_pretrain_val_all"]["bbox"]
    assert_results_close(bbox, want["coco_pretrain_val_all"]["bbox"])
    assert {"nAP", "bAP", "AR@10"} <= set(bbox)
    assert os.listdir(tmp_path / "tb")  # the scalars were written


def test_entry_points_refuse_cuda_without_a_card(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, grid = env["tmodel"], _eval_grid(env["tcfg"])
    bank = {"cls_conv": np.zeros((2, 256), np.float32),
            "cls_bias": np.zeros((2,), np.float32)}
    calls = [
        lambda: MetaFCOSRunner(),
        lambda: create_runner("MetaFCOSRunner"),
        lambda: meta_eval.MetaTestDriver(model, {}, None, grid, None),
        lambda: meta_eval.generate_class_codes(model, iter([])),
        lambda: meta_eval.generate_base_class_codes(model, None, None),
        lambda: meta_eval.normalize_class_codes(model, {}),
        lambda: meta_eval.make_fcos_infer(model, bank, grid,
                                          _decode_cfg(env["tcfg"])),
        lambda: meta_eval.run_query_inference(None, iter([]), {}, None),
        lambda: SylphPredictor(cfg=env["tcfg"], model=model),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_parts_raise(tmp_path):
    """An orbax checkpoint directory (it needs JAX to read) raises; every
    runner builds, the one-stage variants included. The sharded
    registration is ported: tests/test_torch_dp_registration.py."""
    from sylph_tpu_torch.train.checkpoint import load_params_any
    (tmp_path / "orbax" / "params").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_params_any(str(tmp_path / "orbax"))
    assert isinstance(create_runner("sylph.runner.MetaFCOSRunner",
                                    device="cpu"), MetaFCOSRunner)
    for name in ("MetaFasterRCNNRunner", "TFAFasterRCNNRunner",
                 "MetaFCOSROIEncoderRunner", "TFAFewShotDetectionRunner"):
        assert type(create_runner(name, device="cpu")).__name__ == name
