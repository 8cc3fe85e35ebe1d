"""The port's meta-test driver against the JAX package's (CPU, fp32).

Same tiny model pair and synthetic tree as ``test_torch_meta_eval.py``
(``make_meta_env``). ``MetaTestDriver.run_once`` runs both phases in each
package on coco_meta_val_all with all-GT base codes: the COCO result
lists the evaluators received match (image and category ids equal, boxes
within 0.05, scores within 1e-3) and every ``eval_results`` key is within
1e-4. ``run_repeated`` over two seeds gives JAX's per-seed results and its
nanmean / nanstd aggregation.
"""

import numpy as np
import pytest

from sylph_tpu.evaluation import meta_eval as jax_meta_eval
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.runner.meta_fcos_runner import MetaFCOSRunner as JaxRunner
from sylph_tpu.runner.meta_fcos_runner import _decode_cfg as jax_decode_cfg
from sylph_tpu_torch.evaluation import meta_eval
from sylph_tpu_torch.runner import MetaFCOSRunner, _decode_cfg, _eval_grid

from torch_port_util import (assert_results_close, datasets_both,
                             make_meta_env)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_meta_env(str(tmp_path_factory.mktemp("coco")))


def drivers(env, name, use_base):
    """JAX's and the port's driver on one dataset; each records the
    evaluators it makes."""
    jd, td = datasets_both(name)
    made = {"jax": [], "port": []}

    def factory(side, runner, cfg):
        def make(recs, meta):
            ev = runner.get_evaluator(cfg, name, recs, meta)
            made[side].append(ev)
            return ev
        return make

    jcfg, tcfg = env["jcfg"], env["tcfg"]
    common = dict(eval_shot=2, use_all_gts_in_base=use_base,
                  base_chunk_size=4, base_max_records=8, eval_batch=4)
    jdrv = jax_meta_eval.MetaTestDriver(
        env["jmodel"], env["params"], jd, env["jmapper"],
        jax_grid(tuple(jcfg.TPU.EVAL_CANVAS),
                 tuple(jcfg.MODEL.FCOS.FPN_STRIDES),
                 list(jcfg.MODEL.FCOS.SIZES_OF_INTEREST)),
        jax_decode_cfg(jcfg),
        evaluator_factory=factory("jax", JaxRunner(), jcfg), **common)
    tdrv = meta_eval.MetaTestDriver(
        env["tmodel"], td, env["mapper"], _eval_grid(tcfg), _decode_cfg(tcfg),
        evaluator_factory=factory("port", MetaFCOSRunner("cpu"), tcfg),
        class_batch=3, device="cpu", **common)
    return jdrv, tdrv, made


def match_results(got, want):
    """Each JAX detection has one of the port's: equal image and category,
    box within 0.05, score within 1e-3."""
    def key(r):
        return (r["image_id"], r["category_id"], -r["score"])

    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                     w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=0.05)
        assert abs(g["score"] - w["score"]) <= 1e-3


def test_run_once_matches_jax(env):
    jdrv, tdrv, made = drivers(env, "coco_meta_val_all", use_base=True)
    want = jdrv.run_once(0)["bbox"]
    got = tdrv.run_once(0)["bbox"]
    match_results(made["port"][0]._results, made["jax"][0]._results)
    assert_results_close(got, want)
    assert {"AP", "AP50", "nAP", "bAP", "AP-cat1", "AR@100"} <= set(got)
    st = tdrv.stats
    assert st["classes"] == 6 and st["query_images"] == 10
    assert st["query_batches"] == 3 and st["total_s"] > 0
    assert tdrv.bank["cls_conv"].shape == (6, 256)


def test_run_repeated_matches_jax(env):
    jdrv, tdrv, made = drivers(env, "coco_meta_val_novel", use_base=False)
    want, got = jdrv.run_repeated(2), tdrv.run_repeated(2)
    for i in range(2):
        match_results(made["port"][i]._results, made["jax"][i]._results)
        assert_results_close(got["runs"][i], want["runs"][i])
    assert_results_close(got["bbox"], want["bbox"])
    for k in ("AP", "AP50"):
        vals = [r[k] for r in got["runs"]]
        assert got["bbox"][k] == pytest.approx(float(np.nanmean(vals)))
        assert got["bbox"][f"{k}_std"] == pytest.approx(
            float(np.nanstd(vals)))
