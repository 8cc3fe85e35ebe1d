"""Rank-sharded phase-1 registration and the sharded meta-test, over 2 gloo
ranks on the CPU, against the JAX package on a 2-device mesh.

The tiny R-18 pair and synthetic tree of ``make_meta_env``, on
coco_meta_val_all (6 classes). Each rank registers its share of the
classes (``build_support_set_loader(rank=, world_size=)``), 2 per call, its
tail call padded, and all-gathers the code rows:

  * ``generate_class_codes_sharded`` equals JAX's
    ``generate_class_codes_sharded`` on a 2-device mesh and the port's one
    process within 1e-5, the same dict on both ranks; rank 0 alone writes
    the ``.npz`` files;
  * ``MetaTestDriver(mesh=group).run_once`` gives JAX's AP dict (its driver
    on a 2-device mesh) within 1e-4 on both ranks, every rank scoring the
    whole query set.

This file imports nothing of JAX at module level: every rank imports it.
"""

import os

import numpy as np
import pytest

from sylph_tpu_torch.data.catalog import (DatasetCatalog, MetadataCatalog,
                                          register_all_coco)
from sylph_tpu_torch.data.loader import build_support_set_loader
from sylph_tpu_torch.data.meta_dataset import MetaDataset
from sylph_tpu_torch.evaluation import meta_eval
from sylph_tpu_torch.runner import (MetaFCOSRunner, _decode_cfg, _eval_grid,
                                    _mapper, build_model_from_cfg)

NAME = "coco_meta_val_all"
COMMON = dict(eval_shot=2, eval_batch=4)


def _codes(codes):
    return {c: {k: np.asarray(v) for k, v in d["code"].items()}
            for c, d in codes.items()}


def rank_register(group, out, cfg, start, root):
    DatasetCatalog.clear()
    MetadataCatalog.clear()
    register_all_coco(root)
    np.random.seed(5)  # the split "all" samples novel support from it
    data = DatasetCatalog.get(NAME)
    model = build_model_from_cfg(cfg, device="cpu")
    model.load_state_dict(start)
    sup = MetaDataset(data, "episodic_test_supportset", num_shot=2)
    save = os.path.join(out, f"codes_rank{group.rank}")
    codes = meta_eval.generate_class_codes_sharded(
        model, build_support_set_loader(sup, _mapper(cfg), rank=group.rank,
                                        world_size=group.world),
        group, save_dir=save, class_batch=2, device="cpu")
    runner = MetaFCOSRunner("cpu")
    driver = meta_eval.MetaTestDriver(
        model, data, _mapper(cfg), _eval_grid(cfg), _decode_cfg(cfg),
        evaluator_factory=lambda recs, meta: runner.get_evaluator(
            cfg, NAME, recs, meta),
        class_batch=2, device="cpu", mesh=group, **COMMON)
    res = driver.run_once(0)
    return {"codes": _codes(codes), "names": {c: d["class_name"] for c, d
                                              in codes.items()},
            "files": sorted(os.listdir(save)) if os.path.isdir(save)
            else None, "bbox": res["bbox"], "stats": driver.stats}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from torch_port_util import make_meta_env
    root = str(tmp_path_factory.mktemp("coco"))
    return dict(make_meta_env(root), root=root)


@pytest.fixture(scope="module")
def ranks(env, tmp_path_factory):
    from torch_port_util import spawn_ranks
    return spawn_ranks(__file__, "rank_register",
                       tmp_path_factory.mktemp("dp_register"),
                       cfg=env["tcfg"], start=env["tmodel"].state_dict(),
                       root=env["root"])


def test_sharded_codes_match_jax_mesh_and_one_process(env, ranks):
    from sylph_tpu.data.loader import \
        build_support_set_loader as jax_loader
    from sylph_tpu.data.meta_dataset import MetaDataset as JaxMetaDataset
    from sylph_tpu.evaluation import meta_eval as jax_meta_eval
    from sylph_tpu.parallel.mesh import create_mesh as jax_mesh
    from torch_port_util import datasets_both

    jd, td = datasets_both(NAME)
    want = _codes(jax_meta_eval.generate_class_codes_sharded(
        env["jmodel"], env["params"],
        jax_loader(JaxMetaDataset(jd, "episodic_test_supportset",
                                  num_shot=2), env["jmapper"]),
        jax_mesh(2)))
    one = _codes(meta_eval.generate_class_codes(
        env["tmodel"], build_support_set_loader(
            MetaDataset(td, "episodic_test_supportset", num_shot=2),
            env["mapper"]), class_batch=2, device="cpu"))
    assert len(want) == 6 and sorted(one) == sorted(want)
    r0, r1 = ranks
    for r in ranks:
        assert sorted(r["codes"]) == sorted(want)
        for c, code in want.items():
            for k, v in code.items():
                assert r["codes"][c][k].shape == v.shape == one[c][k].shape
                np.testing.assert_allclose(r["codes"][c][k], v, rtol=0,
                                           atol=1e-5, err_msg=f"{c} {k}")
                np.testing.assert_allclose(r["codes"][c][k], one[c][k],
                                           rtol=0, atol=1e-5)
                np.testing.assert_array_equal(r["codes"][c][k],
                                              r0["codes"][c][k])
    assert r0["names"] == r1["names"]
    assert r0["files"] == sorted(f"{n}.npz" for n in r0["names"].values())
    assert r1["files"] is None
    for r in ranks:
        assert r["stats"]["classes"] == 3 and r["stats"]["gather_s"] >= 0


def test_sharded_meta_test_matches_jax_mesh(env, ranks):
    from sylph_tpu.evaluation import meta_eval as jax_meta_eval
    from sylph_tpu.ops.locations import build_location_grid as jax_grid
    from sylph_tpu.parallel.mesh import create_mesh as jax_mesh
    from sylph_tpu.runner.meta_fcos_runner import \
        MetaFCOSRunner as JaxRunner
    from sylph_tpu.runner.meta_fcos_runner import \
        _decode_cfg as jax_decode_cfg
    from torch_port_util import assert_results_close, datasets_both

    jd, _ = datasets_both(NAME)
    jcfg = env["jcfg"]
    jdrv = jax_meta_eval.MetaTestDriver(
        env["jmodel"], env["params"], jd, env["jmapper"],
        jax_grid(tuple(jcfg.TPU.EVAL_CANVAS),
                 tuple(jcfg.MODEL.FCOS.FPN_STRIDES),
                 list(jcfg.MODEL.FCOS.SIZES_OF_INTEREST)),
        jax_decode_cfg(jcfg),
        evaluator_factory=lambda recs, meta: JaxRunner().get_evaluator(
            jcfg, NAME, recs, meta), mesh=jax_mesh(2), **COMMON)
    want = jdrv.run_once(0)["bbox"]
    for r in ranks:
        assert_results_close(r["bbox"], want)
        assert r["stats"]["query_images"] == 10
    assert {"AP", "nAP", "bAP"} <= set(ranks[0]["bbox"])
