"""Loading and launching, against the JAX package (CPU):

  * ``SylphPredictor(weight_path=...)`` builds through the runner as JAX's
    does: a flat ``.npz`` written from a JAX param tree loads into the
    port's model exactly, and both predictors register the same classes
    and detect alike (test_torch_serving's criterion); a config naming
    MODEL.WEIGHTS loads the same weights;
  * ``setup_after_launch`` writes ``config.yaml`` and ``config_diff.yaml``
    equal to JAX's, key for key, for a two-stage config, and ``env.txt``;
  * ``train_net`` under SYLPH_TEST_MODE with the LVIS Meta-RCNN finetune
    config writes the synthetic LVIS tree and the launch files, and its
    ``do_train`` gets its first episodic batch from the LVIS dataset.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from sylph_tpu.predictor import SylphPredictor as JaxPredictor
from sylph_tpu.runner.meta_faster_rcnn_runner import \
    MetaFasterRCNNRunner as JaxRunner
from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
from sylph_tpu_torch.predictor import SylphPredictor
from sylph_tpu_torch.tools import train_net
from sylph_tpu_torch.utils.setup import setup_after_launch

from test_torch_serving import assert_detections_match
from torch_port_util import (few_torch_threads,  # noqa: F401
                             flat_paths, tiny_model_pair)

FINETUNE = "sylph://LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-finetune.yaml"


def test_predictor_weight_path_npz_matches_jax(tmp_path):
    jcfg, _, params, tcfg, tmodel = tiny_model_pair(seed=3)
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **flat_paths(params))
    jpred = JaxPredictor(cfg=jcfg.clone(), weight_path=npz, max_classes=8)
    tpred = SylphPredictor(cfg=tcfg.clone(), weight_path=npz, max_classes=8,
                           device="cpu")
    assert tpred.cfg.MODEL.WEIGHTS == npz
    want_sd = tmodel.state_dict()
    for k, v in tpred.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k

    rng = np.random.RandomState(4)
    for name in ("widget", "gadget"):
        imgs = [rng.randint(0, 255, (120, 110, 3), np.uint8) for _ in range(2)]
        bxs = [np.array([8, 10, 90, 100], np.float32),
               np.array([20, 6, 100, 80], np.float32)]
        assert jpred.register_class(name, imgs, bxs) == \
            tpred.register_class(name, imgs, bxs)
    image = rng.randint(0, 255, (100, 150, 3), np.uint8)
    want, got = jpred(image), tpred(image)
    assert got["class_names"] == want["class_names"]
    assert_detections_match(
        dict(got, valid=np.ones(len(got["scores"]), bool)),
        dict(want, valid=np.ones(len(want["scores"]), bool)))

    cfg = tcfg.clone()
    cfg.MODEL.WEIGHTS = npz
    named = SylphPredictor(cfg=cfg, max_classes=8, device="cpu")
    for k, v in named.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    with pytest.raises(ValueError, match="not both"):
        SylphPredictor(cfg=tcfg.clone(), model=tmodel, weight_path=npz,
                       device="cpu")


@pytest.mark.parametrize("config", ["finetune", "pretrain"])
def test_config_dumps_equal_jax(tmp_path, config):
    from sylph_tpu.utils.setup import setup_after_launch as jax_setup

    path = FINETUNE.replace("finetune", config)
    cfgs = []
    for runner in (JaxRunner, MetaFasterRCNNRunner):
        cfg = runner.get_default_cfg()
        cfg.merge_from_file(path)
        cfg.SOLVER.MAX_ITER = 7
        cfg.OUTPUT_DIR = "out"
        cfgs.append(cfg.freeze())
    jax_setup(cfgs[0], str(tmp_path / "jax"),
              default_cfg=JaxRunner.get_default_cfg())
    setup_after_launch(cfgs[1], str(tmp_path / "port"),
                       default_cfg=MetaFasterRCNNRunner.get_default_cfg())
    for name in ("config.yaml", "config_diff.yaml"):
        with open(tmp_path / "jax" / name) as f:
            want = yaml.safe_load(f)
        with open(tmp_path / "port" / name) as f:
            got = yaml.safe_load(f)
        assert got == want, name
    assert got["SOLVER"]["MAX_ITER"] == 7 and "RESNETS" not in got["MODEL"]
    with open(tmp_path / "port" / "env.txt") as f:
        env = f.read()
    assert "torch:" in env and "devices:" in env and "jax" not in env


class _FirstBatch(Exception):
    pass


def test_test_mode_lvis_finetune_writes_the_tree_and_loads(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("SYLPH_TEST_MODE", "1")
    seen = {}

    def first_step(self, cfg, model):
        def step(state, batch):
            seen["batch"] = batch
            raise _FirstBatch
        return step

    monkeypatch.setattr(MetaFasterRCNNRunner, "make_train_step", first_step)
    lvis, coco, out = (str(tmp_path / d) for d in ("lvis", "coco", "out"))
    with pytest.raises(_FirstBatch):
        train_net.main(["--runner", "MetaFasterRCNNRunner",
                        "--config-file", FINETUNE, "--device", "cpu",
                        "--datasets-root", coco, "--lvis-root", lvis,
                        "--output-dir", out])
    for f in ("lvis_v1_train.json", "lvis_v1_val.json"):
        assert os.path.exists(os.path.join(lvis, f)), f
    for f in ("config.yaml", "config_diff.yaml", "env.txt"):
        assert os.path.exists(os.path.join(out, f)), f
    batch = seen["batch"]
    assert tuple(batch["query_images"].shape) == (2, 1024, 1024, 3)
    assert tuple(batch["support_images"].shape) == (4, 384, 384, 3)
    assert bool(batch["query_gt_valid"].any())
