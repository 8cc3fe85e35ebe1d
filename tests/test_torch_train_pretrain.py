"""Pretraining in the port against the JAX package, in float32 on the CPU
with a tiny R-18 (one-conv towers):

  * the pretrain step, three steps on one fixed batch (device RandAugment
    included) against JAX on ``create_mesh(1)``: losses within rtol 1e-4,
    parameters within atol 1e-5 + rtol 1e-4, frozen parameters
    bit-identical (the FrozenBN note of tests/test_torch_train.py holds
    here too);
  * ``do_train`` in pretraining mode on a tiny synthetic COCO tree, with
    ``TPU.GRAD_ACCUM = 2``: ``metrics.json``, checkpoints, and a resume
    that takes one more step from the saved one.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.train.checkpoint import CheckpointManager

from torch_port_util import (check_run, few_torch_threads,  # noqa: F401
                             pretrain_batch, register_both, run_steps,
                             tiny_model_pair)


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(episodic=False, seed=4)


def test_pretrain_steps_match_jax(pair):
    result = run_steps(pair, False, pretrain_batch(0),
                       freeze_kw=dict(backbone=False, episodic=False))
    trainable = check_run(result, pair[4])
    # Base-FCOS trains iou_overlap, which gets no gradient (BOX_QUALITY
    # ["ctrness"]) yet decays; the backbone trains
    assert "fcos_head.iou_overlap.weight" in trainable
    assert "backbone.res2_block0.conv1.weight" in trainable


def test_pretrain_do_train_checkpoints_and_resumes(pair, tmp_path):
    root = str(tmp_path / "coco")
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    register_both(root)
    cfg = pair[3].clone()
    cfg.defrost()
    cfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    cfg.TPU.TRAIN_CANVAS = [96, 96]
    cfg.TPU.GRAD_ACCUM = 2
    cfg.INPUT.MIN_SIZE_TRAIN = [80]
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    runner = trunner.MetaFCOSRunner(device="cpu")
    model = copy.deepcopy(pair[4])
    _, state = runner.do_train(cfg, model)
    assert state.step == 2
    ckpt = CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    assert ckpt.latest_step() == 2
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss_fcos_cls"]) for r in rows)
    after2 = {k: v.clone() for k, v in model.state_dict().items()}

    cfg.SOLVER.MAX_ITER = 3  # resume from step 2 for one more step
    resumed = copy.deepcopy(pair[4])
    _, state = runner.do_train(cfg, resumed)
    assert state.step == 3 and len(runner.train_metrics) == 1
    assert ckpt.latest_step() == 3
    moved = [k for k, v in resumed.state_dict().items()
             if not torch.equal(v, after2[k])]
    assert moved and all(k in state.tx.names for k in moved)
