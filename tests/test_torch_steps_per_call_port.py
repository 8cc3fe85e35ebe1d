"""``TPU.STEPS_PER_CALL`` = 2 in the port on its own, on the CPU with tiny
R-18 models from the port's seeded init (the K-step calls against JAX's
scanned steps are in tests/test_torch_steps_per_call.py):

  * for each of the four step builders, one call of two steps against two
    calls of one: parameters, EMA, momentum, the step count and the
    per-step losses equal bit for bit (``torch.equal``). Each inner step
    must see its own iteration: it seeds the episodic dropout and the
    two-stage sampling draws (``SampleDraws``), so a call that reused one
    iteration's draws would sample other anchors and ROIs in its second
    step;
  * ``do_train``: ``MAX_ITER`` 4 writes iterations 1-4 and a checkpoint at
    4 (JAX's ``test_episodic_train_steps_per_call``); ``MAX_ITER`` 5 stops
    at 4 with the JAX runner's message and a checkpoint there.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from sylph_tpu_torch import build_model_from_cfg, get_default_cfg
from sylph_tpu_torch.data import catalog
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
from sylph_tpu_torch.runner import MetaFCOSRunner
from sylph_tpu_torch.train import optimizer as topt
from sylph_tpu_torch.train import steps as tsteps
from sylph_tpu_torch.train.checkpoint import CheckpointManager
from sylph_tpu_torch.train.train_state import TrainState

from torch_port_util import (CANVAS, episodic_batch,
                             few_torch_threads,  # noqa: F401
                             pretrain_batch, rcnn_train_batch,
                             rcnn_train_cfg, shrink_meta_cfg,
                             shrink_rcnn_cfg, torch_batch)

K = 2


def _run_calls(make_step, model, batches, k, kw):
    """Train a copy of ``model`` over ``batches`` in calls of ``k`` steps;
    -> (its state_dict, optimizer state, stacked losses)."""
    model = copy.deepcopy(model)
    tx, _ = topt.build_optimizer(model, **kw)
    state = TrainState(model, tx, use_ema=True, ema_decay=0.9)
    step = make_step(model, k)
    rows = []
    for i in range(0, len(batches), k):
        group = batches[i:i + k]
        batch = group[0] if k == 1 else tsteps.stack_batches(group)
        state, m = step(state, batch)
        rows.append({n: v.reshape(-1) for n, v in m.items()})
    losses = {n: torch.cat([r[n] for r in rows]) for n in rows[0]}
    return state.state_dict(), losses


def _assert_same_bits(a, b):
    (sa, la), (sb, lb) = a, b
    assert sa["step"] == sb["step"] == 2
    for part in ("model", "ema"):
        for n, v in sa[part].items():
            assert torch.equal(v, sb[part][n]), (part, n)
    assert sa["tx"]["count"] == sb["tx"]["count"] == 2
    for n, v in sa["tx"]["trace"].items():
        assert torch.equal(v, sb["tx"]["trace"][n]), n
    assert sorted(la) == sorted(lb)
    for n in la:
        assert torch.equal(la[n], lb[n]), n


@pytest.mark.parametrize("episodic", [False, True])
def test_one_stage_k_call_equals_k_single_calls(episodic):
    tcfg = shrink_meta_cfg(get_default_cfg(), episodic)
    tcfg.TPU.TRAIN_CANVAS = list(CANVAS)
    tmodel = build_model_from_cfg(tcfg, device="cpu", init="train")
    kw = dict(base_lr=0.02, warmup_iters=0, clip_grad_norm=1.0,
              freeze_cfg={} if episodic else {"backbone": False,
                                              "episodic": False})
    src = episodic_batch if episodic else pretrain_batch
    batches = [torch_batch(src(s)) for s in (5, 6)]

    def make(model, k):
        cfg = tcfg.clone()
        cfg.TPU.STEPS_PER_CALL = k
        return MetaFCOSRunner(device="cpu").make_train_step(cfg, model)

    _assert_same_bits(_run_calls(make, tmodel, batches, K, kw),
                      _run_calls(make, tmodel, batches, 1, kw))


@pytest.mark.parametrize("episodic", [False, True])
def test_two_stage_k_call_equals_k_single_calls(episodic):
    """The port's seeded weights and its own draws (``SampleDraws`` by
    iteration): a K-step call that reused one iteration's draws would sample
    other anchors and ROIs in its second step."""
    runner = MetaFasterRCNNRunner(device="cpu")
    tcfg = rcnn_train_cfg(shrink_rcnn_cfg(runner.get_default_cfg(),
                                          episodic))
    tmodel = runner.build_model(tcfg)
    kw = dict(base_lr=0.01, warmup_iters=0, clip_grad_norm=1.0,
              freeze_cfg={"backbone": True})
    batches = [torch_batch(rcnn_train_batch(episodic, seed=s))
               for s in (1, 2)]

    def make(model, k):
        cfg = tcfg.clone()
        cfg.TPU.STEPS_PER_CALL = k
        return MetaFasterRCNNRunner(device="cpu").make_train_step(cfg, model)

    _assert_same_bits(_run_calls(make, tmodel, batches, K, kw),
                      _run_calls(make, tmodel, batches, 1, kw))


# ------------------------------------------------------------ do_train
@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    catalog.DatasetCatalog.clear()
    catalog.MetadataCatalog.clear()
    catalog.register_all_coco(root)
    return root


def _do_train(coco, out_dir, max_iter, period):
    cfg = shrink_meta_cfg(get_default_cfg())
    cfg.DATASETS.TRAIN = ["coco_meta_train_base"]
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.CHECKPOINT_PERIOD = period
    cfg.TPU.TRAIN_CANVAS = [96, 96]
    cfg.TPU.STEPS_PER_CALL = K
    cfg.INPUT.MIN_SIZE_TRAIN = [80]
    cfg.OUTPUT_DIR = out_dir
    runner = MetaFCOSRunner(device="cpu")
    _, state = runner.do_train(cfg)
    with open(os.path.join(out_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    return runner, state, rows


def test_do_train_two_steps_a_call(coco, tmp_path):
    out = str(tmp_path / "out")
    runner, state, rows = _do_train(coco, out, 4, period=4)
    assert state.step == 4
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss_fcos_cls"]) for r in rows)
    assert len(runner.loop_times) == 2 and len(runner.train_metrics) == 4
    assert CheckpointManager(os.path.join(out, "ckpt")).latest_step() == 4


def test_do_train_stops_at_the_last_whole_call(coco, tmp_path, capsys):
    out = str(tmp_path / "out")
    # no periodic save falls on 4: the stop saves it
    _, state, rows = _do_train(coco, out, 5, period=100)
    assert state.step == 4
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4]
    assert ("[train] stopping at iter 4: MAX_ITER 5 is not a multiple of "
            "TPU.STEPS_PER_CALL=2") in capsys.readouterr().out
    assert CheckpointManager(os.path.join(out, "ckpt")).latest_step() == 4
