"""``MetaFasterRCNNRunner.do_train`` of the port against the JAX runner's,
episodic meta-training: 2 iterations on a tiny synthetic LVIS tree
(lvis_meta_train_basefc) from the same weights (tiny R-18, fp32, backbone
frozen). The JAX runner runs on its 8-device test mesh, one episode per
device; the port emulates those ranks with ``TPU.GRAD_ACCUM = 8`` and
replays JAX's keys for its sampling. Per-iteration losses within rtol
1e-3, trained parameters within atol 1e-4, frozen ones bit-identical.
Then a checkpoint: saved, restored into a fresh model and stepped once, it
equals the same step taken without the interruption.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from sylph_tpu.runner import meta_fcos_runner as jfcos_runner
from sylph_tpu.runner.meta_faster_rcnn_runner import \
    MetaFasterRCNNRunner as JaxRunner
from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
from sylph_tpu_torch.train.checkpoint import CheckpointManager
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from test_torch_rcnn_meta_test import register_lvis_both
from torch_port_util import (few_torch_threads,  # noqa: F401
                             jax_draws, rcnn_pair, rcnn_train_cfg)


def do_train_cfg(cfg, iters=2):
    cfg = rcnn_train_cfg(cfg)
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    return cfg


def jax_do_train(runner, jcfg, jmodel, params, monkeypatch):
    """The JAX runner's ``do_train``; -> (losses per iteration, its trained
    parameters as a port state_dict)."""
    assert jax.device_count() == 8
    losses = []
    write = jfcos_runner.MetricsWriter.write

    def record(self, step, metrics, lr=None):
        losses.append(dict(metrics))
        return write(self, step, metrics, lr)

    monkeypatch.setattr(jfcos_runner.MetricsWriter, "write", record)
    _, state = runner.do_train(jcfg, jmodel, params)
    s = state.unpack() if hasattr(state, "unpack") else state
    return losses, state_dict_from_jax(jax.tree.map(np.asarray, s.params))


def check_against_jax(runner, tstate, model, start, jax_losses, want):
    """Per-iteration losses rtol 1e-3, trained parameters atol 1e-4, frozen
    ones bit-identical; -> the trainable names."""
    assert tstate.step == len(jax_losses) == len(runner.train_metrics)
    for it, (tm, jm) in enumerate(zip(runner.train_metrics, jax_losses)):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert np.isfinite(tm[k])
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3,
                                       err_msg=f"iter {it} {k}")
    trainable = set(tstate.tx.names)
    moved = 0
    for n, p in model.named_parameters():
        if n in trainable:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=n)
            moved += int(not torch.equal(p, start[n]))
        else:
            assert torch.equal(p, start[n]) and torch.equal(want[n],
                                                            start[n]), n
    assert moved > 0 and len(runner.loop_times) == tstate.step
    return trainable


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    register_lvis_both(tmp_path_factory.mktemp("lvis"))
    return rcnn_pair(episodic=True, seed=8)


def test_episodic_do_train_matches_jax_runner(env, monkeypatch):
    jcfg, jmodel, params, tcfg, tmodel = env
    jax_losses, want = jax_do_train(JaxRunner(), do_train_cfg(jcfg), jmodel,
                                    params, monkeypatch)
    cfg = do_train_cfg(tcfg)
    cfg.TPU.GRAD_ACCUM = 8  # the 8 ranks of the JAX mesh
    model = copy.deepcopy(tmodel)
    start = {k: v.clone() for k, v in model.named_parameters()}
    runner = MetaFasterRCNNRunner(device="cpu", draws=jax_draws(8))
    _, tstate = runner.do_train(cfg, model)
    trainable = check_against_jax(runner, tstate, model, start, jax_losses,
                                  want)
    assert any(n.startswith("code_generator.") for n in trainable)
    assert not any(n.startswith("backbone.") for n in trainable)


def test_checkpoint_resume_equals_the_uninterrupted_step(env, tmp_path):
    """One step, a checkpoint, then the next step twice: from the live state
    and from a fresh model restored from the checkpoint (the default draws,
    which depend on the iteration alone)."""
    cfg = do_train_cfg(env[3], iters=1)
    cfg.TPU.GRAD_ACCUM = 2
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    runner = MetaFasterRCNNRunner(device="cpu")
    model = copy.deepcopy(env[4])
    _, state = runner.do_train(cfg, model)
    ckpt = CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    assert state.step == 1 and ckpt.latest_step() == 1
    loader = runner._episodic_loader(cfg)
    batch = next(loader)
    loader.close()
    live = runner.make_train_step(cfg, model)(state, batch)[1]

    fresh = copy.deepcopy(env[4])
    resumed, _, _ = runner._common_train_setup(cfg, fresh)
    assert resumed.step == 1
    again = runner.make_train_step(cfg, fresh)(resumed, batch)[1]
    assert resumed.step == state.step == 2
    for k in live:
        assert float(again[k]) == float(live[k]), k
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.tx.trace, resumed.tx.trace):
        assert torch.equal(a, b)
