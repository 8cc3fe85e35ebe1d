"""``MetaFCOSRunner.do_train`` of the port against the JAX runner's.

Episodic meta-training, 3 iterations on a tiny synthetic COCO tree from
the same weights (tiny R-18, fp32, device RandAugment): the JAX runner
runs on its 8-device test mesh (one episode per device); the port emulates
those 8 ranks on one device with ``TPU.GRAD_ACCUM = 8``. Per-iteration
losses must agree within rtol 1e-3 and the trained parameters within
atol 1e-4 (frozen ones bit-identical). Pretraining through ``do_train``
is in tests/test_torch_train_pretrain.py; MODEL.WEIGHTS, the train init
and the CLI's world scaling in tests/test_torch_train_setup.py.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from sylph_tpu.runner import meta_fcos_runner as jrunner
from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (few_torch_threads,  # noqa: F401
                             register_both, tiny_model_pair)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    register_both(root)
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=5)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, tcfg=tcfg,
                tmodel=tmodel)


def _train_cfg(cfg):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.DATASETS.TRAIN = ["coco_meta_train_base"]
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.MAX_ITER = 3
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    cfg.TPU.TRAIN_CANVAS = [96, 96]
    cfg.INPUT.MIN_SIZE_TRAIN = [80]
    return cfg


def test_episodic_do_train_matches_jax_runner(env, monkeypatch):
    jcfg = _train_cfg(env["jcfg"])
    assert jax.device_count() == 8
    jax_losses = []
    write = jrunner.MetricsWriter.write

    def record(self, step, metrics, lr=None):
        jax_losses.append(dict(metrics))
        return write(self, step, metrics, lr)

    monkeypatch.setattr(jrunner.MetricsWriter, "write", record)
    jrun = jrunner.MetaFCOSRunner()
    _, jstate = jrun.do_train(jcfg, env["jmodel"], env["params"])

    tcfg = _train_cfg(env["tcfg"])
    tcfg.TPU.GRAD_ACCUM = 8  # the 8 ranks of the JAX mesh
    model = copy.deepcopy(env["tmodel"])
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trun = trunner.MetaFCOSRunner(device="cpu")
    _, tstate = trun.do_train(tcfg, model)

    assert tstate.step == 3 and len(trun.train_metrics) == 3
    assert len(jax_losses) == 3
    for it, (tm, jm) in enumerate(zip(trun.train_metrics, jax_losses)):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3,
                                       err_msg=f"iter {it} {k}")
    js = jstate.unpack() if hasattr(jstate, "unpack") else jstate
    want = state_dict_from_jax(jax.tree.map(np.asarray, js.params))
    trainable = set(tstate.tx.names)
    for n, p in model.named_parameters():
        if n in trainable:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=n)
        else:
            assert torch.equal(p, start[n]) and torch.equal(want[n],
                                                            start[n]), n
    assert len(trun.loop_times) == 3
