"""``MetaFasterRCNNRunner.do_train`` of the port against the JAX runner's,
plain two-stage pretraining: 2 iterations on coco_pretrain_train_all of a
tiny synthetic COCO tree (6 classes) from the same weights (tiny R-18,
fp32, the linear classifier, the backbone trainable but for FrozenBN). The
JAX runner runs on its 8-device test mesh; the port emulates the ranks
with ``TPU.GRAD_ACCUM = 8`` and replays JAX's keys. Losses rtol 1e-3,
parameters atol 1e-4, frozen ones bit-identical (``check_against_jax``).
"""

import copy

import pytest

from sylph_tpu.runner.meta_faster_rcnn_runner import \
    MetaFasterRCNNRunner as JaxRunner
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner

from test_torch_rcnn_do_train import (check_against_jax, do_train_cfg,
                                      jax_do_train)
from torch_port_util import (few_torch_threads,  # noqa: F401
                             jax_draws, rcnn_pair, register_both)


def plain_cfgs(pair_, **overrides):
    """Both packages' do_train configs on coco_pretrain_train_all."""
    out = []
    for cfg in (pair_[0], pair_[3]):
        cfg = do_train_cfg(cfg)
        cfg.DATASETS.TRAIN = ["coco_pretrain_train_all"]
        cfg.merge_from_other(overrides)
        out.append(cfg)
    out[1].TPU.GRAD_ACCUM = 8  # the 8 ranks of the JAX mesh
    return out


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    register_both(root)


def train_both(pair_, jax_runner, runner, monkeypatch, **overrides):
    jcfg, tcfg = plain_cfgs(pair_, **overrides)
    jax_losses, want = jax_do_train(jax_runner, jcfg, pair_[1], pair_[2],
                                    monkeypatch)
    model = copy.deepcopy(pair_[4])
    start = {k: v.clone() for k, v in model.named_parameters()}
    _, tstate = runner.do_train(tcfg, model)
    return check_against_jax(runner, tstate, model, start, jax_losses, want)


def test_pretrain_do_train_matches_jax_runner(coco, monkeypatch):
    pair_ = rcnn_pair(episodic=False, seed=9)
    trainable = train_both(pair_, JaxRunner(), MetaFasterRCNNRunner(
        device="cpu", draws=jax_draws(8)), monkeypatch)
    for prefix in ("backbone.", "rpn_head.", "box_head.cls_score."):
        assert any(n.startswith(prefix) for n in trainable), prefix
