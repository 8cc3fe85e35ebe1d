"""The port's TFA-RCNN finetune step against the JAX package's, in float32
on the CPU with JAX's draws replayed: the cosine box-head classifier's
``forward_pretrain_train`` loss dict within rtol 1e-4, then 2 plain steps
with the backbone, the proposal generator and the box head's FC layers
frozen (MODEL.BACKBONE.FREEZE, PROPOSAL_GENERATOR.FREEZE,
ROI_HEADS.FREEZE_FEAT): losses rtol 1e-4, the cosine rows, scale and
``bbox_pred`` within atol 1e-5 of JAX's, everything else bit-identical.
"""

import pytest

from test_torch_rcnn_train import LOSSES, check_losses, forward_both
from torch_port_util import (check_run, few_torch_threads,  # noqa: F401
                             rcnn_pair, rcnn_train_batch, run_rcnn_steps)


@pytest.fixture(scope="module")
def pair():
    return rcnn_pair(episodic=False, cosine=True, seed=7)


def test_forward_cosine_head_matches_jax(pair):
    want, got = forward_both(pair, False, seed=1)
    check_losses(want, got, LOSSES)


def test_tfa_steps_match_jax(pair):
    result = run_rcnn_steps(
        pair, False, rcnn_train_batch(False, seed=3),
        freeze_kw=dict(backbone=True, proposal_generator=True,
                       roi_heads_feat=True))
    trainable = check_run(result, pair[4])
    assert trainable == {"box_head.cosine_weight",
                         "box_head.cosine_scale_param",
                         "box_head.bbox_pred.weight",
                         "box_head.bbox_pred.bias"}
