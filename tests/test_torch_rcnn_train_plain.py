"""The port's plain two-stage training (pretraining: the linear box-head
classifier, every layer but FrozenBN trainable) against the JAX package's,
in float32 on the CPU with JAX's draws replayed: the loss dict of
``forward_pretrain_train`` within rtol 1e-4, then 2 steps of
``make_train_step`` against JAX's ``_sgd_step_factory`` (losses rtol 1e-4,
parameters atol 1e-5, frozen ones bit-identical).
"""

import pytest

from test_torch_rcnn_train import LOSSES, check_losses, forward_both
from torch_port_util import (check_run, few_torch_threads,  # noqa: F401
                             rcnn_pair, rcnn_train_batch, run_rcnn_steps)


@pytest.fixture(scope="module")
def pair():
    return rcnn_pair(episodic=False, seed=5)


def test_forward_pretrain_train_matches_jax(pair):
    want, got = forward_both(pair, False)
    check_losses(want, got, LOSSES)


def test_pretrain_steps_match_jax(pair):
    result = run_rcnn_steps(pair, False, rcnn_train_batch(False, seed=2))
    trainable = check_run(result, pair[4])
    for prefix in ("backbone.", "fpn.", "rpn_head.", "box_head.cls_score"):
        assert any(n.startswith(prefix) for n in trainable), prefix
