"""The port's two-stage train steps (``MetaFasterRCNNRunner.
make_train_step``) against the JAX runner's (``_sgd_step_factory`` over
the ``do_train`` loss), from the same weights, on the same batch, with the
same draws (JAX's keys replayed), in float32 on the CPU:

  * episodic meta-training (backbone frozen), 2 steps;
  * the same with GRAD_ACCUM = 2 against a JAX mesh of 2 devices (one
    episode per rank, the rank folded into the key).

Per-step losses within rtol 1e-4, trainable parameters within atol 1e-5
(rtol 1e-4), frozen ones bit-identical in both packages. The plain steps
are in test_torch_rcnn_train_plain.py.
"""

import pytest

from torch_port_util import (check_run, few_torch_threads,  # noqa: F401
                             rcnn_pair, rcnn_train_batch, run_rcnn_steps)


@pytest.fixture(scope="module")
def pair():
    return rcnn_pair(episodic=True, seed=6)


def check_episodic(pair_, result):
    trainable = check_run(result, pair_[4])
    assert not any(n.startswith(("backbone.", "fpn.")) for n in trainable)
    for prefix in ("code_generator.", "rpn_head.", "box_head.fc1"):
        assert any(n.startswith(prefix) for n in trainable), prefix
    for jm, tm in result[0]:
        assert sorted(tm) == ["loss_box_reg", "loss_cls", "loss_rpn_cls",
                              "loss_rpn_loc"]


def test_episodic_steps_match_jax(pair):
    check_episodic(pair, run_rcnn_steps(pair, True, rcnn_train_batch(True)))


def test_episodic_grad_accum_matches_a_two_device_mesh(pair):
    check_episodic(pair, run_rcnn_steps(pair, True,
                                        rcnn_train_batch(True, seed=1),
                                        grad_accum=2))
