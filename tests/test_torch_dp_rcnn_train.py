"""The two-stage episodic step, data-parallel over 2 gloo ranks on the CPU.

The JAX step (``_sgd_step_factory`` over the ``do_train`` loss) runs on a
mesh of 2 devices, one episode per device, and the port's one process with
``TPU.GRAD_ACCUM = 2`` replays its sampling keys by micro-group
(``torch_port_util.run_rcnn_steps``); every draw it takes is recorded by
(iteration, global group). Each of the port's 2 ranks then takes its
``shard_batch`` slice with GRAD_ACCUM 1 and replays the same draws by its
global group index, the rank: two steps from the same weights.

Per-step losses within rtol 1e-4 of JAX's and rtol 1e-5 of the one
process's, trainable parameters within JAX's step tolerance and atol 1e-6
of the one process's, bit-identical across the ranks. This file imports
nothing of JAX at module level: every rank imports it.
"""

import copy

import numpy as np
import pytest
import torch

from sylph_tpu_torch.data.loader import batch_to_device
from sylph_tpu_torch.meta_faster_rcnn_runner import (
    MetaFasterRCNNRunner, build_rcnn_model_from_cfg)
from sylph_tpu_torch.parallel import shard_batch
from sylph_tpu_torch.train import optimizer as topt
from sylph_tpu_torch.train.train_state import TrainState


class Replay:
    """A draw source that hands back what a recorded one drew for
    (iteration, group)."""

    def __init__(self, table, it, g):
        self.table, self.key = table, (it, g)

    def rpn(self, b, k):
        return self.table[self.key + ("rpn", b, k)]

    def roi(self, b, n):
        return self.table[self.key + ("roi", b, n)]


class Recording(Replay):
    def __init__(self, source, table, it, g):
        super().__init__(table, it, g)
        self.source = source

    def rpn(self, b, k):
        out = self.source.rpn(b, k)
        self.table[self.key + ("rpn", b, k)] = out
        return out

    def roi(self, b, n):
        out = self.source.roi(b, n)
        self.table[self.key + ("roi", b, n)] = out
        return out


def rank_steps(group, out, cfg, start, kw, batch, table, n):
    """``n`` steps on this rank's slice of ``batch``, draws replayed by the
    global group index."""
    model = build_rcnn_model_from_cfg(cfg, device="cpu")
    model.load_state_dict(start)
    tx, _ = topt.build_optimizer(model, **kw)
    state = TrainState(model, tx)
    runner = MetaFasterRCNNRunner(
        draws=lambda it, g, m: Replay(table, it, g), group=group)
    step = runner.make_train_step(cfg, model)
    mine = batch_to_device(shard_batch(batch, group), "cpu")
    losses = [{k: float(v) for k, v in step(state, mine)[1].items()}
              for _ in range(n)]
    return {"losses": losses, "trainable": sorted(state.tx.names),
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch_port_util as tpu
    pair = tpu.rcnn_pair(episodic=True, seed=6)
    table = {}
    jax_draws = tpu.jax_draws

    def recording(mesh_size):
        base = jax_draws(mesh_size)
        return lambda it, g, m: Recording(base(it, g, m), table, it, g)

    batch = tpu.rcnn_train_batch(True, seed=1)
    tpu.jax_draws = recording
    try:
        one = tpu.run_rcnn_steps(pair, True, batch, grad_accum=2)
    finally:
        tpu.jax_draws = jax_draws
    cfg = tpu.rcnn_train_cfg(pair[3])
    cfg.TPU.GRAD_ACCUM = 1
    ranks = tpu.spawn_ranks(
        __file__, "rank_steps", tmp_path_factory.mktemp("dp_rcnn"), cfg=cfg,
        start=pair[4].state_dict(),
        kw=tpu.opt_kw(pair[0], tpu.freeze_with(pair[0])), batch=batch,
        table=table, n=len(one[0]))
    return pair, one, ranks


def test_dp_rcnn_episodic_steps_match_jax_mesh(runs):
    from torch_port_util import check_run
    pair, (losses, want, model, tst), ranks = runs
    r0 = ranks[0]
    dp_model = copy.deepcopy(model)
    dp_model.load_state_dict(r0["params"], strict=False)
    dp = ([(jm, tm) for (jm, _), tm in zip(losses, r0["losses"])], want,
          dp_model, tst)
    trainable = check_run(dp, pair[4])
    assert trainable == set(r0["trainable"])
    assert not any(n.startswith(("backbone.", "fpn.")) for n in trainable)
    assert sorted(r0["losses"][0]) == ["loss_box_reg", "loss_cls",
                                       "loss_rpn_cls", "loss_rpn_loc"]


def test_dp_rcnn_equals_one_process_and_ranks_agree(runs):
    _, (losses, _, model, _), (r0, r1) = runs
    assert r0["losses"] == r1["losses"]
    for (_, om), tm in zip(losses, r0["losses"]):
        for k in om:
            np.testing.assert_allclose(tm[k], om[k], rtol=1e-5, err_msg=k)
    one = dict(model.named_parameters())
    for n, p in r0["params"].items():
        np.testing.assert_allclose(p.numpy(), one[n].detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)
        assert torch.equal(p, r1["params"][n]), n
