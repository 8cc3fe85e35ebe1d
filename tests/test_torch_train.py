"""The port's optimizer, train state and train steps against the JAX
package's, in float32 on the CPU with a tiny R-18 (one-conv towers).

  * the freeze mask: the same set of trainable flax paths as JAX's
    ``build_freeze_mask`` for the runner's freeze configs, FrozenBN leaves
    aside: JAX's rule keeps only paths containing "_bn" frozen, so the
    bottleneck ``bn1``-``bn3`` of a trainable backbone train there, while
    the port keeps every FrozenBN constant (detectron2's semantics, which
    the JAX docstring states). The JAX side of the step tests therefore
    runs its own optax chain with FrozenBN masked (``jax_tx``);
  * the LR schedule at warmup, plateau and decay counts;
  * three optimizer updates (clip, decay, momentum, masks) against the
    optax chain, gradient-free trainable parameters included, and the EMA;
  * ``TPU.STEPS_PER_CALL`` = 2 takes batches stacked on a leading axis of
    2 and refuses others (the K-step calls against JAX's scanned steps are
    in tests/test_torch_steps_per_call.py).

The train steps against JAX's are in tests/test_torch_train_pretrain.py
and tests/test_torch_train_episodic.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.train import optimizer as jopt
from sylph_tpu.train.train_state import create_train_state as jax_state
from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.train import optimizer as topt
from sylph_tpu_torch.train import steps as tsteps
from sylph_tpu_torch.train.train_state import TrainState
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (CANVAS, PARAM_TOL, flat_paths,
                             few_torch_threads, freeze_with,  # noqa: F401
                             jax_mask, jax_tx, pretrain_batch,
                             tiny_model_pair, torch_batch)


FREEZE_CASES = {
    "finetune": {},
    "pretrain": dict(episodic=False, backbone=False),
    "owd": dict(episodic=False, backbone=False, owd=True),
    "exclude": dict(backbone_exclude=["res5", "fpn/output"]),
    "everything": dict(proposal_generator=True, code_generator=True),
}


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(episodic=True, seed=3)


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_freeze_mask_matches_jax(pair, case):
    jcfg, _, params, _, tmodel = pair
    fcfg = freeze_with(jcfg, **FREEZE_CASES[case])
    jmask = flat_paths(jax_mask(params, fcfg))
    tmask = topt.build_freeze_mask(tmodel, fcfg)
    want = {p for p, m in jmask.items() if m}
    got = {topt.flax_param_path(tmodel, n) for n, m in tmask.items() if m}
    assert got == want
    # every port parameter has a flax counterpart
    assert {topt.flax_param_path(tmodel, n) for n in tmask} <= set(jmask)


def test_lr_schedule_matches_jax():
    kw = dict(base_lr=0.01, steps=(7, 11), gamma=0.1, warmup_iters=5,
              warmup_factor=1e-3)
    js = jopt.build_lr_schedule(**kw)
    ts = topt.build_lr_schedule(**kw)
    for c in range(0, 14):
        assert np.float32(ts(c)) == np.float32(js(c)), c
    z = topt.build_lr_schedule(0.02, (3,), 0.5, 0, 1e-3)
    assert z(0) == np.float32(0.02) and z(3) == np.float32(0.01)


def _leaf_grads(params, rng):
    return jax.tree.map(lambda x: np.asarray(
        rng.randn(*np.shape(x)) * 0.3, np.float32), params)


@pytest.mark.parametrize("clip", [0.0, 1.0, 1e4])
def test_three_optimizer_updates_match_optax(pair, clip):
    jcfg, _, params, _, tmodel = pair
    fcfg = freeze_with(jcfg, backbone_exclude=["res5_block1"])
    kw = dict(base_lr=0.05, momentum=0.9, weight_decay=1e-2,
              warmup_iters=2, warmup_factor=0.1, steps=(2,), gamma=0.5,
              clip_grad_norm=clip, freeze_cfg=fcfg)
    tx = jax_tx(params, kw)
    jstate = jax_state(jax.tree.map(jnp.asarray, params), tx, use_ema=True,
                       ema_decay=0.9)
    model = copy.deepcopy(tmodel)
    ttx, _ = topt.build_optimizer(model, **kw)
    tstate = TrainState(model, ttx, use_ema=True, ema_decay=0.9)
    names = dict(model.named_parameters())
    # a trainable parameter with no gradient still decays and gains momentum
    silent = "backbone.res5_block1.conv2.weight"
    assert silent in ttx.names
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = _leaf_grads(params, rng)
        sd = state_dict_from_jax(grads)
        sd_silent = sd[silent]
        sd[silent] = torch.zeros_like(sd_silent)
        flat = flat_paths(grads)
        flat["backbone/res5_block1/conv2/kernel"][...] = 0.0
        jstate = jstate.apply_updates(grads, tx)
        for n, p in names.items():
            p.grad = sd[n].clone() if n != silent else None
        tstate.apply_updates()
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    ema = state_dict_from_jax(jax.tree.map(np.asarray, jstate.ema_params))
    start = dict(tmodel.named_parameters())
    for n, p in names.items():
        if n in ttx.names:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       err_msg=n, **PARAM_TOL)
        else:
            assert torch.equal(p, start[n]) and torch.equal(want[n],
                                                            start[n]), n
        np.testing.assert_allclose(tstate.ema[n].numpy(), ema[n].numpy(),
                                   err_msg=n, **PARAM_TOL)
    assert not torch.equal(names[silent], start[silent])
    assert tstate.step == 3


def test_steps_per_call_raises(pair):
    """A two-step call refuses a batch that is not stacked two deep, and
    takes one that is: two updates, losses stacked to (2,)."""
    model = copy.deepcopy(pair[4])
    tx, _ = topt.build_optimizer(model, base_lr=0.01, warmup_iters=0)
    state = TrainState(model, tx)
    step = tsteps.make_pretrain_train_step(model, jax_grid(
        CANVAS, (8, 16, 32, 64, 128), [64, 128, 256, 512]),
        trunner._loss_cfg(pair[3]), steps_per_call=2)
    batch = torch_batch(pretrain_batch(0))
    with pytest.raises(ValueError, match="STEPS_PER_CALL"):
        step(state, batch)
    state, losses = step(state, tsteps.stack_batches([batch, batch]))
    assert state.step == 2
    assert all(v.shape == (2,) and torch.isfinite(v).all()
               for v in losses.values())
