"""The port's episodic train step against the JAX package's, in float32 on
the CPU with a tiny R-18: three steps on one fixed batch (device
RandAugment included) against JAX on ``create_mesh(1)``, losses within rtol
1e-4, parameters within atol 1e-5 + rtol 1e-4, frozen parameters
bit-identical in both packages; then a checkpoint save and restore
against uninterrupted steps. ``GRAD_ACCUM = 2`` with snnl, distillation and
FREEZE_EXCLUDE is in tests/test_torch_train_accum.py. The FrozenBN note of
tests/test_torch_train.py holds here too.
"""

import copy

import pytest
import torch

from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.train import optimizer as topt
from sylph_tpu_torch.train import steps as tsteps
from sylph_tpu_torch.train.checkpoint import CheckpointManager
from sylph_tpu_torch.train.train_state import TrainState

from torch_port_util import (CANVAS, check_episodic_steps,  # noqa: F401
                             episodic_batch, few_torch_threads, freeze_with,
                             opt_kw, tiny_model_pair, torch_batch)


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(episodic=True, seed=3)


def test_episodic_steps_match_jax(pair):
    check_episodic_steps(pair, grad_accum=1)


def test_checkpoint_resume_equals_uninterrupted_steps(pair, tmp_path):
    """Two steps, save, a fresh model restored from the file, one more step:
    bit-identical to three uninterrupted steps (CPU, deterministic)."""
    jcfg, _, _, tcfg, tmodel = pair
    grid = jax_grid(CANVAS, (8, 16, 32, 64, 128), [64, 128, 256, 512])
    batches = [torch_batch(episodic_batch(s)) for s in (1, 2, 3)]

    def fresh():
        model = copy.deepcopy(tmodel)
        tx, _ = topt.build_optimizer(model, **opt_kw(jcfg, freeze_with(jcfg)))
        st = TrainState(model, tx, use_ema=True, ema_decay=0.5)
        step = tsteps.make_episodic_train_step(
            model, grid, trunner._loss_cfg(tcfg), num_shots=2)
        return st, step

    straight, step = fresh()
    for b in batches:
        step(straight, b)
    first, step = fresh()
    for b in batches[:2]:
        step(first, b)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    mgr.save(first.step, first)
    resumed, step = fresh()
    resumed, at = mgr.restore(resumed)
    assert at == 2 and resumed.step == 2
    step(resumed, batches[2])
    for (n, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for n in straight.ema:
        assert torch.equal(straight.ema[n], resumed.ema[n]), n
