"""``TPU.STEPS_PER_CALL`` in the port: K optimizer steps a call, in float32
on the CPU with a tiny R-18.

  * the port's K = 2 pretrain and episodic steps against the JAX package's
    scanned ``steps_per_call=2`` steps on the same numpy-seeded batches:
    the (2,) losses within rtol 1e-4, parameters within rtol 1e-4 / atol
    1e-5, frozen ones bit-identical (the FrozenBN note of
    tests/test_torch_train.py holds here too);

One call of K = 2 against two calls of one for each of the four step
builders, and ``do_train`` with K = 2, are in
tests/test_torch_steps_per_call_port.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu.parallel.mesh import create_mesh
from sylph_tpu.runner import meta_fcos_runner as jrunner
from sylph_tpu.train import steps as jsteps
from sylph_tpu.train.train_state import create_train_state as jax_state
from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.train import optimizer as topt
from sylph_tpu_torch.train import steps as tsteps
from sylph_tpu_torch.train.train_state import TrainState
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (CANVAS, check_run, episodic_batch,
                             few_torch_threads,  # noqa: F401
                             freeze_with, jax_tx, opt_kw, pretrain_batch,
                             tiny_model_pair, torch_batch)

K = 2
STRIDES = (8, 16, 32, 64, 128)
SIZES = [64, 128, 256, 512]


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(episodic=True, seed=6)


def _stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("episodic", [False, True])
def test_k_step_call_matches_jax_scan(pair, episodic):
    jcfg, jmodel, params, tcfg, tmodel = pair
    freeze = freeze_with(jcfg, **({} if episodic else
                                  dict(episodic=False, backbone=False)))
    kw = opt_kw(jcfg, freeze)
    batches = [(episodic_batch if episodic else pretrain_batch)(s)
               for s in (3, 4)]
    stacked = _stacked(batches)

    tx = jax_tx(params, kw)
    jst = jax_state(jax.tree.map(jnp.array, params), tx)
    grid = jax_grid(CANVAS, STRIDES, SIZES)
    mesh = create_mesh(1)
    lc = jrunner._loss_cfg(jcfg)
    jb = jax.tree.map(jnp.asarray, stacked)
    if episodic:
        jstep = jsteps.make_episodic_train_step(jmodel, tx, grid, lc, mesh,
                                                num_shots=2, steps_per_call=K)
        rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(K)])
        jst, jm = jstep(jst, jb, rngs)
    else:
        jstep = jsteps.make_pretrain_train_step(jmodel, tx, grid, lc, mesh,
                                                steps_per_call=K)
        jst, jm = jstep(jst, jb)
    js = jst.unpack() if hasattr(jst, "unpack") else jst
    want = state_dict_from_jax(jax.tree.map(np.asarray, js.params))

    model = copy.deepcopy(tmodel)
    ttx, _ = topt.build_optimizer(model, **kw)
    tst = TrainState(model, ttx)
    grid = jax_grid(CANVAS, STRIDES, SIZES)
    lc = trunner._loss_cfg(tcfg)
    step = (tsteps.make_episodic_train_step(model, grid, lc, num_shots=2,
                                            steps_per_call=K)
            if episodic else
            tsteps.make_pretrain_train_step(model, grid, lc,
                                            steps_per_call=K))
    _, tm = step(tst, tsteps.stack_batches([torch_batch(b)
                                            for b in batches]))
    assert all(v.shape == (K,) for v in tm.values())
    losses = [({k: float(np.asarray(v)[i]) for k, v in jm.items()},
               {k: float(v[i]) for k, v in tm.items()}) for i in range(K)]
    check_run((losses, want, model, tst), tmodel)
