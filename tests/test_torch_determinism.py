"""A training step repeats its bits: run twice from one train state and one
batch, it leaves every parameter, momentum and step count equal, bit for
bit. JAX's two-stage pretraining step does (XLA on the CPU); so do the
port's two-stage pretraining and episodic steps and its one-stage episodic
step on the CPU, with several torch threads. The two-stage steps' ROIAlign
backward sums each pixel's gradients in tap order (``ops/roi_align.py::
_Gather``): autograd's own ``index_put_`` with ``accumulate`` sums across
CPU threads in a varying order. On the card, ``chip_smoke.py`` phase 26
holds the same steps at full width.

The sampling draws of a two-stage step come from a CPU ``torch.Generator``
seeded with ``SampleDraws.step_seed(SEED, iteration, group)`` whatever the
model's device: the card samples the anchors and ROIs the CPU samples.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu_torch import get_default_cfg
from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
from sylph_tpu_torch.models import rcnn
from sylph_tpu_torch.runner import MetaFCOSRunner

from torch_port_util import (CANVAS, episodic_batch, freeze_with,
                             jax_rcnn_loss_apply, jax_tx, opt_kw, rcnn_pair,
                             rcnn_train_batch, rcnn_train_cfg,
                             shrink_meta_cfg, shrink_rcnn_cfg, torch_batch,
                             train_loop_key)


@pytest.fixture(autouse=True)
def four_torch_threads():
    """Four torch threads, restored after: an order that varies with the
    threads shows only with more than one."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _port_case(name):
    """-> (train state, step, batch) of a port step at test size on the
    CPU, built as ``do_train`` builds it."""
    if name == "fcos_episodic":
        runner = MetaFCOSRunner(device="cpu")
        cfg = shrink_meta_cfg(get_default_cfg(), episodic=True)
        cfg.TPU.TRAIN_CANVAS = list(CANVAS)   # the batch's canvas
        batch = torch_batch(episodic_batch(0))
    else:
        episodic = name == "rcnn_episodic"
        runner = MetaFasterRCNNRunner(device="cpu")
        cfg = rcnn_train_cfg(shrink_rcnn_cfg(
            MetaFasterRCNNRunner.get_default_cfg(), episodic))
        cfg.TPU.GRAD_ACCUM = 2
        batch = torch_batch(rcnn_train_batch(episodic, n=4))
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 0
    model = runner.build_model(cfg, init="train")
    state, _, _ = runner._common_train_setup(cfg, model)
    return state, runner.make_train_step(cfg, model), batch


def _leaves(state):
    sd = copy.deepcopy(state.state_dict())   # the CPU's shares the tensors
    out = {f"model/{k}": v for k, v in sd["model"].items()}
    out.update({f"trace/{k}": v for k, v in sd["tx"]["trace"].items()})
    out["count"] = torch.tensor(sd["tx"]["count"])
    return out


@pytest.mark.parametrize("name", ["rcnn_pretrain", "rcnn_episodic",
                                  "fcos_episodic"])
def test_port_step_repeats_its_bits(name):
    state, step, batch = _port_case(name)
    saved = copy.deepcopy(state.state_dict())
    start = _leaves(state)
    runs = []
    for _ in range(2):
        state.load_state_dict(saved)
        step(state, batch)
        runs.append(_leaves(state))
    a, b = runs
    assert sorted(a) == sorted(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    moved = [k for k in a if k.startswith("model/")
             and not torch.equal(a[k], start[k])]
    assert len(moved) >= 10   # the step trained


def test_jax_rcnn_pretrain_step_repeats_its_bits():
    """JAX's two-stage pretraining step (the runner's ``_sgd_step_factory``
    through ``finalize_step``) from one state and one batch, twice."""
    from sylph_tpu.parallel.mesh import create_mesh, shard_batch
    from sylph_tpu.runner.meta_faster_rcnn_runner import \
        MetaFasterRCNNRunner as JaxRunner
    from sylph_tpu.train.steps import finalize_step
    from sylph_tpu.train.train_state import create_train_state

    jcfg, jmodel, params, _, _ = rcnn_pair(episodic=False)
    jcfg = rcnn_train_cfg(jcfg)
    tx = jax_tx(params, opt_kw(jcfg, freeze_with(jcfg)))
    state = create_train_state(jax.tree.map(jnp.array, params), tx)
    mesh = create_mesh(1)
    step = finalize_step(JaxRunner._sgd_step_factory(
        tx, jax_rcnn_loss_apply(jmodel, jcfg, False)), mesh, with_rng=True)
    batch = shard_batch(mesh, rcnn_train_batch(False, n=2))
    runs = []
    for _ in range(2):
        out, _ = step(jax.tree.map(jnp.copy, state), batch,
                      train_loop_key(0))
        runs.append([np.asarray(x) for x in jax.tree.leaves(out)])
    a, b = runs
    assert len(a) == len(b) > 0
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, np.asarray(y)) for x, y in
                   zip(a, jax.tree.leaves(state)))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_draws_are_the_cpu_generators_stream(device, monkeypatch):
    """``SampleDraws.for_step`` on any device: the CPU generator's uniforms
    for ``step_seed(SEED, iteration, group)``, then a copy to the device
    (recorded here, where there is no card)."""
    moved = []
    to = torch.Tensor.to

    def record(t, *args, **kwargs):
        moved.append(torch.device(args[0]))
        return t if moved[-1].type == "cuda" else to(t, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", record)
    src = rcnn.SampleDraws.for_step(3, 7, 2, device)
    ref = torch.Generator().manual_seed(rcnn.SampleDraws.step_seed(3, 7, 2))
    want_rpn = torch.rand((2, 50), generator=ref)
    want_roi = torch.rand((2, 2, 30), generator=ref)
    got_rpn = src.rpn(2, 50)
    sub, tie = src.roi(2, 30)
    assert got_rpn.device.type == "cpu"   # drawn there
    assert torch.equal(got_rpn, want_rpn)
    assert torch.equal(sub, want_roi[:, 0]) and torch.equal(tie,
                                                            want_roi[:, 1])
    assert moved == [torch.device(device)] * 2


def test_step_samples_by_the_cpu_stream(monkeypatch):
    """A two-stage step's anchor priorities, micro-group by micro-group:
    the CPU stream of (SEED, iteration 0, group)."""
    seen = []
    rpn = rcnn.SampleDraws.rpn

    def record(self, b, k):
        out = rpn(self, b, k)
        seen.append(out.clone())
        return out

    monkeypatch.setattr(rcnn.SampleDraws, "rpn", record)
    state, step, batch = _port_case("rcnn_pretrain")
    step(state, batch)
    assert len(seen) == 2
    for group, got in enumerate(seen):
        ref = torch.Generator().manual_seed(
            rcnn.SampleDraws.step_seed(0, 0, group))
        assert torch.equal(got, torch.rand(got.shape, generator=ref))
