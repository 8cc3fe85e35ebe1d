"""What training starts from, in the port against the JAX package:

  * MODEL.WEIGHTS: a flat ``.npz`` of flax params, written the way the JAX
    package's ``tools/convert_checkpoint.py`` writes it, gives the model
    ``state_dict_from_jax`` gives (WEIGHTS_FILTER_BY_MODULE included); a
    port checkpoint loads; orbax directories, detectron2 files and a
    checkpoint of another architecture are refused;
  * ``init="train"`` draws from the flax initializers' distributions;
  * the training entry points refuse to run without a card unless asked
    for the CPU;
  * ``tools/train_net.auto_scale_world_size`` against the JAX CLI's.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.runner import meta_fcos_runner as jrunner
from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.train.checkpoint import CheckpointManager
from sylph_tpu_torch.train.optimizer import build_optimizer, flax_param_path
from sylph_tpu_torch.train.train_state import TrainState
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (few_torch_threads, flat_paths,  # noqa: F401
                             tiny_model_pair)


@pytest.fixture(scope="module")
def env():
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=5)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, tcfg=tcfg,
                tmodel=tmodel)


def _write_flat_npz(params, path):
    np.savez(path, **{k: np.asarray(v) for k, v in
                      flat_paths(params).items()})


def test_model_weights_npz_loads_like_state_dict_from_jax(env, tmp_path):
    path = str(tmp_path / "converted.npz")
    _write_flat_npz(env["params"], path)
    cfg = env["tcfg"].clone()
    cfg.defrost()
    cfg.MODEL.WEIGHTS = path
    runner = trunner.MetaFCOSRunner(device="cpu")
    got = runner.build_model(cfg, init="train").state_dict()
    want = state_dict_from_jax(env["params"])
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # WEIGHTS_FILTER_BY_MODULE drops a subtree: it keeps the fresh init
    cfg.MODEL.WEIGHTS_FILTER_BY_MODULE = ["code_generator"]
    fresh = trunner.build_model_from_cfg(cfg, device="cpu", init="train")
    got = runner.build_model(cfg, init="train").state_dict()
    for k, v in got.items():
        ref = fresh.state_dict()[k] if k.startswith("code_generator.") \
            else want[k]
        assert torch.equal(v, ref), k


def test_model_weights_port_checkpoint_and_refusals(env, tmp_path):
    cfg = env["tcfg"].clone()
    cfg.defrost()
    runner = trunner.MetaFCOSRunner(device="cpu")
    model = copy.deepcopy(env["tmodel"])
    tx, _ = build_optimizer(model, base_lr=0.1,
                            freeze_cfg=trunner._freeze_cfg(cfg))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(4, TrainState(model, tx))
    for path in (ckpt.path(4), ckpt.directory):
        cfg.MODEL.WEIGHTS = path
        got = runner.build_model(cfg, init="train").state_dict()
        for k, v in model.state_dict().items():
            assert torch.equal(got[k], v), k

    os.makedirs(tmp_path / "orbax" / "7")
    for path, what in ((str(tmp_path / "orbax"), "orbax"),
                       ("model_final.pth", "detectron2")):
        cfg.MODEL.WEIGHTS = path
        with pytest.raises(NotImplementedError, match=what):
            runner.build_model(cfg)

    # a checkpoint of another architecture is refused, not half-loaded
    other = {k: torch.zeros(3) for k in model.state_dict()}
    bad = str(tmp_path / "bad.pt")
    torch.save({"model": other}, bad)
    cfg.MODEL.WEIGHTS = bad
    with pytest.raises(ValueError, match="wrong checkpoint"):
        runner.build_model(cfg)


def test_train_init_follows_flax_initializers(env):
    """init="train" draws from the flax initializers' distributions: every
    trainable leaf has JAX's init mean/std within sampling error."""
    jmodel = jrunner.build_model_from_cfg(env["jcfg"])
    shot = 2
    init = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((shot, 64, 64, 3)), jnp.zeros((shot, 4)),
        jnp.ones((shot,), bool), jnp.zeros((1, 64, 64, 3)), shot,
        method=type(jmodel).forward_episodic_train))(jax.random.PRNGKey(0))
    jflat = flat_paths(jax.tree.map(np.asarray, init["params"]))
    model = trunner.build_model_from_cfg(env["tcfg"], device="cpu",
                                         init="train")
    for name, p in model.named_parameters():
        path = flax_param_path(model, name)
        if path not in jflat:  # cls_logits: not made by the episodic init
            continue
        want, got = jflat[path], p.detach().numpy()
        assert want.shape == tuple(np.moveaxis(got, (0, 1), (-1, -2)).shape
                                   if got.ndim == 4 else got.shape), path
        if want.size < 64:
            np.testing.assert_allclose(got.mean(), want.mean(), atol=0.05,
                                       err_msg=path)
            continue
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.15,
                                   atol=1e-3, err_msg=path)
        np.testing.assert_allclose(got.mean(), want.mean(),
                                   atol=6 * want.std() / np.sqrt(want.size)
                                   + 1e-6, err_msg=path)


def test_training_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    from sylph_tpu_torch.tools import train_net
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.MetaFCOSRunner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_net.main(["--config-file", "sylph://COCO-Detection/Meta-FCOS/"
                        "Meta-FCOS-finetune.yaml"])


@pytest.mark.parametrize("config", ["Meta-FCOS-finetune.yaml",
                                    "Meta-FCOS-pretrain.yaml"])
def test_auto_scale_world_size_matches_jax(config):
    """On the JAX test mesh's 8 devices both functions give the same
    config; on the port's one card the finetune run keeps its 48 episodes
    as 16 micro-groups of 3 and pretraining runs micro-batches of 8."""
    import importlib.util
    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu_torch import get_default_cfg
    from sylph_tpu_torch.tools.train_net import auto_scale_world_size
    spec = importlib.util.spec_from_file_location(
        "jax_train_net", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "train_net.py"))
    jtn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtn)
    name = "sylph://COCO-Detection/Meta-FCOS/" + config
    jcfg, tcfg, one = jax_default_cfg(), get_default_cfg(), get_default_cfg()
    for c in (jcfg, tcfg, one):
        c.merge_from_file(name)
    jtn.auto_scale_world_size(jcfg)
    auto_scale_world_size(tcfg, world=jax.device_count())
    for key in ("SOLVER.IMS_PER_BATCH", "SOLVER.BASE_LR", "SOLVER.MAX_ITER",
                "SOLVER.STEPS", "SOLVER.WARMUP_ITERS", "TPU.GRAD_ACCUM",
                "SOLVER.REFERENCE_WORLD_SIZE"):
        a, b = jcfg, tcfg
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, key
    auto_scale_world_size(one, world=1)
    assert one.TPU.GRAD_ACCUM == 16
    assert one.SOLVER.IMS_PER_BATCH == (48 if "finetune" in config else 128)
