"""Data-parallel training of the port over 2 gloo ranks on the CPU.

Each rank is a process with its ``DataGroup`` (``spawn_ranks``); the
runner's loaders give it its slice of every global batch, and its steps
average gradients and losses across the ranks.

  * Episodic meta-training through ``MetaFCOSRunner.do_train``, world 2 x
    ``TPU.GRAD_ACCUM`` 4, 2 iterations on a tiny synthetic COCO tree (tiny
    R-18, fp32, device RandAugment), against the JAX runner on its 8-device
    mesh (losses rtol 1e-3, parameters atol 1e-4) and against the port's
    one process x GRAD_ACCUM 8 (losses rtol 1e-5, parameters atol 1e-6);
    both ranks hold bit-identical parameters. Rank 0 alone writes
    ``metrics.json`` and the checkpoints; both ranks restore the last one
    into a fresh model, bit-equal to the trained parameters, and take a
    third step together.
  * One pretraining step, world 2 x GRAD_ACCUM 1 against one process x
    GRAD_ACCUM 2.

The two-stage step is in test_torch_dp_rcnn_train.py. This file imports
nothing of JAX at module level: every rank imports it.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from sylph_tpu_torch.data.catalog import (DatasetCatalog, MetadataCatalog,
                                          register_all_coco)
from sylph_tpu_torch.runner import MetaFCOSRunner, build_model_from_cfg


def _episodic_cfg(cfg, grad_accum):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.DATASETS.TRAIN = ["coco_meta_train_base"]
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    cfg.TPU.TRAIN_CANVAS = [96, 96]
    cfg.TPU.GRAD_ACCUM = grad_accum
    cfg.INPUT.MIN_SIZE_TRAIN = [80]
    return cfg


def _pretrain_cfg(cfg, grad_accum):
    cfg = _episodic_cfg(cfg, grad_accum)
    cfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = 1
    return cfg


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _train(group, cfg, start):
    """``do_train`` of a model holding ``start`` on this rank; -> (model,
    state, losses per step)."""
    model = build_model_from_cfg(cfg, device="cpu")
    model.load_state_dict(start)
    runner = MetaFCOSRunner(group=group)
    _, state = runner.do_train(cfg, model)
    return model, state, runner.train_metrics


def _register(root):
    DatasetCatalog.clear()
    MetadataCatalog.clear()
    register_all_coco(root)


def rank_episodic(group, out, cfg, start, root):
    """Two steps; then a fresh model restored from rank 0's last checkpoint
    and a third step."""
    _register(root)
    cfg = cfg.clone()
    cfg.OUTPUT_DIR = os.path.join(out, "run")
    model, state, losses = _train(group, cfg, start)
    cfg.SOLVER.MAX_ITER = 3
    fresh = build_model_from_cfg(cfg, device="cpu")
    fresh.load_state_dict(start)
    runner = MetaFCOSRunner(group=group)
    restored, _, _ = runner._common_train_setup(cfg, fresh)
    restored_params = _params(fresh)
    _, third = runner.do_train(cfg, fresh)
    return {"losses": losses, "params": _params(model),
            "trainable": sorted(state.tx.names),
            "restored_step": restored.step, "restored": restored_params,
            "third_step": third.step, "third_losses": runner.train_metrics,
            "third": _params(fresh)}


def rank_pretrain(group, out, cfg, start, root):
    _register(root)
    model, state, losses = _train(group, cfg, start)
    return {"losses": losses, "params": _params(model),
            "trainable": sorted(state.tx.names)}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from torch_port_util import register_both, tiny_model_pair

    from sylph_tpu_torch.data.synthetic import make_synthetic_coco
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    register_both(root)
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=5)
    return dict(root=root, jcfg=jcfg, jmodel=jmodel, params=params,
                tcfg=tcfg, tmodel=tmodel)


@pytest.fixture(scope="module")
def episodic(env, tmp_path_factory):
    """The JAX runner on 8 devices, the port's one process x 8 groups and
    its 2 ranks x 4 groups, from the same weights."""
    import jax

    from sylph_tpu.runner import meta_fcos_runner as jrunner
    from torch_port_util import spawn_ranks
    assert jax.device_count() == 8
    jax_losses = []
    write = jrunner.MetricsWriter.write

    def record(self, step, metrics, lr=None):
        jax_losses.append(dict(metrics))
        return write(self, step, metrics, lr)

    jrunner.MetricsWriter.write = record
    try:
        jcfg = _episodic_cfg(env["jcfg"], 1)
        jcfg.SOLVER.CHECKPOINT_PERIOD = 100
        _, jstate = jrunner.MetaFCOSRunner().do_train(jcfg, env["jmodel"],
                                                      env["params"])
    finally:
        jrunner.MetricsWriter.write = write
    js = jstate.unpack() if hasattr(jstate, "unpack") else jstate

    start = env["tmodel"].state_dict()
    model = copy.deepcopy(env["tmodel"])
    one = MetaFCOSRunner(device="cpu")
    one.do_train(_episodic_cfg(env["tcfg"], 8), model)
    ranks = spawn_ranks(__file__, "rank_episodic",
                        tmp_path_factory.mktemp("dp_episodic"),
                        cfg=_episodic_cfg(env["tcfg"], 4), start=start,
                        root=env["root"])
    return dict(jax_losses=jax_losses, jax_params=jax.tree.map(
        np.asarray, js.params), one_losses=one.train_metrics,
        one_params=_params(model), ranks=ranks, start=start)


def test_dp_episodic_do_train_matches_jax_runner(episodic):
    from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax
    r0 = episodic["ranks"][0]
    assert len(r0["losses"]) == len(episodic["jax_losses"]) == 2
    for it, (tm, jm) in enumerate(zip(r0["losses"], episodic["jax_losses"])):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3,
                                       err_msg=f"iter {it} {k}")
    want = state_dict_from_jax(episodic["jax_params"])
    trainable = set(r0["trainable"])
    for n, p in r0["params"].items():
        if n in trainable:
            np.testing.assert_allclose(p.numpy(), want[n].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=n)
        else:
            assert torch.equal(p, episodic["start"][n]), n


def test_dp_episodic_equals_one_process_and_ranks_agree(episodic):
    r0, r1 = episodic["ranks"]
    for tm, om in zip(r0["losses"], episodic["one_losses"]):
        assert sorted(tm) == sorted(om)
        for k in om:
            np.testing.assert_allclose(tm[k], om[k], rtol=1e-5, err_msg=k)
    assert r0["losses"] == r1["losses"]
    moved = 0
    for n, p in r0["params"].items():
        np.testing.assert_allclose(p.numpy(), episodic["one_params"][n],
                                   rtol=0, atol=1e-6, err_msg=n)
        assert torch.equal(p, r1["params"][n]), n
        moved += int(not torch.equal(p, episodic["start"][n]))
    assert moved > 0


def test_dp_checkpoint_by_rank_zero_resumes_on_both_ranks(episodic,
                                                          tmp_path_factory):
    r0, r1 = episodic["ranks"]
    for r in (r0, r1):
        assert r["restored_step"] == 2 and r["third_step"] == 3
        assert len(r["third_losses"]) == 1
        for n, p in r0["params"].items():
            assert torch.equal(r["restored"][n], p), n
    assert r0["third_losses"] == r1["third_losses"]
    moved = 0
    for n, p in r0["third"].items():
        assert torch.equal(p, r1["third"][n]), n
        moved += int(not torch.equal(p, r0["params"][n]))
    assert moved > 0
    base = tmp_path_factory.getbasetemp()
    run = next(base.glob("dp_episodic*")) / "run"
    with open(run / "metrics.json") as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows] == [1, 2, 3]  # one writer
    assert sorted(os.listdir(run / "ckpt")) == [
        f"step_0000000{i}.pt" for i in (1, 2, 3)]


def test_dp_pretrain_step_equals_one_process(env, tmp_path_factory):
    from torch_port_util import shrink_meta_cfg, spawn_ranks

    from sylph_tpu_torch import get_default_cfg
    cfg = shrink_meta_cfg(get_default_cfg(), episodic=False)
    model = build_model_from_cfg(cfg, device="cpu", init="train")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    one = MetaFCOSRunner(device="cpu")
    _, state = one.do_train(_pretrain_cfg(cfg, 2), model)
    r0, r1 = spawn_ranks(__file__, "rank_pretrain",
                         tmp_path_factory.mktemp("dp_pretrain"),
                         cfg=_pretrain_cfg(cfg, 1), start=start,
                         root=env["root"])
    assert "backbone.res2_block0.conv1.weight" in r0["trainable"]
    for k, v in one.train_metrics[0].items():
        np.testing.assert_allclose(r0["losses"][0][k], v, rtol=1e-5,
                                   err_msg=k)
    assert r0["losses"] == r1["losses"]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(r0["params"][n].numpy(),
                                   p.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
        assert torch.equal(r0["params"][n], r1["params"][n]), n


def test_cli_distributed_on_two_cpu_ranks(tmp_path):
    """``train_net --distributed`` in 2 processes (RANK and WORLD_SIZE set
    as torchrun sets them, a file:// rendezvous) under SYLPH_TEST_MODE:
    both ranks train and meta-test; rank 0 alone writes the launch files,
    one ``metrics.json`` row per step, the checkpoint and the results."""
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "sylph_tpu_torch.tools.train_net",
            "--distributed", "--dist-url", f"file://{tmp_path}/rendezvous",
            "--device", "cpu", "--config-file",
            "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml",
            "--datasets-root", str(tmp_path / "coco"), "--output-dir",
            str(out), "MODEL.RESNETS.DEPTH", "18", "TPU.TRAIN_CANVAS",
            "[96, 96]", "TPU.EVAL_CANVAS", "[96, 128]", "TPU.SUPPORT_CANVAS",
            "[64, 64]"]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                   SYLPH_TEST_MODE="1", RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r))
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(argv, env=env, cwd=str(tmp_path),
                                      stdout=log, stderr=subprocess.STDOUT))
        log.close()
    deadline = time.monotonic() + 240
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    assert all("auto-scaled world size 16 -> 2" in log for log in logs)
    assert sorted(os.listdir(out)) == [
        "ckpt", "class_codes", "config.yaml", "config_diff.yaml", "env.txt",
        "eval_results.json", "metrics.json", "tb"]
    with open(out / "metrics.json") as f:
        # SYLPH_TEST_MODE: 10 steps
        assert [json.loads(line)["iteration"] for line in f] == list(
            range(1, 11))
    assert os.listdir(out / "ckpt") == ["step_00000010.pt"]
    with open(out / "eval_results.json") as f:
        assert "AP" in json.load(f)["coco_meta_val_novel"]["bbox"]


def test_train_loaders_give_each_rank_its_slice(env):
    """Each rank's batch is byte-equal to its contiguous slice of the batch
    one process makes, for both train loaders, two batches running."""
    from sylph_tpu_torch.data.loader import (build_episodic_train_loader,
                                             build_pretrain_loader)
    from sylph_tpu_torch.data.meta_dataset import MetaDataset
    from sylph_tpu_torch.parallel import DataGroup, shard_batch
    from sylph_tpu_torch.runner import _mapper

    cfg = _episodic_cfg(env["tcfg"], 1)
    mapper = _mapper(cfg)
    records = DatasetCatalog.get("coco_pretrain_train_base")["records"]

    def episodic(**kw):
        ds = MetaDataset(DatasetCatalog.get("coco_meta_train_base"),
                         "episodic_train_both", num_shot=2)
        return build_episodic_train_loader(ds, mapper, episodes_per_batch=4,
                                           seed=3, **kw)

    def pretrain(**kw):
        return build_pretrain_loader(records, mapper, batch_size=4, seed=3,
                                     **kw)

    for build in (episodic, pretrain):
        one = build()
        ranks = [build(rank=r, world_size=2) for r in range(2)]
        for _ in range(2):
            whole = {k: np.array(v) for k, v in next(one).items()}
            for r, loader in enumerate(ranks):
                want = shard_batch(whole, DataGroup(r, 2, None,
                                                    torch.device("cpu")))
                got = next(loader)
                assert sorted(got) == sorted(want)
                for k, v in want.items():
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
        for loader in (one, *ranks):
            loader.close()
    with pytest.raises(ValueError, match="does not split"):
        pretrain(rank=0, world_size=3)
