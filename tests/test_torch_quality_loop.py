"""The port's quality-loop driver end to end on the CPU, and the stage
hand-off between the two packages.

``sylph_tpu_torch/tools/quality_loop.py`` runs ``fcos_heldout`` at 96x96 for
4 + 4 iterations on a small hard set: both stages finish, and the base
pretrain's ``base_pretrain.npz`` is a flat ``.npz`` of flax params that the
JAX package's ``MetaFCOSRunner`` loads as MODEL.WEIGHTS leaf for leaf,
giving the port's dense outputs (1e-4, fp32); a ``.npz`` the JAX driver
writes loads into the port just as well.

Under ``slow``: the port's counterparts of the JAX package's above-chance AP
checks (tests/test_quality_loop.py, tests/test_quality_loop_families.py),
and the same-init trajectory test, the tool for localising a family that
misses its band: JAX's initial parameters, converted, and the same data for
50 steps of each ``fcos_heldout`` stage in both packages, the per-step
losses compared.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu_torch.data.synthetic import (make_learnable_coco,
                                            make_learnable_lvis)
from sylph_tpu_torch.tools import quality_loop
from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax

from torch_port_util import (few_torch_threads,  # noqa: F401
                             flat_paths, randomize)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
BGR_MEAN = np.array([103.530, 116.280, 123.675], np.float32)


@pytest.fixture(scope="module")
def heldout(tmp_path_factory):
    """``fcos_heldout`` through the driver: 96x96, 4 + 4 iterations,
    REPEAT_TEST 1, a hard set of 48 train and 12 + 2 val images."""
    root = tmp_path_factory.mktemp("quality")
    data = str(root / "hard")
    make_learnable_coco(data, n_train=48, n_val=12, img_hw=(96, 96),
                        n_empty_val=2, hard=True)
    args = quality_loop.parse_args(
        ["--family", "fcos_heldout", "--hard", "--iters", "4",
         "--repeat-test", "1", "--device", "cpu",
         "--data-root", data, "--output-dir", str(root / "out")])
    args.canvas = 96
    results = quality_loop.run(args)
    return args, results


def _cfg(default, path, weights):
    cfg = default
    cfg.merge_from_file(path)
    cfg.MODEL.WEIGHTS = weights
    return cfg


def _images(seed, n=2, hw=(96, 96)):
    rng = np.random.RandomState(seed)
    # pixels near the BGR mean keep activations O(1), so 1e-4 measures the
    # port and not fp32 rounding of pixel-range sums
    return (BGR_MEAN + 2.0 * rng.randn(n, *hw, 3)).astype(np.float32)


def _dense_close(jmodel, jparams, model, images, tol=1e-4):
    want = jmodel.apply({"params": jparams}, jnp.asarray(images))
    with torch.no_grad():
        got = model.forward_base(torch.from_numpy(images))
    for name in ("logits", "reg", "ctrness"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=tol, atol=tol, err_msg=name)


def test_driver_runs_both_stages_and_writes_its_files(heldout):
    args, results = heldout
    out = args.output_dir
    assert [s["stage"] for s in args.stages] == ["pretrain", "finetune"]
    for stage in args.stages:
        assert stage["iters"] == 4 and stage["nms_launches_train"] is None
        assert np.isfinite([stage["loss_first"], stage["loss_last"]]).all()
        # no profiler on the CPU: the training time is do_train's wall
        assert stage["profile"] is None and stage["profiler_s"] == 0.0
        assert stage["train_s"] == stage["train_wall_s"]
        assert sum(stage["train_parts"].values()) == pytest.approx(
            stage["train_s"], rel=1e-9)
    assert sorted(results) == ["coco_meta_val_all", "coco_meta_val_base",
                               "coco_meta_val_novel"]
    for name in ("nAP", "bAP", "AP"):
        assert np.isfinite(results["coco_meta_val_all"]["bbox"][name])
    for rel in ("eval_results.json", "run_stats.json", "base_pretrain.npz",
                "config.yaml", "config_diff.yaml", "env.txt",
                "pretrain/config.yaml", "pretrain/config_diff.yaml"):
        assert os.path.exists(os.path.join(out, rel)), rel
    with open(os.path.join(out, "eval_results.json")) as f:
        assert sorted(json.load(f)) == sorted(results)
    with open(os.path.join(out, "run_stats.json")) as f:
        stats = json.load(f)
    assert stats["family"] == "fcos_heldout" and len(stats["stages"]) == 2
    # the finetune stage loaded the pretrain's weights
    with open(os.path.join(out, "config.yaml")) as f:
        assert "base_pretrain.npz" in f.read()


def test_port_npz_loads_into_jax_with_the_same_outputs(heldout):
    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu.runner.meta_fcos_runner import MetaFCOSRunner as JaxRunner
    from sylph_tpu_torch import get_default_cfg
    from sylph_tpu_torch.runner import MetaFCOSRunner

    args, _ = heldout
    npz = os.path.join(args.output_dir, "base_pretrain.npz")
    config = os.path.join(args.output_dir, "pretrain", "config.yaml")
    jmodel, jparams = JaxRunner().build_model(
        _cfg(jax_default_cfg(), config, npz))
    # every leaf of JAX's pretrain model comes from the file, unchanged
    flat = np.load(npz)
    jflat = flat_paths(jax.tree.map(np.asarray, jparams))
    assert sorted(flat.files) == sorted(jflat)
    for k in flat.files:
        assert np.array_equal(flat[k], jflat[k]), k
    model = MetaFCOSRunner(device="cpu").build_model(
        _cfg(get_default_cfg(), config, npz), init="train")
    _dense_close(jmodel, jparams, model, _images(0))


def test_jax_npz_loads_into_the_port_with_the_same_outputs(heldout,
                                                           tmp_path):
    from quality_loop_variants import _flatten, jax_to_py
    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu.runner.meta_fcos_runner import MetaFCOSRunner as JaxRunner
    from sylph_tpu_torch import get_default_cfg
    from sylph_tpu_torch.runner import MetaFCOSRunner

    args, _ = heldout
    config = os.path.join(args.output_dir, "pretrain", "config.yaml")
    jmodel, jparams = JaxRunner().build_model(
        _cfg(jax_default_cfg(), config, ""))
    jparams = randomize(jparams, np.random.RandomState(3))
    npz = str(tmp_path / "base_pretrain.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     _flatten(jax_to_py(jparams)).items()})
    model = MetaFCOSRunner(device="cpu").build_model(
        _cfg(get_default_cfg(), config, npz), init="train")
    want = state_dict_from_jax(jparams)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _dense_close(jmodel, jparams, model, _images(1))


def test_nms_audit_holds_each_launch_against_the_twin(monkeypatch):
    """The driver's audit on the card, with a stand-in for the CUDA entry
    point: matching launches are counted by label and shape, a launch that
    differs from the twin raises, and uninstalling restores the entry."""
    from sylph_tpu_torch.ops import nms_kernel
    from sylph_tpu_torch.ops.nms import nms_select_reference
    from sylph_tpu_torch.tools.nms_audit import NMSAudit

    wrong = []

    def kernel(x1, y1, x2, y2, scores, valid, iou_threshold, max_outputs):
        idx, ok = nms_select_reference(torch.stack([x1, y1, x2, y2], -1),
                                       scores, valid.bool(), iou_threshold,
                                       max_outputs)
        return (idx.roll(1, dims=1) if wrong else idx), ok.to(torch.int32)

    monkeypatch.setattr(nms_kernel, "nms_cuda", kernel)
    gen = torch.Generator().manual_seed(0)
    xy = torch.rand((2, 50, 2), generator=gen) * 80
    wh = 8 + torch.rand((2, 50, 2), generator=gen) * 24
    planes = [*(xy.unbind(-1)), *((xy + wh).unbind(-1)),
              torch.rand((2, 50), generator=gen),
              (torch.rand((2, 50), generator=gen) > 0.2).to(torch.int32)]
    audit = NMSAudit().install()
    try:
        for _ in range(2):
            nms_kernel.nms_cuda(*planes, 0.5, 10)
        assert audit.flush("test") == 2
        wrong.append(True)
        nms_kernel.nms_cuda(*planes, 0.5, 10)
        with pytest.raises(AssertionError, match="NMS kernel != twin"):
            audit.flush("wrong")
    finally:
        audit.uninstall()
    assert nms_kernel.nms_cuda is kernel
    assert audit.by_label == {"test": 2}
    assert audit.shapes[(2, 50, 10, 0.5)]["launches"] == 2


class _TimedRunner:
    """A runner whose ``do_train`` sleeps known times around five steps:
    set-up 50 ms, a first batch 20 ms, each step 10 ms, 5 ms between
    steps, 30 ms after the last (the final checkpoint's place)."""

    device = torch.device("cpu")

    def __init__(self):
        self.cfgs, self.loop_times, self.train_metrics = [], [], []

    def get_default_cfg(self):
        from sylph_tpu_torch import get_default_cfg
        return get_default_cfg()

    def build_model(self, cfg, init):
        self.cfgs.append(cfg)
        return torch.nn.Linear(1, 1)

    def make_train_step(self, cfg, model):
        def step(state, batch):
            time.sleep(0.010)
            return state, {"loss": 1.0}
        return step

    def do_train(self, cfg, model):
        time.sleep(0.050)
        step = self.make_train_step(cfg, model)
        self.loop_times, self.train_metrics = [], []
        for i in range(5):
            t0 = time.perf_counter()
            time.sleep(0.020 if i == 0 else 0.0)
            t1 = time.perf_counter()
            _, m = step(None, None)
            self.loop_times.append((t1 - t0, time.perf_counter() - t1))
            self.train_metrics.append(m)
            time.sleep(0.005)
        time.sleep(0.030)
        return model, SimpleNamespace(step=5)

    def eval_params(self, cfg, state):
        return {}

    def do_test(self, cfg, model, step):
        return {"val": {"bbox": {"AP": 50.0}}}


def test_stage_time_parts_and_seed(tmp_path):
    """``_train_and_test`` splits do_train's wall time into parts that add
    up to ``train_s``, each at least what the runner slept in it; the
    step function is the class's again afterwards; ``args.seed`` is the
    stage's SEED, in the config it builds from and in config.yaml."""
    from sylph_tpu_torch import get_default_cfg

    runner = _TimedRunner()
    cfg = get_default_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.SOLVER.MAX_ITER = 5
    cfg.freeze()
    args = SimpleNamespace(seed=7, stages=[], audit=None)
    results, _ = quality_loop._train_and_test(runner, cfg, args, "train")
    assert results["val"]["bbox"]["AP"] == 50.0
    assert runner.cfgs[0].SEED == 7
    with open(tmp_path / "config.yaml") as f:
        assert "SEED: 7" in f.read()
    assert "make_train_step" not in vars(runner)
    (stage,) = args.stages
    parts = stage["train_parts"]
    assert sum(parts.values()) == pytest.approx(stage["train_s"], rel=1e-9)
    assert stage["train_s"] == stage["train_wall_s"]
    assert 0.050 <= parts["setup_s"] < 0.5
    assert 0.020 <= parts["first_batch_s"] < 0.5
    assert 5 * 0.010 <= parts["median_steps_s"] < 1.0
    assert 5 * 0.005 + 0.030 <= parts["outside_steps_s"] < 1.0
    assert stage["median_step_ms"] >= 10.0


def test_seed_tool_runs_each_seed_and_reports_the_spread(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``tools/quality_seeds.py``: one driver run a seed, each into its own
    directory with ``args.seed`` set, then the mean and population std of
    each metric over the seeds (the REPEAT_TEST std columns left out)."""
    from sylph_tpu_torch.tools import quality_seeds

    seen = []

    def run(args):
        seen.append((args.seed, args.output_dir, args.family))
        ap = 60.0 + 10.0 * args.seed
        return {"coco_pretrain_val_all": {"bbox": {
                    "AP": ap, "nAP": ap - 5, "bAP": ap + 5, "AP_std": 1.0}},
                "base_pretrain": {"bbox": {"AP": 80.0}}}

    monkeypatch.setattr(quality_loop, "run", run)
    out = str(tmp_path / "seeds")
    line = quality_seeds.main(["--seeds", "1", "2", "--", "--family",
                               "tfa_rcnn", "--data-root", "d",
                               "--output-dir", out, "--device", "cpu"])
    assert seen == [(1, os.path.join(out, "seed1"), "tfa_rcnn"),
                    (2, os.path.join(out, "seed2"), "tfa_rcnn")]
    spread = line["spread"]["coco_pretrain_val_all"]
    assert spread["AP"] == {"mean": 75.0, "std": 5.0}
    assert spread["nAP"]["mean"] == 70.0 and "AP_std" not in spread
    assert line["spread"]["base_pretrain"]["AP"] == {"mean": 80.0,
                                                     "std": 0.0}
    assert line["runs"][2]["coco_pretrain_val_all"]["AP"] == 80.0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["quality_seeds"] == "tfa_rcnn"


# ------------------------------------------------------------------ slow
@pytest.fixture()
def learnable(tmp_path):
    root = str(tmp_path / "lc")
    make_learnable_coco(root, n_train=80, n_val=16, img_hw=(96, 96),
                        n_empty_val=2)
    return root


def _slow_args(tmp_path, data, **kw):
    base = dict(iters=150, lr=0.01, hard=False, repeat_test=1, canvas=96,
                ref_depth=False, grad_accum=0, ref_world=0, device="cpu",
                data_root=data, output_dir=str(tmp_path / "out"))
    base.update(kw)
    return SimpleNamespace(**base)


def _shrink_for_cpu(cfg, canvas=96):
    """The recipes at the JAX tests' CPU size: a 96px canvas, batch 8."""
    cfg.TPU.TRAIN_CANVAS = [canvas, canvas]
    cfg.TPU.EVAL_CANVAS = [canvas, canvas]
    cfg.INPUT.MIN_SIZE_TRAIN = [canvas]
    cfg.INPUT.MIN_SIZE_TEST = canvas
    cfg.INPUT.MAX_SIZE_TEST = canvas
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.OUTPUT_DIR = ""
    return cfg


def _train_test(runner, cfg):
    model = runner.build_model(cfg, init="train")
    model, state = runner.do_train(cfg, model)
    model.load_state_dict(runner.eval_params(cfg, state), strict=False)
    return runner.do_test(cfg, model)


def _registered(data):
    args = SimpleNamespace(data_root=data, hard=False)
    quality_loop.prepare_data(args)


@pytest.mark.slow
def test_fcos_meta_train_then_do_test_gets_real_ap(learnable):
    from sylph_tpu_torch.runner import MetaFCOSRunner

    _registered(learnable)
    runner = MetaFCOSRunner(device="cpu")
    cfg = quality_loop.build_fcos_cfg(runner, iters=100, lr=0.01)
    _shrink_for_cpu(cfg)
    cfg.TEST.REPEAT_TEST = 1
    cfg.freeze()
    bbox = _train_test(runner, cfg)["coco_meta_val_all"]["bbox"]
    assert bbox["AP50"] > 50.0, bbox


@pytest.mark.slow
def test_rcnn_meta_train_then_do_test_gets_real_ap(learnable):
    from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner

    _registered(learnable)
    runner = MetaFasterRCNNRunner(device="cpu")
    cfg = quality_loop.build_cfg(runner, iters=150, lr=0.01)
    _shrink_for_cpu(cfg)
    cfg.freeze()
    bbox = _train_test(runner, cfg)["coco_meta_val_all"]["bbox"]
    assert bbox["AP50"] > 50.0, bbox
    assert bbox["nAP"] > 20.0, bbox
    assert bbox["bAP"] > 20.0, bbox


@pytest.mark.slow
def test_roi_encoder_meta_train_then_do_test_gets_real_ap(learnable):
    from sylph_tpu_torch.runner import MetaFCOSROIEncoderRunner

    _registered(learnable)
    runner = MetaFCOSROIEncoderRunner(device="cpu")
    cfg = quality_loop.build_roi_encoder_cfg(runner, iters=150, lr=0.01)
    _shrink_for_cpu(cfg)
    cfg.freeze()
    bbox = _train_test(runner, cfg)["coco_meta_val_all"]["bbox"]
    assert bbox["AP50"] > 50.0, bbox
    assert bbox["nAP"] > 20.0, bbox
    assert bbox["bAP"] > 20.0, bbox


@pytest.mark.slow
def test_lvis_meta_train_then_federated_eval_gets_real_apr(tmp_path):
    from sylph_tpu_torch.data.catalog import (DatasetCatalog,
                                              MetadataCatalog,
                                              register_all_lvis)
    from sylph_tpu_torch.runner import MetaFCOSRunner

    lvis_root, coco_root = str(tmp_path / "lvis"), str(tmp_path / "img")
    make_learnable_lvis(lvis_root, coco_root, img_hw=(96, 96))
    DatasetCatalog.clear()
    MetadataCatalog.clear()
    register_all_lvis(lvis_root, coco_root)
    runner = MetaFCOSRunner(device="cpu")
    cfg = quality_loop.build_lvis_cfg(runner, iters=150, lr=0.01)
    _shrink_for_cpu(cfg)
    cfg.freeze()
    bbox = _train_test(runner, cfg)["lvis_meta_val_all"]["bbox"]
    assert bbox["AP50"] > 50.0, bbox
    assert bbox["APr"] > 20.0, bbox
    assert bbox["APf"] > 20.0, bbox


@pytest.mark.slow
def test_tfa_pretrain_surgery_finetune_gets_real_ap(learnable, tmp_path):
    args = _slow_args(tmp_path, learnable)
    quality_loop.prepare_data(args)
    bbox = quality_loop.run_tfa(args)["coco_pretrain_val_all"]["bbox"]
    assert bbox["AP50"] > 50.0, bbox
    assert bbox["nAP"] > 20.0, bbox
    assert bbox["bAP"] > 20.0, bbox


@pytest.mark.slow
def test_owd_pretrain_detects_unseen_categories(learnable, tmp_path):
    args = _slow_args(tmp_path, learnable)
    quality_loop.prepare_data(args)
    bbox = quality_loop.run_owd(args)["coco_pretrain_val_all"]["bbox"]
    assert bbox["AP50"] > 20.0, bbox
    assert bbox["AR@10"] > 35.0, bbox


@pytest.mark.slow
def test_heldout_novel_classes_detected_without_training(tmp_path):
    data = str(tmp_path / "hc")
    make_learnable_coco(data, n_train=120, n_val=32, img_hw=(96, 96),
                        n_empty_val=2, hard=True)
    args = _slow_args(tmp_path, data, iters=120, hard=True)
    quality_loop.prepare_data(args)
    results = quality_loop.run_fcos(args, heldout=True)
    novel = results["coco_meta_val_novel"]["bbox"]
    allb = results["coco_meta_val_all"]["bbox"]
    assert novel["AP50"] > 3.0, novel
    assert allb["bAP"] > 8.0, allb
    assert allb["nAP"] > 1.5, allb


@pytest.mark.slow
def test_tfa_rcnn_pretrain_surgery_frozen_finetune(learnable, tmp_path):
    args = _slow_args(tmp_path, learnable, iters=120)
    quality_loop.prepare_data(args)
    bbox = quality_loop.run_tfa_rcnn(args)["coco_pretrain_val_all"]["bbox"]
    assert bbox["AP50"] > 15.0, bbox
    assert bbox["nAP"] > 3.0, bbox
    assert bbox["bAP"] > 3.0, bbox


@pytest.mark.slow
def test_lvis_heldout_rare_classes_detected_without_training(tmp_path):
    args = _slow_args(tmp_path, str(tmp_path / "lvis_wheel"), iters=120)
    os.makedirs(args.data_root)
    bbox = quality_loop.run_lvis(args, heldout=True)["lvis_meta_val_all"][
        "bbox"]
    assert bbox["APr"] > 2.0, bbox
    assert bbox["APf"] > 25.0, bbox


# ------------------------------------------------ same-init trajectories
TRAJECTORY_STEPS = 50
# Per-step total loss, relative. The first EARLY_STEPS are held as the step
# tests hold one step: a wrong schedule, clip, freeze or data order shows
# there. After them the two packages' fp32 sums, in other orders, drift
# apart over the SGD steps. Measured, largest gap of the first 10 steps /
# of all 50, pretrain and finetune: with JAX's FrozenBN masked 1.5e-7 /
# 6.5e-3 (step 38) and 7.8e-6 / 7.0e-4; left to train as JAX's freeze rule
# has it 2.6e-6 / 8.8e-3-1.2e-2 (step 39; two runs) and 8.0e-6 / 2.1e-4.
EARLY_STEPS = 10
EARLY_RTOL = 1e-4
TRAJECTORY_RTOL = 2e-2
# Two-stage: the steps before the first near-tie flip (measured: within
# 6e-5 for 18 steps), then the mean of all 50 (measured: 3.0% apart).
TIED_STEPS = 15
MEAN_RTOL = 0.1


def _jax_losses(monkeypatch, jrunner_mod, mask_frozen_bn=True):
    """Record the JAX runner's per-iteration losses; with
    ``mask_frozen_bn``, JAX's FrozenBN held constant as the port's is
    (tests/torch_port_util.py::jax_tx), else JAX's own freeze rule."""
    from torch_port_util import jax_mask
    from sylph_tpu.train import optimizer as jopt
    import optax

    losses = []
    write = jrunner_mod.MetricsWriter.write

    def record(self, step, metrics, lr=None):
        losses.append(dict(metrics))
        return write(self, step, metrics, lr)

    def build_optimizer(params, **kw):
        fcfg = kw.pop("freeze_cfg")
        inner, schedule = jopt.build_optimizer(params, **kw)
        mask = jax_mask(params, fcfg)
        return optax.chain(
            optax.masked(optax.set_to_zero(),
                         jax.tree.map(lambda m: not m, mask)),
            optax.masked(inner, mask)), schedule

    monkeypatch.setattr(jrunner_mod.MetricsWriter, "write", record)
    if mask_frozen_bn:
        monkeypatch.setattr(jrunner_mod, "build_optimizer", build_optimizer)
    return losses


def _total(metrics):
    return [sum(v for k, v in m.items() if k.startswith("loss"))
            for m in metrics]


@pytest.mark.slow
@pytest.mark.parametrize("jax_frozen_bn", ["masked", "free"])
def test_heldout_stages_follow_jax_from_the_same_init(tmp_path,
                                                      monkeypatch,
                                                      jax_frozen_bn):
    """Both ``fcos_heldout`` stages, 50 steps each, from JAX's initial
    parameters on the same data: the JAX runner on its 8-device test mesh
    (one image or episode a device), the port with TPU.GRAD_ACCUM 8, the
    same 8 ranks. The finetune starts from JAX's trained pretrain in both.
    ``masked`` holds JAX's bottleneck FrozenBN constant, as the port does;
    ``free`` lets JAX train it in the pretrain (its freeze rule), so the
    gap it adds is measured (the finetune freezes the backbone in both)."""
    import quality_loop_variants as jql
    from sylph_tpu.data import catalog as jcatalog
    from sylph_tpu.runner import meta_fcos_runner as jrunner
    from sylph_tpu_torch.runner import MetaFCOSRunner
    from sylph_tpu_torch.train.checkpoint import merge_state_dict

    assert jax.device_count() == 8
    data = str(tmp_path / "hc")
    make_learnable_coco(data, n_train=120, n_val=32, img_hw=(96, 96),
                        n_empty_val=2, hard=True)
    jcatalog.DatasetCatalog.clear()
    jcatalog.MetadataCatalog.clear()
    jcatalog.register_all_coco(data)
    quality_loop.prepare_data(SimpleNamespace(data_root=data, hard=True))
    jax_losses = _jax_losses(monkeypatch, jrunner,
                             mask_frozen_bn=jax_frozen_bn == "masked")

    def stage_cfgs(weights):
        pair = []
        for mod, runner in ((jql, jrunner.MetaFCOSRunner()),
                            (quality_loop, MetaFCOSRunner(device="cpu"))):
            if weights is None:
                cfg = runner.get_default_cfg()
                cfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
                mod._common_shrink(cfg, TRAJECTORY_STEPS, 0.01, 96)
                cfg.MODEL.FCOS.NUM_CLASSES = 12
                cfg.DATASETS.TRAIN = ["coco_pretrain_train_base"]
            else:
                cfg = mod.build_fcos_cfg(runner, TRAJECTORY_STEPS, 0.01, 96)
                cfg.MODEL.WEIGHTS = weights
                cfg.MODEL.BACKBONE.FREEZE = True
                cfg.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = True
                cfg.DATASETS.TRAIN = ["coco_meta_train_base"]
                cfg.MODEL.META_LEARN.CLASS = 4
            cfg.OUTPUT_DIR = ""
            pair.append((runner, cfg))
        pair[1][1].TPU.GRAD_ACCUM = 8   # the JAX mesh's 8 ranks
        return pair

    weights = None
    for stage in ("pretrain", "finetune"):
        (jrun, jcfg), (trun, tcfg) = stage_cfgs(weights)
        jcfg.freeze()
        tcfg.freeze()
        jmodel, jparams = jrun.build_model(jcfg)
        model = trun.build_model(tcfg, init="train")
        loaded = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
        assert set(loaded) <= set(model.state_dict()), stage
        merge_state_dict(model, loaded)
        start = len(jax_losses)
        _, jstate = jrun.do_train(jcfg, jmodel, jparams)
        trun.do_train(tcfg, model)
        want = _total(jax_losses[start:])
        got = _total(trun.train_metrics)
        assert len(got) == len(want) == TRAJECTORY_STEPS, stage
        gap = np.abs(np.subtract(got, want)) / np.abs(want)
        print(f"{jax_frozen_bn} {stage}: largest gap "
              f"{gap[:EARLY_STEPS].max():.3e} in the first {EARLY_STEPS} "
              f"steps, {gap.max():.3e} (step {int(gap.argmax())}) in all, "
              f"mean {gap.mean():.3e}")
        np.testing.assert_allclose(got[:EARLY_STEPS], want[:EARLY_STEPS],
                                   rtol=EARLY_RTOL, err_msg=stage)
        np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL,
                                   err_msg=stage)
        js = jstate.unpack() if hasattr(jstate, "unpack") else jstate
        weights = str(tmp_path / f"{stage}.npz")
        np.savez(weights, **{k: np.asarray(v) for k, v in jql._flatten(
            jql.jax_to_py(js.params)).items()})


@pytest.mark.slow
def test_tfa_rcnn_finetune_follows_jax_from_the_same_init(tmp_path,
                                                          monkeypatch):
    """The ``tfa_rcnn`` finetune stage at 96x96 (the recipe's surgery,
    cosine head, backbone and box-head features frozen, RPN trainable),
    50 steps from one base-pretrain file on the same data: JAX on its
    8-device test mesh, the port with TPU.GRAD_ACCUM 8 and JAX's sampling
    keys replayed. Both make the same surgery from the file; the port then
    takes JAX's initial tree (the novel rows' draws). The steps agree to
    rounding until a near-tie among the proposals or the sampled ROIs
    falls the other way in one package (the two sum in other orders; at
    step 18 in this run); from there the runs are two samples of one
    process, held by their mean loss."""
    import quality_loop_variants as jql
    from sylph_tpu.data import catalog as jcatalog
    from sylph_tpu.runner import meta_faster_rcnn_runner as jrcnn
    from sylph_tpu_torch.meta_faster_rcnn_runner import TFAFasterRCNNRunner
    from sylph_tpu_torch.train.checkpoint import merge_state_dict

    from test_torch_rcnn_do_train import jax_do_train
    from torch_port_util import RCNN_GAINS, jax_draws

    data = str(tmp_path / "lc")
    make_learnable_coco(data, n_train=80, n_val=16, img_hw=(96, 96),
                        n_empty_val=2)
    jcatalog.DatasetCatalog.clear()
    jcatalog.MetadataCatalog.clear()
    jcatalog.register_all_coco(data)
    quality_loop.prepare_data(SimpleNamespace(data_root=data, hard=False))

    # the base pretrain's file: JAX's base-class model, seeded weights
    pre = jrcnn.MetaFasterRCNNRunner()
    pcfg = jql.build_tfa_rcnn_pretrain_cfg(pre, TRAJECTORY_STEPS, 0.01, 96)
    _, pparams = pre.build_model(pcfg)
    pparams = randomize(pparams, np.random.RandomState(11), RCNN_GAINS)
    weights = str(tmp_path / "base_pretrain.npz")
    np.savez(weights, **{k: np.asarray(v) for k, v in jql._flatten(
        jql.jax_to_py(pparams)).items()})

    jrun = jrcnn.TFAFasterRCNNRunner()
    jcfg = jql.build_tfa_rcnn_finetune_cfg(jrun, TRAJECTORY_STEPS, 0.005,
                                           weights, 96)
    jcfg.OUTPUT_DIR = ""
    jcfg.freeze()
    trun = TFAFasterRCNNRunner(device="cpu", draws=jax_draws(8))
    tcfg = quality_loop.build_tfa_rcnn_finetune_cfg(
        trun, TRAJECTORY_STEPS, 0.005, weights, 96)
    tcfg.OUTPUT_DIR = ""
    tcfg.TPU.GRAD_ACCUM = 8   # the JAX mesh's 8 ranks
    tcfg.freeze()

    jmodel, jparams = jrun.build_model(jcfg)
    model = trun.build_model(tcfg, init="train")
    loaded = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    own = model.state_dict()
    # rows from the file have unit scale, the novel rows' normal(0.01)
    # draws a norm near 0.1
    base_rows = [int(i) for i in np.nonzero(np.linalg.norm(np.asarray(
        loaded["box_head.cosine_weight"]), axis=-1) > 0.5)[0]]
    assert len(base_rows) == 4   # 3 base classes + background
    for i in base_rows:          # the same surgery on both sides
        assert torch.equal(own["box_head.cosine_weight"][i],
                           loaded["box_head.cosine_weight"][i]), i
    assert set(loaded) <= set(own)
    merge_state_dict(model, loaded)

    jax_losses, _ = jax_do_train(jrun, jcfg, jmodel, jparams, monkeypatch)
    trun.do_train(tcfg, model)
    want, got = _total(jax_losses), _total(trun.train_metrics)
    assert len(got) == len(want) == TRAJECTORY_STEPS
    np.testing.assert_allclose(got[:TIED_STEPS], want[:TIED_STEPS],
                               rtol=1e-3)
    np.testing.assert_allclose(np.mean(got), np.mean(want),
                               rtol=MEAN_RTOL)
