"""The port's quality-loop recipes against the JAX package's.

``sylph_tpu_torch/tools/quality_loop.py`` keeps its own copy of
``tools/quality_loop_variants.py`` and ``tools/quality_loop_rcnn.py``. Each
family is run here through both drivers with the runners stubbed out (no
model is built or trained): every stage's frozen config must dump equal in
the two packages, the port's ``setup_after_launch`` must write the
``config_diff.yaml`` JAX's writes, and that file must equal the recorded
recipe in ``artifacts/quality_loop*/``, apart from output and weight paths.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch
import yaml

from sylph_tpu_torch.tools import quality_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

# one recipe per artifact: the family and its flags
VARIANTS = {
    "fcos": dict(family="fcos", iters=400),
    "fcos_hard": dict(family="fcos", iters=400, hard=True, repeat_test=5),
    "fcos_heldout": dict(family="fcos_heldout", iters=600, hard=True),
    "roi_encoder": dict(family="roi_encoder", iters=400),
    "roi_encoder_refdepth": dict(family="roi_encoder", iters=400,
                                 ref_depth=True),
    "tfa": dict(family="tfa", iters=400),
    "tfa_rcnn": dict(family="tfa_rcnn", iters=400),
    "owd": dict(family="owd", iters=400),
    "lvis": dict(family="lvis", iters=400),
    "lvis_heldout": dict(family="lvis_heldout", iters=400),
    "rcnn": dict(family="rcnn", iters=400),
}
STAGES = {"fcos_heldout": 2, "tfa": 2, "tfa_rcnn": 2, "lvis_heldout": 2}
CASES = [(v, s) for v in VARIANTS for s in range(STAGES.get(v, 1))]

# artifact file -> (variant, stage)
ARTIFACTS = {
    "quality_loop/config_diff.yaml": ("fcos", 0),
    "quality_loop_hard/config_diff.yaml": ("fcos_hard", 0),
    "quality_loop_fcos_heldout/pretrain_config_diff.yaml":
        ("fcos_heldout", 0),
    "quality_loop_fcos_heldout/config_diff.yaml": ("fcos_heldout", 1),
    "quality_loop_roi_encoder/config_diff.yaml": ("roi_encoder", 0),
    "quality_loop_roi_encoder_refdepth/config_diff.yaml":
        ("roi_encoder_refdepth", 0),
    "quality_loop_tfa/finetune_config_diff.yaml": ("tfa", 1),
    "quality_loop_tfa_rcnn/config_diff.yaml": ("tfa_rcnn", 1),
    "quality_loop_owd/config_diff.yaml": ("owd", 0),
    "quality_loop_lvis/config_diff.yaml": ("lvis", 0),
    "quality_loop_lvis_heldout/config_diff.yaml": ("lvis_heldout", 1),
    "quality_loop_rcnn/config_diff.yaml": ("rcnn", 0),
}
# The oldest record predates two lines of today's recipe, in both drivers:
# _common_shrink's CHECKPOINT_PERIOD = 10 ** 9 (it was then MAX_ITER), and
# the finetune yaml's REFERENCE_WORLD_SIZE (every later record has it).
RECIPE_SINCE = {"quality_loop/config_diff.yaml": {
    ("SOLVER", "CHECKPOINT_PERIOD"): (400, 10 ** 9),
    ("SOLVER", "REFERENCE_WORLD_SIZE"): (None, 16)}}


class _Results(dict):
    """do_test's results for any dataset name."""

    def __missing__(self, key):
        return {"bbox": {"AP": 0.0}}


def _args(variant, root):
    kw = dict(hard=False, repeat_test=0, ref_depth=False, grad_accum=0,
              ref_world=0, iters=400, lr=0.01, canvas=128, device="cpu",
              data_root=os.path.join(root, "data"),
              output_dir=os.path.join(root, "out"))
    kw.update({k: v for k, v in VARIANTS[variant].items() if k != "family"})
    return SimpleNamespace(**kw)


def _jax_flow(variant, root, mp):
    """The JAX driver's stages: [(runner name, frozen cfg)]; each stage's
    launch files under its OUTPUT_DIR."""
    from sylph_tpu.data import catalog, synthetic
    from sylph_tpu.runner import meta_faster_rcnn_runner as jrcnn
    from sylph_tpu.runner import meta_fcos_runner as jfcos
    from sylph_tpu.utils import setup

    stages = []

    def build_model(self, cfg):
        stages.append((type(self).__name__, cfg))
        return None, {}

    for cls in (jfcos.MetaFCOSRunner, jfcos.MetaFCOSROIEncoderRunner,
                jfcos.TFAFewShotDetectionRunner, jrcnn.MetaFasterRCNNRunner,
                jrcnn.TFAFasterRCNNRunner):
        mp.setattr(cls, "build_model", build_model)
        mp.setattr(cls, "do_train", lambda self, cfg, model, params:
                   (None, None))
        mp.setattr(cls, "do_test", lambda self, cfg, model, params, **kw:
                   _Results())
    mp.setattr(jfcos.MetaFCOSRunner, "eval_params",
               staticmethod(lambda cfg, state: {}))
    mp.setattr(synthetic, "make_learnable_lvis", lambda *a, **k: None)
    mp.setattr(catalog, "register_all_lvis", lambda *a, **k: None)

    args = _args(variant, root)
    family = VARIANTS[variant]["family"]
    if family == "rcnn":
        import quality_loop_rcnn
        runner = jrcnn.MetaFasterRCNNRunner()
        cfg = quality_loop_rcnn.build_cfg(runner, args.iters, args.lr)
        cfg.OUTPUT_DIR = args.output_dir
        cfg.freeze()
        setup.setup_after_launch(cfg, cfg.OUTPUT_DIR,
                                 default_cfg=runner.get_default_cfg())
        stages.append((type(runner).__name__, cfg))
        return stages
    import quality_loop_variants as ql
    run = {"fcos": ql.run_fcos,
           "fcos_heldout": lambda a: ql.run_fcos(a, heldout=True),
           "roi_encoder": ql.run_roi_encoder, "tfa": ql.run_tfa,
           "tfa_rcnn": ql.run_tfa_rcnn, "owd": ql.run_owd,
           "lvis": ql.run_lvis,
           "lvis_heldout": lambda a: ql.run_lvis(a, heldout=True)}[family]
    os.makedirs(args.output_dir, exist_ok=True)
    run(args)
    return stages


def _port_flow(variant, root, mp):
    stages = []

    def train_and_test(runner, cfg, args, stage):
        stages.append((type(runner).__name__, cfg))
        quality_loop.setup_after_launch(
            cfg, cfg.OUTPUT_DIR, default_cfg=runner.get_default_cfg())
        return _Results(), torch.nn.Module()

    mp.setattr(quality_loop, "_train_and_test", train_and_test)
    mp.setattr(quality_loop, "make_learnable_lvis", lambda *a, **k: None)
    mp.setattr(quality_loop, "register_all_lvis", lambda *a, **k: None)
    args = _args(variant, root)
    os.makedirs(args.output_dir, exist_ok=True)
    quality_loop.RUNS[VARIANTS[variant]["family"]](args)
    return stages


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """variant -> (JAX stages, port stages, JAX root, port root), each
    variant run once through both drivers."""
    cache = {}

    def get(variant):
        if variant not in cache:
            jroot = str(tmp_path_factory.mktemp(f"jax_{variant}"))
            troot = str(tmp_path_factory.mktemp(f"port_{variant}"))
            with pytest.MonkeyPatch.context() as mp:
                jax_stages = _jax_flow(variant, jroot, mp)
            with pytest.MonkeyPatch.context() as mp:
                port_stages = _port_flow(variant, troot, mp)
            cache[variant] = (jax_stages, port_stages, jroot, troot)
        return cache[variant]

    return get


def _without_paths(diff):
    diff = dict(diff)
    diff.pop("OUTPUT_DIR", None)
    model = dict(diff.get("MODEL", {}))
    model.pop("WEIGHTS", None)
    diff["MODEL"] = model
    return diff


@pytest.mark.parametrize("variant,stage", CASES)
def test_stage_config_equals_jax(flows, variant, stage):
    jax_stages, port_stages, jroot, troot = flows(variant)
    assert len(port_stages) == len(jax_stages) == STAGES.get(variant, 1)
    (jname, jcfg), (tname, tcfg) = jax_stages[stage], port_stages[stage]
    assert tname == jname
    assert tcfg.dump().replace(troot, "<root>") == \
        jcfg.dump().replace(jroot, "<root>")
    for fname in ("config.yaml", "config_diff.yaml"):
        with open(os.path.join(tcfg.OUTPUT_DIR, fname)) as f:
            got = f.read().replace(troot, "<root>")
        with open(os.path.join(jcfg.OUTPUT_DIR, fname)) as f:
            want = f.read().replace(jroot, "<root>")
        assert yaml.safe_load(got) == yaml.safe_load(want), fname


@pytest.mark.parametrize("artifact", sorted(ARTIFACTS))
def test_config_diff_equals_recorded_recipe(flows, artifact):
    variant, stage = ARTIFACTS[artifact]
    _, port_stages, _, _ = flows(variant)
    with open(os.path.join(port_stages[stage][1].OUTPUT_DIR,
                           "config_diff.yaml")) as f:
        got = _without_paths(yaml.safe_load(f))
    with open(os.path.join(REPO, "artifacts", artifact)) as f:
        want = _without_paths(yaml.safe_load(f))
    for (section, key), (then, now) in RECIPE_SINCE.get(artifact,
                                                        {}).items():
        assert want[section].get(key) == then and got[section][key] == now
        got[section].pop(key)
        want[section].pop(key, None)
    assert got == want


def test_lvis_set_rebuilt_for_the_other_family(tmp_path, monkeypatch,
                                               capsys):
    """A leftover LVIS json with the other family's class count is
    rebuilt, with the held-out family's wheel arguments."""
    import json

    built = []
    monkeypatch.setattr(quality_loop, "make_learnable_lvis",
                        lambda *a, **k: built.append((a, k)))
    monkeypatch.setattr(quality_loop, "register_all_lvis",
                        lambda *a, **k: None)
    lvis = tmp_path / "data" / "lvis"
    lvis.mkdir(parents=True)
    with open(lvis / "lvis_v1_train.json", "w") as f:
        json.dump({"categories": [{"id": i} for i in range(6)]}, f)
    args = SimpleNamespace(data_root=str(tmp_path / "data"))
    quality_loop._lvis_data(args, heldout=False)   # 6 classes: kept
    assert built == []
    quality_loop._lvis_data(args, heldout=True)    # needs 18: rebuilt
    assert built == [((str(lvis), str(tmp_path / "data")),
                      dict(n_train=180, n_val=45, wheel=True))]
    assert "existing json has 6 categories" in capsys.readouterr().out


def test_driver_refuses_the_default_device_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quality_loop.main(["--family", "fcos", "--data-root",
                           str(tmp_path / "data")])
    assert not (tmp_path / "data").exists()
