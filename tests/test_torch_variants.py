"""The one-stage variants' entry points in the port (CPU, fp32):

  * ``create_runner`` builds all five runners by name (dotted names too),
    with the variants' default configs;
  * the shipped configs of the variants build on the CPU at full size: the
    COCO TFA finetune, the COCO and LVIS ROIEncoder finetunes, and the
    Meta-FCOS finetune with DCNv2 towers;
  * ``SylphPredictor`` with ``MetaFCOSROIEncoderRunner`` (register, then
    serve: the bank holds the ROIEncoder's codes as they come, with no
    normalization) and with ``TFAFewShotDetectionRunner`` (the cosine head's
    ``detect_base``) equal to the JAX predictor on the same weights.
"""

import numpy as np
import pytest
import torch

from sylph_tpu.predictor import SylphPredictor as JaxPredictor
from sylph_tpu_torch.meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                                     TFAFasterRCNNRunner)
from sylph_tpu_torch.predictor import SylphPredictor
from sylph_tpu_torch.runner import (MetaFCOSROIEncoderRunner, MetaFCOSRunner,
                                    TFAFewShotDetectionRunner, create_runner)

from test_torch_serving import assert_detections_match
from torch_port_util import few_torch_threads, tiny_model_pair  # noqa: F401

NAMES = {"MetaFCOSRunner": MetaFCOSRunner,
         "MetaFCOSROIEncoderRunner": MetaFCOSROIEncoderRunner,
         "TFAFewShotDetectionRunner": TFAFewShotDetectionRunner,
         "MetaFasterRCNNRunner": MetaFasterRCNNRunner,
         "TFAFasterRCNNRunner": TFAFasterRCNNRunner}
# the serving slice's tolerance (tests/test_torch_serving.py)
TOL = dict(rtol=1e-3, atol=5e-3)


def test_create_runner_builds_every_name():
    for name, cls in NAMES.items():
        for key in (name, f"sylph.runner.{name}"):
            assert type(create_runner(key, device="cpu")) is cls
    cfg = MetaFCOSROIEncoderRunner.get_default_cfg()
    assert cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME == "ROIEncoder"
    cfg = TFAFewShotDetectionRunner.get_default_cfg()
    assert not cfg.MODEL.META_LEARN.EPISODIC_LEARNING
    assert cfg.MODEL.TFA.FINETINE
    with pytest.raises(KeyError):
        create_runner("NoSuchRunner", device="cpu")


SHIPPED = {
    "tfa": ("TFAFewShotDetectionRunner",
            "sylph://COCO-Detection/TFA/tfa-finetune.yaml", {}),
    "tfa_cosine": ("TFAFewShotDetectionRunner",
                   "sylph://COCO-Detection/TFA/tfa-finetune.yaml",
                   {"MODEL.FCOS.L2_NORM_CLS_WEIGHT": True}),
    "roi_encoder_coco": (
        "MetaFCOSROIEncoderRunner",
        "sylph://COCO-Detection/Meta-FCOS-ROIEncoder/Meta-FCOS-finetune.yaml",
        {}),
    "roi_encoder_lvis": (
        "MetaFCOSROIEncoderRunner",
        "sylph://LVISv1-Detection/Meta-FCOS/"
        "Meta-FCOS-ROI-Encoder-finetune.yaml", {}),
    "dcn": ("MetaFCOSRunner",
            "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml",
            {"MODEL.FCOS.USE_DEFORMABLE": True}),
}


@pytest.mark.parametrize("case", sorted(SHIPPED))
def test_shipped_configs_build_on_the_cpu(case):
    """R-50 at full width, every parameter and buffer finite."""
    name, config, opts = SHIPPED[case]
    runner = create_runner(name, device="cpu")
    cfg = runner.get_default_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    model = runner.build_model(cfg)
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())
    head = model.fcos_head
    if case == "tfa_cosine":
        assert not hasattr(head, "cls_logits") and head.l2_norm_cls_weight
    if case.startswith("roi_encoder"):
        assert type(model.code_generator).__name__ == "ROIEncoder"
    if case == "dcn":
        assert type(head.cls_tower.conv3).__name__ == "DFConv2d"


def _roi_encoder(cfg):
    cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"


def _tfa_cosine(cfg):
    cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = True
    cfg.MODEL.TFA.FINETINE = True


def _image(rng, h, w):
    mean = np.array([123.675, 116.280, 103.530], np.float32)  # RGB
    return np.clip(mean + 30 * rng.randn(h, w, 3), 0, 255).astype(np.uint8)


def test_roi_encoder_predictor_matches_jax():
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(
        seed=8, tweak=_roi_encoder)
    name = "MetaFCOSROIEncoderRunner"
    jpred = JaxPredictor(cfg=jcfg, model=jmodel, params=params,
                         runner_name=name, max_classes=8)
    tpred = SylphPredictor(cfg=tcfg, model=tmodel, runner_name=name,
                           max_classes=8, device="cpu")
    rng = np.random.RandomState(3)
    for cname in ("widget", "gadget"):
        imgs = [_image(rng, 150, 120), _image(rng, 90, 140)]
        bxs = [np.array([10, 12, 100, 130], np.float32),
               np.array([20, 5, 120, 80], np.float32)]
        assert jpred.register_class(cname, imgs, bxs) == \
            tpred.register_class(cname, imgs, bxs)
    np.testing.assert_allclose(tpred.bank.conv.numpy(),
                               np.asarray(jpred.bank.conv), **TOL)
    np.testing.assert_allclose(tpred.bank.bias.numpy(),
                               np.asarray(jpred.bank.bias), **TOL)
    image = _image(rng, 100, 150)
    want, got = jpred(image), tpred(image)
    assert got["class_names"] == want["class_names"]
    assert_detections_match(
        dict(got, valid=np.ones(len(got["scores"]), bool)),
        dict(want, valid=np.ones(len(want["scores"]), bool)))


def test_tfa_cosine_predictor_matches_jax():
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(
        episodic=False, seed=9, tweak=_tfa_cosine)
    name = "TFAFewShotDetectionRunner"
    jpred = JaxPredictor(cfg=jcfg, model=jmodel, params=params,
                         runner_name=name, max_classes=8)
    tpred = SylphPredictor(cfg=tcfg, model=tmodel, runner_name=name,
                           max_classes=8, device="cpu")
    image = _image(np.random.RandomState(4), 110, 150)
    want, got = jpred.detect_base(image), tpred.detect_base(image)
    n = np.ones(len(got["scores"]), bool)
    assert_detections_match(dict(got, valid=n),
                            dict(want, valid=np.ones(len(want["scores"]),
                                                     bool)))


def test_visualize_episode_equals_jax(tmp_path):
    """The port's episode PNG (from tensors) is pixel for pixel JAX's (from
    numpy arrays)."""
    from PIL import Image

    from sylph_tpu.evaluation.visualization import visualize_episode as jvis
    from sylph_tpu_torch.evaluation.visualization import visualize_episode

    rng = np.random.RandomState(0)
    batch = {
        "support_images": rng.rand(2, 64, 64, 3).astype(np.float32) * 255,
        "support_boxes": np.tile(np.array([[8, 8, 40, 44.0]], np.float32),
                                 (2, 1)),
        "query_images": rng.rand(1, 96, 96, 3).astype(np.float32) * 255,
        "query_gt_boxes": np.array([[[10, 10, 50, 60.0], [0, 0, 0, 0]]],
                                   np.float32),
        "query_gt_valid": np.array([[True, False]])}
    want = jvis(batch, str(tmp_path / "j" / "ep.png"), num_shots=2)
    got = visualize_episode({k: torch.from_numpy(v) for k, v in
                             batch.items()}, str(tmp_path / "t" / "ep.png"),
                            num_shots=2)
    np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                  np.asarray(Image.open(want)))


@pytest.mark.parametrize("runner", ["MetaFCOSRunner",
                                    "MetaFCOSROIEncoderRunner"])
def test_demo_inference_runs_on_the_cpu(runner, capsys):
    from sylph_tpu_torch.tools.demo_inference import main

    out = main(["--depth", "18", "--canvas", "160", "--shots", "2",
                "--runner", runner, "--device", "cpu"])
    assert set(out["class_names"]) <= {"red-widget"}
    assert np.isfinite(out["boxes"]).all()
    assert "warm query" in capsys.readouterr().out
