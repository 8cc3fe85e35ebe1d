"""The port's two-stage runner against the JAX package's (CPU, fp32):
``MetaFasterRCNNRunner.do_test`` in its episodic mode (class registration,
then the two-stage query path through ``make_rcnn_infer``) on a tiny
synthetic LVIS tree, each query batch's detections and every
``eval_results`` key against JAX's; the configs; ``create_runner``; and
the refusals without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from sylph_tpu.runner.meta_faster_rcnn_runner import \
    MetaFasterRCNNRunner as JaxRunner
from sylph_tpu.runner.meta_faster_rcnn_runner import \
    TFAFasterRCNNRunner as JaxTFARunner
from sylph_tpu_torch.meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                                     TFAFasterRCNNRunner)

from torch_port_util import (assert_results_close, few_torch_threads,  # noqa: F401
                             rcnn_pair)


def register_lvis_both(tmp_path, n_val=6):
    """One synthetic LVIS tree (2 frequent + 2 rare classes, 64x96 images)
    registered in both packages' catalogs."""
    from sylph_tpu.data import catalog as jax_catalog
    from sylph_tpu_torch.data import catalog
    from sylph_tpu_torch.data.synthetic import make_synthetic_lvis

    lvis, coco = str(tmp_path / "lvis"), str(tmp_path / "coco")
    make_synthetic_lvis(lvis, coco, n_train=12, n_val=n_val)
    for cat in (jax_catalog, catalog):
        cat.DatasetCatalog.clear()
        cat.MetadataCatalog.clear()
        cat.register_all_lvis(lvis, coco)


def recording_infer(monkeypatch, module):
    """Replaces ``module.make_rcnn_infer`` with one whose infer functions
    append each query batch's detections (boxes, scores, classes, valid as
    numpy) to the list returned."""
    dets, make = [], module.make_rcnn_infer

    def make_recording(*args, **kwargs):
        infer = make(*args, **kwargs)

        def recording(*a):
            det = infer(*a)
            dets.append(SimpleNamespace(**{
                f: np.asarray(getattr(det, f))
                for f in ("boxes", "scores", "classes", "valid")}))
            return det

        return recording

    monkeypatch.setattr(module, "make_rcnn_infer", make_recording)
    return dets


def test_meta_test_do_test_matches_jax(tmp_path, monkeypatch):
    """lvis_meta_val_novelr (the rare classes): 2-shot registration, then
    6 query images in batches of 2 through the two-stage path. Each query
    batch's detections hold against JAX's (boxes 1e-3, scores 1e-4,
    classes and valid equal), and so does the AP dict."""
    from sylph_tpu.evaluation import meta_eval as jax_meta_eval
    from sylph_tpu_torch.evaluation import meta_eval

    register_lvis_both(tmp_path)
    jcfg, jmodel, params, tcfg, tmodel = rcnn_pair(episodic=True, seed=1)
    for cfg in (jcfg, tcfg):
        cfg.DATASETS.TEST = ["lvis_meta_val_novelr"]
    want_dets = recording_infer(monkeypatch, jax_meta_eval)
    got_dets = recording_infer(monkeypatch, meta_eval)
    want = JaxRunner().do_test(jcfg, jmodel, params)
    runner = MetaFasterRCNNRunner(device="cpu")
    got = runner.do_test(tcfg, tmodel)
    name = "lvis_meta_val_novelr"
    assert_results_close(got[name]["bbox"], want[name]["bbox"])
    st = runner.drivers[name].stats
    assert st["classes"] == 2 and st["query_batches"] == 3
    assert runner.drivers[name].bank["cls_conv"].shape == (2, 64)
    assert np.isfinite(got[name]["bbox"]["AP"])
    assert len(got_dets) == len(want_dets) >= 3
    for g, w in zip(got_dets, want_dets):
        np.testing.assert_array_equal(g.valid, w.valid)
        np.testing.assert_array_equal(g.classes[g.valid], w.classes[w.valid])
        np.testing.assert_allclose(g.boxes[g.valid], w.boxes[w.valid],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-4)
    assert sum(int(g.valid.sum()) for g in got_dets) > 0


@pytest.mark.parametrize("tfa", [False, True])
def test_default_cfg_equals_jax(tfa):
    """The two-stage runners' default configs, key for key."""
    port = (TFAFasterRCNNRunner if tfa else MetaFasterRCNNRunner)
    jax_ = JaxTFARunner if tfa else JaxRunner
    got = yaml.safe_load(port.get_default_cfg().dump())
    want = yaml.safe_load(jax_.get_default_cfg().dump())
    assert got == want
    assert got["MODEL"]["TFA"]["FINETINE"] is tfa
    assert got["MODEL"]["ROI_BOX_HEAD"]["FC_DIM"] == 1024


def test_create_runner_and_refusals():
    """Both two-stage names (dotted too) build on the CPU, and so do the
    one-stage variants; without a card every two-stage entry point,
    ``do_train`` included, refuses the default device."""
    from sylph_tpu_torch.evaluation.meta_eval import make_rcnn_infer
    from sylph_tpu_torch.models.rcnn import build_anchor_grid
    from sylph_tpu_torch.runner import create_runner

    assert type(create_runner("MetaFasterRCNNRunner", device="cpu")) \
        is MetaFasterRCNNRunner
    assert type(create_runner("sylph.runner.TFAFasterRCNNRunner",
                              device="cpu")) is TFAFasterRCNNRunner
    for name in ("MetaFCOSROIEncoderRunner", "TFAFewShotDetectionRunner"):
        assert type(create_runner(name, device="cpu")).__name__ == name
    if torch.cuda.is_available():
        return
    for make in (MetaFasterRCNNRunner, TFAFasterRCNNRunner,
                 lambda: create_runner("MetaFasterRCNNRunner")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the two-stage do_train refuses the default device without a card
    cfg = MetaFasterRCNNRunner.get_default_cfg()
    for train in (lambda: MetaFasterRCNNRunner().do_train(cfg),
                  lambda: create_runner("TFAFasterRCNNRunner").do_train(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train()
    bank = {"cls_conv": np.zeros((2, 64), np.float32),
            "cls_bias": np.zeros((2,), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_rcnn_infer(None, bank, build_anchor_grid((64, 96)))
