"""The port's evaluation layer against the JAX package's (host numpy).

On the same seeded ground truth and random detections, the port's
``COCOEval`` (native matcher and its numpy twin), its four evaluators and
``detections_to_coco_results`` give exactly the JAX package's dicts and
lists (NaN where JAX has NaN). The native matcher equals its numpy twin on
random IoU matrices with crowd and ignored ground truth, and a failed
``g++`` build raises instead of falling back. ``MetaFCOSRunner.get_evaluator``
dispatches every evaluator type as the JAX runner does.
"""

import math

import numpy as np
import pytest

from sylph_tpu.evaluation.coco_eval_np import COCOEval as JaxCOCOEval
from sylph_tpu.evaluation.coco_eval_np import \
    DetEvalInputs as JaxDetEvalInputs
from sylph_tpu.evaluation.evaluators import \
    AREvaluator as JaxAREvaluator
from sylph_tpu.evaluation.evaluators import \
    COCOMetaEvaluator as JaxCOCOMetaEvaluator
from sylph_tpu.evaluation.evaluators import \
    COCOOWDEvaluator as JaxCOCOOWDEvaluator
from sylph_tpu.evaluation.evaluators import \
    FewshotLVISEvaluator as JaxLVISEvaluator
from sylph_tpu.evaluation.postprocess import \
    detections_to_coco_results as jax_to_coco
from sylph_tpu.runner.meta_fcos_runner import MetaFCOSRunner as JaxRunner
from sylph_tpu.structures import Detections as JaxDetections
from sylph_tpu_torch.evaluation import _native
from sylph_tpu_torch.evaluation.coco_eval_np import (COCOEval,
                                                     DetEvalInputs,
                                                     match_greedy_reference)
from sylph_tpu_torch.evaluation.evaluators import (AREvaluator,
                                                   COCOMetaEvaluator,
                                                   COCOOWDEvaluator,
                                                   FewshotLVISEvaluator)
from sylph_tpu_torch.evaluation.postprocess import \
    detections_to_coco_results
from sylph_tpu_torch.runner import MetaFCOSRunner
from sylph_tpu_torch.structures import Detections

DATASET_IDS = [1, 2, 3, 8, 10, 11]
ID_MAP = {d: i for i, d in enumerate(DATASET_IDS)}
METADATA = {"thing_classes": [f"cat{d}" for d in DATASET_IDS],
            "thing_dataset_id_to_contiguous_id": ID_MAP,
            "novel_dataset_ids": [1, 2, 3]}


def make_records(rng, n_img=12, lvis=False):
    """Query records (contiguous ids, XYWH) with crowd GT, GT-free images
    and, for LVIS, federated negatives and not-exhaustive flags."""
    records = []
    for i in range(n_img):
        anns = []
        for _ in range(rng.randint(0, 5) if i < n_img - 2 else 0):
            w, h = rng.uniform(4, 150, 2)
            anns.append({"bbox": [float(rng.uniform(0, 300)),
                                  float(rng.uniform(0, 200)),
                                  float(w), float(h)],
                         "category_id": int(rng.randint(len(DATASET_IDS))),
                         "iscrowd": int(not lvis and rng.rand() < 0.1)})
        rec = {"image_id": 100 + i, "annotations": anns}
        if lvis:
            rec["neg_category_ids"] = [d for d in DATASET_IDS
                                       if rng.rand() < 0.5]
            rec["not_exhaustive_category_ids"] = (
                [DATASET_IDS[rng.randint(6)]] if i % 3 == 0 else [])
        records.append(rec)
    return records


def make_dets(rng, records, n_extra=4):
    """Jittered copies of the GT plus false positives, dataset ids."""
    dets = []
    for rec in records:
        for a in rec["annotations"]:
            if rng.rand() < 0.8:
                x, y, w, h = a["bbox"]
                jit = rng.normal(0, 0.1, 4) * [w, h, w, h]
                dets.append({"image_id": rec["image_id"],
                             "category_id": DATASET_IDS[a["category_id"]],
                             "bbox": [float(x + jit[0]), float(y + jit[1]),
                                      float(abs(w + jit[2])),
                                      float(abs(h + jit[3]))],
                             "score": float(rng.rand())})
        for _ in range(rng.randint(0, n_extra)):
            dets.append({"image_id": rec["image_id"],
                         "category_id": DATASET_IDS[rng.randint(6)],
                         "bbox": [float(v) for v in
                                  rng.uniform(0, 200, 4)],
                         "score": float(rng.rand())})
    return dets


def assert_same(got, want):
    """Equal dicts, floats compared exactly with NaN == NaN."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_same(g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert g == w, k


def coco_inputs(seed, lvis=False):
    rng = np.random.RandomState(seed)
    records = make_records(rng, lvis=lvis)
    return records, make_dets(rng, records)


@pytest.mark.parametrize("impl", [None, "reference"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_matches_jax(seed, impl):
    records, dets = coco_inputs(seed)
    gts = [{"image_id": r["image_id"],
            "category_id": DATASET_IDS[a["category_id"]],
            "bbox": a["bbox"], "iscrowd": a["iscrowd"]}
           for r in records for a in r["annotations"]]
    ids = [r["image_id"] for r in records]
    want = JaxCOCOEval(JaxDetEvalInputs(gts, dets, ids, DATASET_IDS),
                       max_dets=(1, 10, 100)).results()
    got = COCOEval(DetEvalInputs(gts, dets, ids, DATASET_IDS),
                   max_dets=(1, 10, 100), impl=impl).results()
    assert_same(got, want)
    assert 0 < got["AP"] < 100


@pytest.mark.parametrize("kind", ["meta", "meta_all", "ar", "owd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_evaluators_match_jax(kind, seed):
    records, dets = coco_inputs(seed)
    novel = [1, 2, 3] if kind in ("meta_all", "ar") else None
    pairs = {
        "meta": (COCOMetaEvaluator, JaxCOCOMetaEvaluator),
        "meta_all": (COCOMetaEvaluator, JaxCOCOMetaEvaluator),
        "ar": (AREvaluator, JaxAREvaluator),
        "owd": (COCOOWDEvaluator, JaxCOCOOWDEvaluator),
    }
    ours, theirs = pairs[kind]
    kw = {} if kind == "owd" else dict(novel_dataset_ids=novel)
    got_ev, want_ev = ours(records, METADATA, **kw), theirs(records,
                                                            METADATA, **kw)
    for ev in (got_ev, want_ev):
        ev.process(dets[:len(dets) // 2])
        ev.process(dets[len(dets) // 2:])
    got, want = got_ev.evaluate(), want_ev.evaluate()
    assert_same(got, want)
    if novel:
        assert {"nAP", "bAP"} <= set(got["bbox"])


@pytest.mark.parametrize("seed", [0, 1])
def test_lvis_evaluator_matches_jax(seed):
    records, dets = coco_inputs(seed, lvis=True)
    cats = [{"id": d, "frequency": "rfc"[i % 3]}
            for i, d in enumerate(DATASET_IDS)]
    got_ev = FewshotLVISEvaluator(records, METADATA, categories=cats,
                                  max_dets=300)
    want_ev = JaxLVISEvaluator(records, METADATA, categories=cats,
                               max_dets=300)
    got_ev.process(dets)
    want_ev.process(dets)
    got = got_ev.evaluate()
    assert_same(got, want_ev.evaluate())
    assert {"APr", "APc", "APf"} <= set(got["bbox"])


def test_detections_to_coco_results_matches_jax():
    rng = np.random.RandomState(0)
    b, k = 4, 30
    xy = rng.uniform(-20, 150, (b, k, 2))
    wh = rng.uniform(-5, 60, (b, k, 2))
    fields = dict(
        boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        scores=rng.rand(b, k).astype(np.float32),
        classes=rng.randint(0, 6, (b, k)).astype(np.int32),
        valid=rng.rand(b, k) > 0.3,
        locations=np.zeros((b, k, 2), np.float32),
        fpn_levels=np.zeros((b, k), np.int32))
    args = ([7, 8, 9, 9], np.array([[120, 160], [100, 133], [128, 90],
                                    [128, 90]]),
            np.array([[480, 640], [300, 400], [512, 360], [512, 360]]),
            {v: d for d, v in ID_MAP.items()})
    kw = dict(batch_valid=np.array([True, True, True, False]),
              score_thresh=0.1)
    got = detections_to_coco_results(Detections(**fields), *args, **kw)
    want = jax_to_coco(JaxDetections(**fields), *args, **kw)
    assert got == want and len(got) > 20


@pytest.mark.parametrize("nd,ng", [(0, 3), (4, 0), (1, 1), (7, 5),
                                   (30, 12), (60, 40)])
def test_native_matcher_equals_numpy_twin(nd, ng):
    rng = np.random.RandomState(nd * 100 + ng)
    thrs = np.round(np.arange(0.5, 0.955, 0.05), 2)
    ious = rng.rand(nd, ng) * rng.choice([0.6, 1.0], (nd, ng))
    ious[rng.rand(nd, ng) < 0.3] = 0.0
    if nd and ng:
        ious[0, 0] = 0.75  # exactly on a threshold
    ignore = np.sort(rng.rand(ng) < 0.3)  # ignored GT last, as sorted
    crowd = ignore & (rng.rand(ng) < 0.5)
    got_m, got_ig = _native.match_greedy(ious, ignore, crowd, thrs)
    want_m, want_ig = match_greedy_reference(ious, ignore, crowd, thrs)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_ig, want_ig)
    assert got_m.shape == (len(thrs), nd)


def test_failed_matcher_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.match_greedy(np.ones((1, 1)), np.zeros(1, bool),
                             np.zeros(1, bool), np.array([0.5]))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        COCOEval(DetEvalInputs(
            [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 5, 5]}],
            [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 5, 5],
              "score": 0.5}], [1], [1])).results()


def test_unknown_matcher_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        COCOEval(DetEvalInputs([], [], [], []), impl="numpy")


@pytest.mark.parametrize("owd", [False, True])
@pytest.mark.parametrize("name,meta", [
    ("coco_meta_val_novel", dict(METADATA, split="novel",
                                 evaluator_type="coco_meta_learn")),
    ("coco_meta_val_all", dict(METADATA, split="all",
                               evaluator_type="coco_meta_learn")),
    ("coco_pretrain_val_all", dict(METADATA, split="all",
                                   evaluator_type="coco")),
    ("lvis_meta_val_novelr", dict(METADATA, split="novelr",
                                  evaluator_type="lvis_meta_learn",
                                  categories=[{"id": d, "frequency": "r"}
                                              for d in DATASET_IDS])),
    ("tao_meta_val", {k: v for k, v in METADATA.items()}),
])
def test_evaluator_dispatch_matches_jax(name, meta, owd):
    """``MetaFCOSRunner.get_evaluator`` picks the JAX runner's evaluator
    class for every evaluator type, and both give the same results."""
    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu_torch import get_default_cfg

    records, dets = coco_inputs(3, lvis=name.startswith("lvis"))
    jcfg, tcfg = jax_default_cfg(), get_default_cfg()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.PROPOSAL_GENERATOR.OWD = owd
    got_ev = MetaFCOSRunner("cpu").get_evaluator(tcfg, name, records, meta)
    want_ev = JaxRunner().get_evaluator(jcfg, name, records, meta)
    assert type(got_ev).__name__ == type(want_ev).__name__
    got_ev.process(dets)
    want_ev.process(dets)
    assert_same(got_ev.evaluate(), want_ev.evaluate())
