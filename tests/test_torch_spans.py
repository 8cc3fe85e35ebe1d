"""The port's spans (``sylph_tpu_torch/utils/spans.py``) on the CPU: one
shared null context with no profiler on; under ``torch.profiler`` (all
threads recorded) the spans of the query and registration paths, the
worker thread's copies paired with the main thread's takes, and the
nesting the readers' self times rely on; the ``stats`` timers, whose keys
and counts are unchanged and whose times are the spans' own. Toy R-18
detectors at 64 x 96, float32, random weights."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sylph_tpu_torch.evaluation import meta_eval
from sylph_tpu_torch.meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                                     eval_anchor_grid)
from sylph_tpu_torch.parallel.mesh import DataGroup
from sylph_tpu_torch.runner import MetaFCOSRunner, _decode_cfg, _eval_grid
from sylph_tpu_torch.utils import spans

YAML = {"fcos": "sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml",
        "rcnn": "sylph://LVISv1-Detection/Meta-RCNN/"
                "Meta-RCNN-FPN-finetune.yaml"}
RUNNER = {"fcos": MetaFCOSRunner, "rcnn": MetaFasterRCNNRunner}
TOY = ["MODEL.RESNETS.DEPTH", 18, "TPU.EVAL_CANVAS", [64, 96],
       "TPU.SUPPORT_CANVAS", [64, 64], "TPU.COMPUTE_DTYPE", "float32"]
TOY_RCNN = ["MODEL.RPN.POST_NMS_TOPK_TEST", 40,
            "MODEL.RPN.PRE_NMS_TOPK_TEST", 60]
BATCHES, BATCH, CODES = 3, 2, 6
CLASSES, CLASS_BATCH, SHOT = 5, 2, 2
CLOCKS_S = 1e-4  # the profiler's clock against time.perf_counter


class _Sink:
    def process(self, results):
        pass

    def evaluate(self):
        return {}


@pytest.fixture(scope="module")
def toy():
    """{family: (detector, merged config)}."""
    torch.manual_seed(0)
    out = {}
    for fam, cls in RUNNER.items():
        cfg = cls.get_default_cfg()
        cfg.merge_from_file(YAML[fam])
        cfg.merge_from_list(TOY + (TOY_RCNN if fam == "rcnn" else []))
        out[fam] = (cls(device="cpu").build_model(cfg).eval(), cfg)
    return out


def _bank(cfg):
    rng = np.random.RandomState(1)
    width = cfg.MODEL.META_LEARN.CODE_GENERATOR.OUT_CHANNEL
    return {"cls_conv": 0.2 * rng.randn(CODES, width).astype(np.float32),
            "cls_bias": np.zeros((CODES,), np.float32)}


def _queries(n=BATCHES):
    rng = np.random.RandomState(2)
    sizes = np.tile(np.array([[64, 96]], np.int64), (BATCH, 1))
    return [{"images": rng.randint(0, 256, (BATCH, 64, 96, 3), np.uint8),
             "image_sizes": sizes, "orig_sizes": sizes,
             "image_ids": np.arange(i * BATCH, (i + 1) * BATCH),
             "batch_valid": np.ones((BATCH,), bool)} for i in range(n)]


def _supports():
    rng = np.random.RandomState(3)
    box = np.array([8.0, 8.0, 48.0, 56.0], np.float32)
    return [{"class_id": c, "class_name": f"c{c}",
             "support_images": rng.randint(0, 256, (SHOT, 64, 64, 3),
                                           np.uint8),
             "support_boxes": np.tile(box, (SHOT, 1)),
             "support_box_valid": np.ones((SHOT,), bool)}
            for c in range(CLASSES)]


def _infer(toy, fam):
    model, cfg = toy[fam]
    if fam == "fcos":
        return meta_eval.make_fcos_infer(model, _bank(cfg), _eval_grid(cfg),
                                         _decode_cfg(cfg), device="cpu")
    return MetaFasterRCNNRunner(device="cpu").make_infer(
        cfg, model, _bank(cfg), eval_anchor_grid(cfg))


def _run(toy, path, stats):
    """One of the paths whose ``stats`` keys the drivers read."""
    if path in ("fcos_query", "rcnn_query"):
        meta_eval.run_query_inference(_infer(toy, path[:4]), _queries(), {},
                                      _Sink(), device="cpu", stats=stats)
    elif path == "register":
        meta_eval.generate_class_codes(toy["fcos"][0], _supports(),
                                       class_batch=CLASS_BATCH,
                                       device="cpu", stats=stats)
    else:
        meta_eval.generate_class_codes_sharded(
            toy["fcos"][0], _supports(), DataGroup.single("cpu"),
            class_batch=CLASS_BATCH, device="cpu", stats=stats)


def _traced(fn):
    """(fn's result, [(span name, start ns, end ns, thread)] in start
    order) under a profiler that records every thread."""
    every = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=every) as prof:
        out = fn()
    found = sorted((e.start_ns(), e.end_ns(), e.name()[len(spans.PREFIX):],
                    e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(spans.PREFIX))
    return out, [(n, s, t, th) for s, t, n, th in found]


def _of(found, name):
    return [f for f in found if f[0] == name]


def _timed_inside(found, seconds):
    """A timer that runs inside its spans: positive, and no longer than
    they are (the span's enter and exit, and any wait for the interpreter
    lock around them, lie outside it)."""
    total = sum(t - s for _, s, t, _ in found) / 1e9
    assert 0 < seconds <= total + CLOCKS_S


def _within(child, parents) -> bool:
    """``child`` lies inside one of ``parents`` on its own thread."""
    return any(p[3] == child[3] and p[1] <= child[1] and child[2] <= p[2]
               for p in parents)


@pytest.mark.parametrize("with_stats", [False, True])
def test_span_off_without_profiler(with_stats):
    stats = {} if with_stats else None
    s = spans.span("x", stats, "x_s")
    with s:
        torch.ones(4).sum()
    if with_stats:
        assert s is not spans.span("y", stats, "y_s")
        assert stats["x_s"] == s.seconds > 0
    else:
        assert s is spans.span("y") is spans._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(spans.PREFIX)]


NESTED = {"fcos": [("backbone", None), ("fpn", None), ("fcos_head", None),
                   ("decode", None), ("nms", "decode")],
          "rcnn": [("backbone", None), ("fpn", None), ("rpn", None),
                   ("nms", None), ("roi_stage", None),
                   ("roi_align", "roi_stage"), ("box_head", "roi_stage")]}
PER_IMAGE = ("roi_align", "box_head")
TWICE = {("rcnn", "nms")}  # the RPN's, inside ``rpn``, and the ROI stage's


@pytest.mark.parametrize("fam", ["fcos", "rcnn"])
def test_query_spans(toy, fam):
    stats = {}
    _, found = _traced(lambda: meta_eval.run_query_inference(
        _infer(toy, fam), _queries(), {}, _Sink(), device="cpu",
        stats=stats))
    main = _of(found, "infer")[0][3]
    h2d, wait = _of(found, "h2d"), _of(found, "wait")
    infer, fetch = _of(found, "infer"), _of(found, "fetch")
    assert len(h2d) == len(infer) == len(fetch) == BATCHES
    assert len(wait) == BATCHES + 1   # the last take finds the end
    assert {f[3] for f in infer + fetch + wait} == {main}
    assert {f[3] for f in h2d} != {main} and len({f[3] for f in h2d}) == 1
    for k in range(BATCHES):  # the k-th copy is of the item the k-th take got
        assert h2d[k][2] <= wait[k][2] <= infer[k][1]
        assert infer[k][2] <= fetch[k][1]
        assert (k + 1 == BATCHES) or h2d[k][2] <= h2d[k + 1][1]
    for name, parent in NESTED[fam]:
        got = _of(found, name)
        per = (2 if (fam, name) in TWICE else
               BATCH if name in PER_IMAGE else 1)
        assert len(got) == BATCHES * per, name
        assert all(_within(g, infer) for g in got), name
        if parent is not None:
            assert all(_within(g, _of(found, parent)) for g in got), name
    if fam == "rcnn":
        nms = _of(found, "nms")
        assert sum(_within(g, _of(found, "rpn")) for g in nms) == BATCHES
    # the timers are the spans': query_s is infer + fetch
    _timed_inside(infer + fetch, stats["query_s"])
    _timed_inside(wait, stats["query_wait_s"])


@pytest.mark.parametrize("fam", ["fcos", "rcnn"])
def test_register_spans(toy, fam):
    stats = {}
    model = toy[fam][0]
    codes, found = _traced(lambda: meta_eval.generate_class_codes(
        model, _supports(), class_batch=CLASS_BATCH, device="cpu",
        stats=stats))
    calls = -(-CLASSES // CLASS_BATCH)
    assert sorted(codes) == list(range(CLASSES))
    register = _of(found, "register")
    assert len(register) == len(_of(found, "h2d")) == calls
    for name, parent in (("backbone", "register"), ("fpn", "register"),
                         ("code_generator", "register"),
                         ("roi_align", "code_generator"),
                         ("fetch", "register")):
        got = _of(found, name)
        assert len(got) == calls, name
        assert all(_within(g, _of(found, parent)) for g in got), name
    assert not _of(found, "fcos_head") and not _of(found, "nms")
    _timed_inside(register, stats["codegen_s"])


STATS = {
    "fcos_query": ({"query_wait_s", "query_s", "evaluator_s", "evaluate_s"},
                   {"query_batches": BATCHES,
                    "query_images": BATCHES * BATCH}),
    "rcnn_query": ({"query_wait_s", "query_s", "evaluator_s", "evaluate_s"},
                   {"query_batches": BATCHES,
                    "query_images": BATCHES * BATCH}),
    "register": ({"support_wait_s", "codegen_s"}, {"classes": CLASSES}),
    "sharded": ({"support_wait_s", "codegen_s", "gather_s"},
                {"classes": CLASSES}),
}


@pytest.mark.parametrize("path", sorted(STATS))
def test_stats_keys_and_counts(toy, path):
    times, counts = STATS[path]
    stats = {}
    _run(toy, path, stats)
    assert set(stats) == times | set(counts)
    assert {k: stats[k] for k in counts} == counts
    assert all(stats[k] >= 0 for k in times)
    _run(toy, path, None)  # no stats asked for: nothing to add them to
