"""The plain reference against the port at toy sizes on the CPU, from one
seeded state dict, and the import rules: the reference and the counts load
nothing of the program, and nothing the benchmark runs loads ``jax``,
``jaxlib``, ``flax`` or ``sylph_tpu`` (top-level names compared whole: the
port's own name begins with ``sylph_tpu``)."""

from __future__ import annotations

import ast
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, toy_conf

from port_bench.lib import model as pb_model
from port_bench.reference import detector as ref
from port_bench.reference import fcos_decode as fd
from port_bench.reference.arith import Arith
from port_bench.reference.nms import multiclass_nms
from port_bench.reference.roi_align import multilevel_roi_align

FORBIDDEN = {"jax", "jaxlib", "flax", "sylph_tpu"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FILES = {c["name"]: c["file"] for c in BENCH["configs"]}


def _toy(name: str, seed: int = 11):
    conf = toy_conf(FILES[name], name)
    det, cfg, sd = pb_model.build(conf, seed, "cpu")
    return conf, det, cfg, sd


def _images(n, hw, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), dtype=torch.uint8, generator=g)


def test_fcos_dense_and_detections():
    from sylph_tpu_torch.evaluation.meta_eval import make_fcos_infer
    from sylph_tpu_torch.runner import _decode_cfg, _eval_grid

    conf, det, cfg, sd = _toy("meta_fcos_r50")
    table = conf["cfg"]
    g = torch.Generator().manual_seed(5)
    bank = {"cls_conv": 0.2 * torch.randn(20, 256, generator=g),
            "cls_bias": torch.zeros(20)}
    imgs = _images(2, table["TPU.EVAL_CANVAS"])
    with torch.inference_mode():
        out = det.forward_instances(imgs, bank)
        dense = ref.fcos_dense(sd, imgs, bank, table, Arith())
        for a, b in zip(out, dense):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        infer = make_fcos_infer(det, {k: v.numpy() for k, v in bank.items()},
                                _eval_grid(cfg), _decode_cfg(cfg),
                                device="cpu")
        sizes = torch.tensor([[64, 80], [50, 96]], dtype=torch.int32)
        served = infer(imgs, sizes).numpy()
        grid = ref.fcos_grid(table, "cpu")
        for b in range(2):
            cand, keep, boxes = ref.fcos_detect(dense, b, grid,
                                                sizes[b].tolist(), table)
            v = served.valid[b]
            assert v.sum() == len(keep) == 100
            np.testing.assert_allclose(served.scores[b][v],
                                       cand.scores[keep].numpy(), atol=1e-6)
            np.testing.assert_allclose(served.boxes[b][v], boxes.numpy(),
                                       atol=1e-4)
            np.testing.assert_array_equal(served.classes[b][v],
                                          cand.classes[keep].numpy())
            np.testing.assert_allclose(
                served.locations[b][v],
                grid.locations[cand.index[keep]].numpy())


def test_rcnn_detections():
    from sylph_tpu_torch.meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                                         eval_anchor_grid)

    conf, det, cfg, sd = _toy("meta_rcnn_r50")
    table = conf["cfg"]
    g = torch.Generator().manual_seed(6)
    w = torch.randn(20, 1024, generator=g)
    bank = {"cls_conv": w / w.norm(dim=1, keepdim=True),
            "cls_bias": torch.full((20,), -math.log(99.0))}
    imgs = _images(2, table["TPU.EVAL_CANVAS"])
    sizes = torch.tensor([[64, 80], [50, 96]], dtype=torch.int32)
    infer = MetaFasterRCNNRunner(device="cpu").make_infer(
        cfg, det, {k: v.numpy() for k, v in bank.items()},
        eval_anchor_grid(cfg))
    with torch.inference_mode():
        served = infer(imgs, sizes).numpy()
        res = ref.rcnn_detect(sd, imgs, sizes.tolist(), bank, table, Arith())
    for b, r in enumerate(res):
        v = served.valid[b]
        assert v.sum() == len(r.keep_prop) == 300
        np.testing.assert_allclose(
            served.scores[b][v], r.roi.probs[r.keep_prop, r.keep_cls].numpy(),
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(served.boxes[b][v],
                                   r.roi.boxes[r.keep_prop].numpy(), atol=1e-3)
        np.testing.assert_array_equal(served.classes[b][v], r.keep_cls.numpy())


def test_registration_codes():
    conf, det, cfg, sd = _toy("meta_fcos_r50")
    table = conf["cfg"]
    shots = table["MODEL.META_LEARN.EVAL_SHOT"]
    imgs = _images(2 * shots, table["TPU.SUPPORT_CANVAS"])
    g = np.random.RandomState(0)
    x0, y0 = g.randint(0, 32, (2 * shots, 1)), g.randint(0, 32, (2 * shots, 1))
    boxes = torch.as_tensor(np.concatenate(
        [x0, y0, x0 + g.randint(8, 32, (2 * shots, 1)),
         y0 + g.randint(8, 32, (2 * shots, 1))], 1).astype(np.float32))
    with torch.inference_mode():
        ones = torch.ones(2 * shots, dtype=torch.bool)
        served = det.forward_class_code(imgs, boxes, ones, shots, False)
        codes = ref.fcos_register(sd, imgs, boxes, table, Arith())
    for k in ("cls_conv", "cls_bias"):
        torch.testing.assert_close(served[k].reshape(codes[k].shape), codes[k],
                                   rtol=1e-4, atol=1e-5)


def test_roi_align_matches_the_port():
    from sylph_tpu_torch.ops.roi_align import multilevel_roi_align as port

    g = torch.Generator().manual_seed(2)
    feats = [torch.randn(1, 8, 64 // s, 96 // s, generator=g)
             for s in (4, 8, 16, 32)]
    xy = torch.rand(40, 2, generator=g) * torch.tensor([110.0, 80.0]) - 10
    wh = torch.rand(40, 2, generator=g) * 70
    boxes = torch.cat([xy, xy + wh], 1)
    boxes[0] = torch.tensor([5.0, 5.0, 5.0, 9.0])       # no width
    boxes[1] = torch.tensor([-30.0, -30.0, -20.0, -20.0])  # off the map
    mine = multilevel_roi_align(feats, 0, boxes, (4, 8, 16, 32))
    theirs = port(feats, (4, 8, 16, 32), boxes,
                  torch.ones(40, dtype=torch.bool),
                  torch.zeros(40, dtype=torch.long), output_size=7)
    torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-5)


def test_nms_matches_the_twin():
    from sylph_tpu_torch.ops.nms import batched_multiclass_nms

    g = torch.Generator().manual_seed(4)
    xy = torch.rand(1, 600, 2, generator=g) * 100
    wh = 5 + torch.rand(1, 600, 2, generator=g) * 30
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(1, 600, generator=g)
    classes = torch.randint(0, 5, (1, 600), generator=g)
    valid = torch.rand(1, 600, generator=g) > 0.1
    _, _, _, ok, idx = batched_multiclass_nms(boxes, scores, classes, valid,
                                              0.5, 80)
    keep = multiclass_nms(boxes[0], scores[0], classes[0], valid[0], 0.5, 80)
    np.testing.assert_array_equal(idx[0][ok[0]].numpy(), keep.numpy())


def test_fcos_grid_matches_the_port():
    from sylph_tpu_torch.ops.locations import build_location_grid

    grid = fd.location_grid((100, 130), (8, 16, 32, 64, 128), "cpu")
    port = build_location_grid((100, 130), (8, 16, 32, 64, 128),
                               [64, 128, 256, 512])
    np.testing.assert_array_equal(grid.locations.numpy(), port.locations)
    assert grid.sizes == [tuple(s) for s in port.level_sizes]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_nothing_forbidden():
    for path in (ROOT / "port_bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = _imports(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if {"reference", "counts"} & set(path.relative_to(
                ROOT / "port_bench").parts):
            assert "sylph_tpu_torch" not in names, path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, pkgutil, importlib\n"
            "import port_bench.reference as r, port_bench.counts as c\n"
            "for p in (r, c):\n"
            "    for m in pkgutil.iter_modules(p.__path__):\n"
            "        importlib.import_module(p.__name__ + '.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"sylph_tpu_torch"})


@pytest.mark.parametrize("name", sorted(FORBIDDEN))
def test_run_refuses_a_forbidden_module(toy_bench, name):
    code = ("import sys, types, runpy\n"
            f"sys.modules[{name!r}] = types.ModuleType({name!r})\n"
            "sys.argv = ['run.py', '--workload', 'fcos_register_s10_cb8',"
            " '--seed', '7', '--seconds', '0.5', '--trace', '0',"
            f" '--device', 'cpu', '--benchmark', {str(toy_bench)!r}]\n"
            "runpy.run_path('port_bench/run.py', run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 3, p.stderr[-2000:]
    assert p.stdout.strip() == "" or not p.stdout.strip().splitlines()[
        -1].startswith("{")
    assert name in p.stderr
