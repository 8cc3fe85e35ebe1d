"""The FLOP counts from shapes against a count of the multiply-adds the
reference performs (its ``Arith`` counter) at toy sizes, and the NMS bound
on inputs whose walk is known."""

from __future__ import annotations

import json
import math

import torch

from conftest import ROOT, toy_conf

from port_bench.counts import flops
from port_bench.counts.nms_bound import nms_bound_ms, walk_tests
from port_bench.counts.peaks import HBM_BYTES_PER_S
from port_bench.lib.weights import seeded_state_dict
from port_bench.reference import detector as ref
from port_bench.reference.arith import Arith

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FILES = {c["name"]: c["file"] for c in BENCH["configs"]}


def _setup(name):
    from port_bench.lib.model import build

    conf = toy_conf(FILES[name], name)
    _, _, sd = build(conf, 21, "cpu")
    macs = []
    return conf["cfg"], sd, macs, Arith(counter=lambda kind, n: macs.append(n))


def test_fcos_query_count():
    table, sd, macs, arith = _setup("meta_fcos_r50")
    bank = {"cls_conv": torch.randn(7, 256), "cls_bias": torch.zeros(7)}
    imgs = torch.zeros((1, *table["TPU.EVAL_CANVAS"], 3), dtype=torch.uint8)
    ref.fcos_dense(sd, imgs, bank, table, arith)
    assert 2 * sum(macs) == flops.fcos_query_flops(table, 7)["total"]


def test_rcnn_query_count():
    table, sd, macs, arith = _setup("meta_rcnn_r50")
    bank = {"cls_conv": torch.randn(9, 1024), "cls_bias": torch.zeros(9)}
    imgs = torch.randint(0, 255, (1, *table["TPU.EVAL_CANVAS"], 3),
                         dtype=torch.uint8)
    (r,) = ref.rcnn_detect(sd, imgs, [table["TPU.EVAL_CANVAS"]], bank, table,
                           arith)
    assert r.proposals.shape[0] == table["MODEL.RPN.POST_NMS_TOPK_TEST"]
    assert 2 * sum(macs) == flops.rcnn_query_flops(table, 9)["total"]


def test_registration_count():
    table, sd, macs, arith = _setup("meta_fcos_r50")
    shots = table["MODEL.META_LEARN.EVAL_SHOT"]
    imgs = torch.zeros((shots, *table["TPU.SUPPORT_CANVAS"], 3),
                       dtype=torch.uint8)
    boxes = torch.tensor([[4.0, 4.0, 40.0, 30.0]]).repeat(shots, 1)
    ref.fcos_register(sd, imgs, boxes, table, arith)
    assert 2 * sum(macs) == flops.fcos_register_flops(table)["total"]


def test_published_sizes():
    """At the cell's own size: ~527 GFLOP a Meta-FCOS query image
    (1024 x 1344, 80 codes), the 376 GFLOP counted at 768 x 1280 scaled
    by the canvas area."""
    table = json.loads((ROOT / FILES["meta_fcos_r50"]).read_text())["cfg"]
    total = flops.fcos_query_flops(table, 80)["total"]
    assert 5.2e11 < total < 5.35e11


def test_nms_walk_and_bound():
    # three boxes in a row: 0 suppresses 1, 2 stands alone; two kept
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.1]])
    valid = torch.tensor([[True, True, True, False]])
    idx = torch.tensor([[0, 2, 0]])
    ok = torch.tensor([[True, True, False]])
    # the walk reaches all 3 alive: rank 1 tested against kept rank 0,
    # rank 2 against kept rank 0
    assert walk_tests(scores, valid, idx, ok) == 2
    bound, by = nms_bound_ms(scores, valid, idx, ok)
    nbytes = 4 * (16 + 4 + 4) + 3 * 8
    assert by == "bytes"
    assert math.isclose(bound, nbytes / HBM_BYTES_PER_S * 1e3)


def test_seeded_weights_are_the_seeds():
    shapes = {"backbone.stem_conv1.weight": (4, 3, 7, 7),
              "backbone.stem_bn1.scale": (4,), "backbone.stem_bn1.bias": (4,),
              "fpn.output_res3.bias": (4,), "fcos_head.scale_l0.scale": (),
              "fcos_head.cls_tower.gn0.weight": (4,)}
    a = seeded_state_dict(shapes, 5, "cpu")
    b = seeded_state_dict(shapes, 5, "cpu")
    c = seeded_state_dict(shapes, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["backbone.stem_conv1.weight"],
                           c["backbone.stem_conv1.weight"])
    assert (a["backbone.stem_bn1.scale"] > 0).all()
