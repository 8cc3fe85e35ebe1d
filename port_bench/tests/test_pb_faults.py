"""The output check catches a broken timed path: each cell's toy run with a
fault planted in the program underneath (the harness's look for a card is
skipped by ``--device cpu``; the rest of the run is the real one) comes out
``correct: false``. The faults a cell can have:

  * half of the batch left out, the mean taken over the rest: the pyramid
    of the second half of every batch (query images or support images) is
    the mean of the first half's;
  * an answer altered where it is produced: one served score of every
    query batch, or one code row of every registration call;
  * the two-stage RPN's proposals cut short (the second half of each
    image's flagged invalid) or one proposal repeated in every slot.

The cells hold no training step and span no chips, so a state left
unchanged and a missing exchange are not among them. The control (the
reference on float8 operands in the program's place) must fail the real
cells' limits too, here at toy size."""

from __future__ import annotations

import argparse

import pytest
import torch

from conftest import ROOT

from port_bench import run as pb_run
from port_bench.lib import spec

BENCH = spec.Bench(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH.data["workloads"]]


def _args(bench, cell):
    return argparse.Namespace(workload=cell, seed=2 ** 31 + 99, seconds=1.0,
                              trace=0, device="cpu", benchmark=str(bench))


def _half_batch(monkeypatch):
    from sylph_tpu_torch.meta_faster_rcnn_runner import FewShotRCNN
    from sylph_tpu_torch.models.meta_arch import MetaOneStageDetector

    for cls in (MetaOneStageDetector, FewShotRCNN):
        orig = cls.extract_features

        def broken(self, images, orig=orig):
            h = max(1, images.shape[0] // 2)
            feats = orig(self, images[:h])
            return [torch.cat([f, f.mean(0, keepdim=True).expand(
                images.shape[0] - h, *f.shape[1:])]) for f in feats]
        monkeypatch.setattr(cls, "extract_features", broken)


def _altered_answer(monkeypatch):
    from sylph_tpu_torch.evaluation import meta_eval
    from sylph_tpu_torch.meta_faster_rcnn_runner import FewShotRCNN
    from sylph_tpu_torch.models.code_generator import CodeGeneratorHead
    from sylph_tpu_torch.models.roi_encoder import ROIEncoder

    orig_decode = meta_eval.decode_proposals

    def decode(*a, **k):
        det = orig_decode(*a, **k)
        det.scores[0, 0] = det.scores[0, 0] * 0.9
        return det
    monkeypatch.setattr(meta_eval, "decode_proposals", decode)

    orig_infer = FewShotRCNN._two_stage_infer

    def infer(self, *a, **k):
        det = orig_infer(self, *a, **k)
        det.scores[0, 0] = det.scores[0, 0] * 1.5
        return det
    monkeypatch.setattr(FewShotRCNN, "_two_stage_infer", infer)

    for cls in (CodeGeneratorHead, ROIEncoder):
        def codes(self, *a, orig=cls.forward, **k):
            out = orig(self, *a, **k)
            out["cls_conv"][0] = out["cls_conv"][0] * 1.2
            return out
        monkeypatch.setattr(cls, "forward", codes)


def _proposals(broken):
    def plant(monkeypatch):
        from sylph_tpu_torch.models import rcnn

        orig = rcnn.rpn_proposals

        def rpn_proposals(*a, **k):
            props, scores, valid = orig(*a, **k)
            props, valid = broken(props.clone(), valid.clone())
            return props, scores, valid
        monkeypatch.setattr(rcnn, "rpn_proposals", rpn_proposals)
    return plant


def _cut_short(props, valid):
    valid[:, valid.shape[1] // 2:] = False
    return props, valid


def _one_repeated(props, valid):
    return props[:, :1].expand_as(props).contiguous(), valid


_proposals_cut_short = _proposals(_cut_short)
_proposals_one_repeated = _proposals(_one_repeated)
# the two-stage query cells: an R-CNN family's configuration under a mix of
# the query driver
RCNN_CELLS = [w["name"] for w in BENCH.data["workloads"]
              if BENCH.config(w["config"])["family"] == "rcnn"
              and BENCH.traffic(w["traffic"])["driver"] == "query"]


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(toy_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = pb_run.run(_args(toy_bench, cell))
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("fault", [_proposals_cut_short,
                                   _proposals_one_repeated])
@pytest.mark.parametrize("cell", RCNN_CELLS)
def test_proposal_fault_is_not_correct(toy_bench, monkeypatch, cell, fault):
    """Only ``proposal_lost_share`` sees these: the reference's ROI stage
    runs on the program's proposals, and every proposal served is near one
    of the reference's own."""
    fault(monkeypatch)
    line = pb_run.run(_args(toy_bench, cell))
    assert line["correct"] is False, line["check"]
    failed = {k for k, v in line["check"].items() if v["value"] > v["limit"]}
    assert "proposal_lost_share" in failed, line["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_toy_run_is_correct(toy_bench, cell):
    line = pb_run.run(_args(toy_bench, cell))
    assert line["correct"] is True, line["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_limits(toy_bench, cell):
    """The float8 control at toy size against each cell's own limits."""
    from port_bench.lib.cell import Cell
    from port_bench.lib.check import judge

    bench = spec.Bench(toy_bench)
    entry = bench.workload(cell)
    limits = spec.Bench().limits(cell)
    c = Cell(bench.config(entry["config"]), bench.traffic(entry["traffic"]),
             limits, 2 ** 31 + 5, torch.device("cpu"), False)
    values = c.control()
    assert judge(values, limits["limits"])["correct"] is False, values


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    """The control at the cell's own size on the card, three seeds, against
    the committed limits."""
    from port_bench.lib.cell import Cell
    from port_bench.lib.check import judge

    bench = spec.Bench()
    entry = bench.workload(cell)
    limits = bench.limits(cell)
    for seed in (11, 2 ** 31 + 12, 913):
        c = Cell(bench.config(entry["config"]),
                 bench.traffic(entry["traffic"]), limits, seed, card, False)
        values = c.control()
        assert judge(values, limits["limits"])["correct"] is False, values
