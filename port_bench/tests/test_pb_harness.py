"""The harness on the CPU: every piece found by name from ``BENCHMARK.json``
alone, names and units within the allowed characters, a toy run's result
line, and the refusals (no card, no program beside the benchmark)."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, make_toy_bench

from port_bench.lib import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves"}}


def _run(args, cwd=ROOT, env=None, timeout=600):
    return subprocess.run([sys.executable, "port_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_keys_and_limits():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for key, allowed in ENTRY_KEYS.items():
        for e in BENCH[key]:
            assert set(e) - {"workloads"} == allowed, e["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def _name_errors(data):
    """Names and units outside the allowed characters."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in data[key]:
            words = [e["name"], e.get("config"), e.get("traffic"),
                     *e.get("reduced", [])]
            bad += [w for w in words if w is not None and not NAME.match(w)]
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(e["unit"])
    return bad


def test_names_and_units():
    assert _name_errors(BENCH) == []
    assert _name_errors({"configs": [], "workloads": [], "end_to_end": [],
                         "per_layer": [{"name": "a b", "unit": "µs"}]}) == [
        "a b", "µs"]
    names = [e["name"] for k in ("end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    for e in BENCH["per_layer"] + BENCH["workloads"] + BENCH["configs"]:
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            assert text is None or (0 < len(text) <= 200
                                    and "\n" not in text and "\t" not in text)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    bench = spec.Bench()
    entry = bench.workload(cell)
    conf = bench.config(entry["config"])
    assert conf["name"] == entry["config"]
    driver = spec.driver(bench.traffic(entry["traffic"])["driver"],
                         conf["family"])
    assert driver.kind in ("query", "register")
    for name in conf["ranges"]:
        assert NAME.match(name)
    assert spec.Bench().limits(cell)["limits"]
    e2e = [m["name"] for m in bench.metrics(cell, False)]
    per_layer = bench.metrics(cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in bench.metrics(cell, False) + per_layer:
        assert callable(spec.reader(m in per_layer, m["name"]))


def test_configs_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])


def _toy_result(bench, cell, trace):
    """A toy run of ``cell`` of the benchmark ``bench`` through ``run.py``,
    held to the result line's contract."""
    p = _run(["--workload", cell, "--seed", "3000000017", "--seconds", "2",
              "--trace", str(trace), "--device", "cpu",
              "--benchmark", str(bench)])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    wanted = {m["name"] for m in spec.Bench(bench).metrics(cell, bool(trace))}
    assert set(line["metrics"]) <= wanted
    if not trace:
        assert set(line["metrics"]) == wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_toy_run_prints_a_result(toy_bench, cell, trace):
    _toy_result(toy_bench, cell, trace)


ROIENC = {
    "source": "https://github.com/facebookresearch/sylph-few-shot-detection"
              "/blob/main/configs/LVISv1-Detection/Meta-FCOS/"
              "Meta-FCOS-ROI-Encoder-finetune.yaml",
    "runner": "MetaFCOSROIEncoderRunner",
    "yaml": "sylph://LVISv1-Detection/Meta-FCOS/"
            "Meta-FCOS-ROI-Encoder-finetune.yaml",
    "opts": [],
    "toy_opts": ["MODEL.RESNETS.DEPTH", 18, "TPU.EVAL_CANVAS", [64, 96],
                 "TPU.SUPPORT_CANVAS", [64, 64], "TPU.COMPUTE_DTYPE",
                 "float32"],
    "family": "fcos",
    "ranges": ["backbone", "fpn", "fcos_head", "code_generator"],
    "reduced": {"MODEL.WEIGHTS": "random weights from --seed"},
}
ROIENC_KEYS = [f"MODEL.META_LEARN.CODE_GENERATOR.{k}" for k in (
    "NAME", "TOKENIZER.NUM_CONV", "TOKENIZER.NORM", "TOKENIZER.NUM_FC",
    "TOKENIZER.FC_DIM", "TRANSFORMER_ENCODER.LAYERS",
    "TRANSFORMER_ENCODER.HEADS", "HEAD.NUM_FC", "HEAD.FC_DIM",
    "HEAD.OUTPUT_DIM")]


def _sources(root):
    """(path, bytes) of every file under ``root/port_bench`` but caches."""
    return sorted((str(f.relative_to(root)), f.read_bytes())
                  for f in (root / "port_bench").rglob("*")
                  if f.is_file() and "__pycache__" not in f.parts)


@pytest.fixture(scope="module")
def roienc_bench(tmp_path_factory):
    """A checkout that adds the LVIS ROI-Encoder configuration and a query
    cell over ``query_ring_c80`` as files and entries alone, cut to toys."""
    from port_bench.lib.model import _get, _plain, merged_cfg

    src = tmp_path_factory.mktemp("roienc_src")
    shutil.copytree(ROOT / "port_bench", src / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    fcos = json.loads((ROOT / "port_bench/configs/meta_fcos_r50.json")
                      .read_text())
    conf = dict(ROIENC, name="meta_fcos_roienc_r50", cfg={})
    _, cfg = merged_cfg(conf)
    conf["cfg"] = {k: _plain(_get(cfg, k))
                   for k in [*fcos["cfg"], *ROIENC_KEYS]}
    conf.pop("name")
    assert conf["cfg"]["MODEL.META_LEARN.CODE_GENERATOR.NAME"] == "ROIEncoder"
    (src / "port_bench/configs/meta_fcos_roienc_r50.json").write_text(
        json.dumps(conf))
    shutil.copy(src / "port_bench/limits/fcos_query_b8_c80.json",
                src / "port_bench/limits/roienc_query_b8_c80.json")
    bench["configs"].append({
        "name": "meta_fcos_roienc_r50", "source": ROIENC["source"],
        "file": "port_bench/configs/meta_fcos_roienc_r50.json",
        "reduced": ["MODEL.WEIGHTS"], "why": "Sylph's ROIEncoder"})
    bench["workloads"].append({
        "name": "roienc_query_b8_c80", "config": "meta_fcos_roienc_r50",
        "traffic": "query_ring_c80", "chips": 1, "why": "query batches"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fcos_query_b8_c80" in m.get("workloads", []):
            m["workloads"].append("roienc_query_b8_c80")
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    return make_toy_bench(tmp_path_factory.mktemp("roienc_toy"), src)


@pytest.mark.parametrize("trace", [0, 1])
def test_roi_encoder_cell_enters_as_files(roienc_bench, trace):
    """The ROI-Encoder detector (MS-CAM, GN tokenizer, post-LN encoder)
    takes its seeded weights, and its query cell runs through the
    repository's ``run.py`` with nothing under ``port_bench/`` written."""
    before = _sources(ROOT)
    _toy_result(roienc_bench, "roienc_query_b8_c80", trace)
    assert _sources(ROOT) == before


def test_no_card_fails_without_fallback():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(["--workload", "fcos_query_b8_c80", "--seed", "1",
              "--seconds", "1", "--trace", "0"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = _run(["--workload", "fcos_query_b8_c80", "--seed", "1",
              "--seconds", "1", "--trace", "0", "--device", "cpu"],
             cwd=tmp_path, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
