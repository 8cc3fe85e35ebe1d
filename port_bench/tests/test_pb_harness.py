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

from conftest import ROOT

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


@pytest.mark.parametrize("cell,trace", [
    ("fcos_query_b8_c80", 0), ("fcos_query_b8_c80", 1),
    ("rcnn_query_b8_c1203", 0), ("rcnn_query_b8_c1203", 1),
    ("fcos_register_s10_cb8", 0)])
def test_toy_run_prints_a_result(toy_bench, cell, trace):
    p = _run(["--workload", cell, "--seed", "3000000017", "--seconds", "2",
              "--trace", str(trace), "--device", "cpu",
              "--benchmark", str(toy_bench)])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    wanted = {m["name"] for m in spec.Bench().metrics(cell, bool(trace))}
    assert set(line["metrics"]) <= wanted
    if not trace:
        assert set(line["metrics"]) == wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


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
