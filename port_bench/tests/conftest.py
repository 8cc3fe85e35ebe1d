"""Shared pieces of the benchmark's CPU tests.

``toy_bench`` writes a copy of ``BENCHMARK.json`` whose configurations are
cut to toy sizes (R-18, canvases of 64 x 96, float32, fewer proposals) and
whose traffic mixes bank fewer codes into a temporary checkout-like
directory, with each cell's limits
set for two float32 CPU computations of the same thing. Tests marked
``chip`` need the card; each decides inside itself and skips here.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY_OPTS = {
    "fcos": ["MODEL.RESNETS.DEPTH", 18, "TPU.EVAL_CANVAS", [64, 96],
             "TPU.SUPPORT_CANVAS", [64, 64], "TPU.COMPUTE_DTYPE", "float32"],
    "rcnn": ["MODEL.RESNETS.DEPTH", 18, "TPU.EVAL_CANVAS", [64, 96],
             "TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.POST_NMS_TOPK_TEST",
             40, "MODEL.RPN.PRE_NMS_TOPK_TEST", 60],
}
TOY_BANK_ROWS = 20
TOY_LIMIT = 1e-3  # two float32 computations of one thing on the CPU


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the NVIDIA card")


def toy_conf(entry_file: str, name: str):
    """A configuration file's contents cut to toy sizes, its ``cfg`` table
    taken from the merged toy config."""
    from port_bench.lib.model import _get, _plain, merged_cfg

    conf = json.loads((ROOT / entry_file).read_text())
    real = conf["cfg"]
    conf.update(name=name, opts=TOY_OPTS[conf["family"]], cfg={})
    _, cfg = merged_cfg(conf)
    conf["cfg"] = {k: _plain(_get(cfg, k)) for k in real}
    return conf


@pytest.fixture(scope="session")
def toy_bench(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("toy")
    (out / "cfgs").mkdir()
    (out / "port_bench" / "limits").mkdir(parents=True)
    (out / "port_bench" / "traffic").mkdir(parents=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = toy_conf(c["file"], c["name"])
        c["file"] = f"cfgs/{c['name']}.json"
        (out / c["file"]).write_text(json.dumps(conf))
    for w in bench["workloads"]:
        mix = json.loads((ROOT / "port_bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        if "bank" in mix:
            mix["bank"]["rows"] = TOY_BANK_ROWS
        (out / "port_bench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
        lim = json.loads((ROOT / "port_bench" / "limits"
                          / f"{w['name']}.json").read_text())
        lim["limits"] = {k: TOY_LIMIT for k in lim["limits"]}
        (out / "port_bench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(lim))
    path = out / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    return torch.device("cuda", 0)
