"""Shared pieces of the benchmark's CPU tests.

``toy_bench`` writes a copy of ``BENCHMARK.json`` whose configurations are
cut to toy sizes (each configuration file's own ``toy_opts``: R-18,
canvases of 64 x 96, float32, fewer proposals) and whose traffic mixes bank
fewer codes into a temporary checkout-like directory, with each cell's
limits set for two float32 CPU computations of the same thing
(``make_toy_bench`` does the same for any checkout). Tests marked ``chip``
need the card; each decides inside itself and skips here.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY_BANK_ROWS = 20
TOY_LIMIT = 1e-3  # two float32 computations of one thing on the CPU


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the NVIDIA card")


def toy_conf(path, name: str):
    """A configuration file's contents (``path`` under the repo, or
    absolute) cut by its ``toy_opts`` (merged after its ``opts``), its
    ``cfg`` table taken from the merged toy config."""
    from port_bench.lib.model import _get, _plain, merged_cfg

    conf = json.loads((ROOT / path).read_text())
    real = conf["cfg"]
    conf.update(name=name, opts=conf["opts"] + conf["toy_opts"], cfg={})
    _, cfg = merged_cfg(conf)
    conf["cfg"] = {k: _plain(_get(cfg, k)) for k in real}
    return conf


def make_toy_bench(out: Path, src: Path = ROOT) -> Path:
    """The toy copy, under ``out``, of the checkout ``src`` (its
    ``BENCHMARK.json`` and the files that names); -> its ``BENCHMARK.json``."""
    (out / "cfgs").mkdir()
    (out / "port_bench" / "limits").mkdir(parents=True)
    (out / "port_bench" / "traffic").mkdir(parents=True)
    bench = json.loads((src / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = toy_conf(src / c["file"], c["name"])
        c["file"] = f"cfgs/{c['name']}.json"
        (out / c["file"]).write_text(json.dumps(conf))
    for w in bench["workloads"]:
        mix = json.loads((src / "port_bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        if "bank" in mix:
            mix["bank"]["rows"] = TOY_BANK_ROWS
        (out / "port_bench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
        lim = json.loads((src / "port_bench" / "limits"
                          / f"{w['name']}.json").read_text())
        lim["limits"] = {k: TOY_LIMIT for k in lim["limits"]}
        (out / "port_bench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(lim))
    path = out / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="session")
def toy_bench(tmp_path_factory) -> Path:
    return make_toy_bench(tmp_path_factory.mktemp("toy"))


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    return torch.device("cuda", 0)
