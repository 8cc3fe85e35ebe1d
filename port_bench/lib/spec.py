"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, metric or cell
lies in a file of its own under ``port_bench/``:

  * a configuration: the ``file`` its ``configs`` entry names;
  * a traffic mix: ``traffic/<traffic>.json``, parameters that
    ``lib/traffic.py``'s generator reads, among them the ``driver`` that
    drives it; a driver of one model family: ``drivers/<driver>.<family>.py``
    (``lib/drive.py``), ``family`` from the configuration file;
  * an end-to-end metric: ``e2e/<name>.py``; a per-layer metric:
    ``metrics/<name>.py``; each defines ``read(run) -> number or None``;
  * a cell's output check: ``limits/<workload>.json`` (``Bench.limits``).

So a later cell, mix, driver, family or metric is added as files and
entries, with no edit to a file that exists.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent   # port_bench/
ROOT = HERE.parent                              # the checkout


def load_json(path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """One ``BENCHMARK.json`` and lookups by name."""

    def __init__(self, path=ROOT / "BENCHMARK.json"):
        self.path = Path(path)
        self.data = load_json(self.path)
        self.root = self.path.parent

    def _one(self, key: str, name: str) -> Dict:
        found = [e for e in self.data[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"{key}: no entry named {name!r} in {self.path}")
        return found[0]

    def workload(self, name: str) -> Dict:
        return self._one("workloads", name)

    def config(self, name: str) -> Dict:
        """The configuration file's contents, with its entry's name."""
        entry = self._one("configs", name)
        conf = load_json(self.root / entry["file"])
        conf["name"] = name
        return conf

    def limits(self, workload: str) -> Dict:
        """The cell's output check, ``port_bench/limits/<workload>.json``
        beside this ``BENCHMARK.json``."""
        return load_json(self.root / "port_bench" / "limits"
                         / f"{workload}.json")

    def traffic(self, name: str) -> Dict:
        """The mix's parameters, ``port_bench/traffic/<name>.json`` beside
        this ``BENCHMARK.json``."""
        return load_json(self.root / "port_bench" / "traffic" / f"{name}.json")

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The cell's end-to-end (trace off) or per-layer (trace on)
        metrics, in file order."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if workload in m.get("workloads", [workload])]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(trace: bool, name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py`` (per-layer) or
    ``e2e/<name>.py`` (end-to-end), loaded by path."""
    kind = "metrics" if trace else "e2e"
    return _load(HERE / kind / f"{name}.py",
                 f"port_bench_{kind}_{name}").read


def driver(name: str, family: str) -> Callable:
    """The ``Driver`` class of ``drivers/<name>.<family>.py``."""
    path = HERE / "drivers" / f"{name}.{family}.py"
    if not path.exists():
        raise KeyError(f"no driver {name!r} for the family {family!r} "
                       f"({path.name})")
    return _load(path, f"port_bench_driver_{name}_{family}").Driver
