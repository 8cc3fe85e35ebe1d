"""The system under test, built from a configuration file.

A configuration (``configs/<name>.json``) names the runner class of
``sylph_tpu_torch`` and the published YAML it merges (``sylph://`` paths
resolve inside the package's ``configs/``), plus ``opts`` merged after it.
``cfg`` in the file lists the values the published configuration sets,
keyed as the YAML keys them: the merged config must hold each of them, so
the program runs what the file says and the reference (which reads the
same table) computes the same thing.

The detector is built by the runner's own ``build_model`` (its
``MODEL.WEIGHTS`` is empty, so the runner loads nothing over its seeded
init), then takes the benchmark's seeded state dict (``weights.py``) with
``strict=True``; the evaluation then holds its weights as
``utils/precision.py::eval_resident_params`` says, as ``do_test`` does.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch


def runner_class(name: str):
    """A runner class of the port by name."""
    for mod in ("sylph_tpu_torch.runner",
                "sylph_tpu_torch.meta_faster_rcnn_runner"):
        cls = getattr(importlib.import_module(mod), name, None)
        if cls is not None:
            return cls
    raise ValueError(f"no runner {name!r} in sylph_tpu_torch")


def _get(cfg, key: str):
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def merged_cfg(conf: Dict):
    """The runner's default config with the YAML and ``opts`` merged;
    raises where it departs from the file's ``cfg`` table."""
    cls = runner_class(conf["runner"])
    cfg = cls.get_default_cfg()
    cfg.merge_from_file(conf["yaml"])
    if conf.get("opts"):
        cfg.merge_from_list(list(conf["opts"]))
    bad = {k: (_plain(_get(cfg, k)), v) for k, v in conf["cfg"].items()
           if _plain(_get(cfg, k)) != v}
    if bad:
        raise ValueError(f"the merged config departs from {conf['name']}: "
                         + ", ".join(f"{k} is {a!r}, not {b!r}"
                                     for k, (a, b) in bad.items()))
    return cls, cfg


def build(conf: Dict, seed: int, device) -> Tuple[torch.nn.Module, object,
                                                   Dict[str, torch.Tensor]]:
    """-> (the program's detector on ``device``, its merged config, the
    float32 state dict it was given)."""
    from sylph_tpu_torch.utils.precision import eval_resident_params

    from .weights import seeded_state_dict

    cls, cfg = merged_cfg(conf)
    model = cls(device=device).build_model(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = seeded_state_dict(shapes, seed, device)
    model.load_state_dict(sd, strict=True)
    return eval_resident_params(cfg, model.eval()), cfg, sd
