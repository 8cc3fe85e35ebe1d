"""Lightweight yacs-style config node (the port's own copy of
sylph_tpu/config/config.py; ``sylph://`` resolves into the repo's
``configs/``, which the port reads as data).

Mirrors the behavior of the reference's config system
(reference: sylph/config/config.py:20-65) — attribute access, deep merge,
YAML loading with ``_BASE_`` inheritance, ``sylph://`` path rerouting into
the packaged ``configs/`` tree, freezing — without depending on yacs/d2go.

Unlike the reference there is NO mutable global config (the reference reads
``set_global_cfg`` deep inside data loading, meta_coco.py:24; a design wart
flagged in SURVEY.md §5): config is always threaded explicitly.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"


def reroute_config_path(path: str) -> str:
    """Resolve ``sylph://rel/path.yaml`` into the repo's ``configs/`` tree.

    Reference: sylph/config/config.py:32-42.
    """
    if path.startswith("sylph://"):
        rel = path[len("sylph://"):]
        root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "configs")
        return os.path.join(root, rel)
    return path


class CfgNode(dict):
    """dict with attribute access, recursive merge and freeze support."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freeze -------------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    # -- merge --------------------------------------------------------------
    def clone(self) -> "CfgNode":
        c = CfgNode()
        for k, v in self.items():
            c[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return c

    def merge_from_other(self, other: Dict[str, Any], allow_new: bool = True) -> None:
        for k, v in other.items():
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], CfgNode):
                    if not allow_new and k not in self:
                        raise KeyError(f"Unknown config key: {k}")
                    self[k] = CfgNode()
                self[k].merge_from_other(v, allow_new=allow_new)
            else:
                if not allow_new and k not in self:
                    raise KeyError(f"Unknown config key: {k}")
                self[k] = copy.deepcopy(v)

    def merge_from_file(self, path: str, allow_new: bool = True) -> None:
        """Load YAML (resolving ``_BASE_`` chains and ``sylph://``) and merge."""
        loaded = _load_yaml_with_base(reroute_config_path(path))
        self.merge_from_other(loaded, allow_new=allow_new)

    def merge_from_list(self, opts: List[Any]) -> None:
        """CLI-style overrides: ["SOLVER.MAX_ITER", 10, "MODEL.DEVICE", "tpu"]."""
        assert len(opts) % 2 == 0, f"odd number of override tokens: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if isinstance(value, str) and leaf in node and not isinstance(node[leaf], str):
                value = yaml.safe_load(value)
            node[leaf] = value

    def __reduce__(self):
        """Pickles as its plain dict (a data-parallel rank receives its
        config this way), frozen or not as it was."""
        return _unpickle, (self.to_dict(), self.is_frozen())

    # -- dump ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)


def _unpickle(d: Dict[str, Any], frozen: bool) -> CfgNode:
    cfg = CfgNode(d)
    return cfg.freeze() if frozen else cfg


def _load_yaml_with_base(path: str) -> Dict[str, Any]:
    """Load a YAML file, recursively applying its ``_BASE_`` parent first.

    Reference semantics: sylph/config/config.py:45-65 (base paths are
    resolved relative to the child file, or via ``sylph://``).
    """
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop(_BASE_KEY, None)
    if base is None:
        return cfg
    base = reroute_config_path(base)
    if not os.path.isabs(base):
        base = os.path.join(os.path.dirname(path), base)
    merged = _load_yaml_with_base(base)
    _deep_update(merged, cfg)
    return merged


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
