"""Carry the JAX package's flax parameters across to the port.

``state_dict_from_jax(params)`` takes a flax param tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
``state_dict``. The port names its submodules after the flax modules
(``backbone.res2_block0.conv1``, ``fcos_head.cls_tower.conv0``,
``code_generator.tower_conv0``, ...), so the mapping is mechanical:

  * conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
  * Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
  * GroupNorm ``scale``/``bias`` -> ``weight``/``bias``;
  * FrozenBN ``scale``/``bias`` -> the buffers of the same names;
  * the two-stage box head's own parameters (``cosine_weight`` (C+1, D),
    ``bg_weight`` (D,)) keep their names and shapes;
  * scalars (``Scale.scale``, ``meta_bias_value``, ``bg_bias``,
    ``cosine_scale_param``) -> 0-d tensors.

``load_jax_params`` loads the result with ``strict=True``: a key left
unconsumed on either side raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# flax GroupNorm modules: FCOS towers ``gn{i}``, codegen ``{name}_gn`` and
# ``{name}_ln``, and the code post-norm. FrozenBN modules (``bn{i}``,
# ``stem_bn1``, ``shortcut_bn``) keep ``scale``.
_GROUP_NORM = re.compile(r"^(gn\d+|.*_gn|.*_ln|post_norm)$")
# flax self.param leaves that the port keeps as parameters of the same name
_PLAIN = {"cosine_weight": 2, "bg_weight": 1}


def _leaf(module_path, leaf: str, arr: np.ndarray):
    where = "/".join([*module_path, leaf])
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        if arr.ndim == 2:
            return "weight", np.ascontiguousarray(arr.T)
        raise ValueError(f"{where}: expected a 4-d conv or 2-d Dense kernel, "
                         f"got {arr.shape}")
    if _PLAIN.get(leaf) == arr.ndim:
        return leaf, arr
    if leaf == "bias" and arr.ndim == 1:
        return "bias", arr
    if leaf == "scale" and arr.ndim == 1:
        is_gn = bool(module_path) and _GROUP_NORM.match(module_path[-1])
        return ("weight" if is_gn else "scale"), arr
    if arr.ndim == 0:
        return leaf, arr
    raise ValueError(f"{where}: no port counterpart for a leaf of shape "
                     f"{arr.shape}")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (nested dicts of arrays) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, [*path, key])
                continue
            name, arr = _leaf(path, key, np.asarray(val, np.float32))
            full = ".".join([*path, name])
            if full in out:
                raise ValueError(f"two flax leaves map to {full}")
            out[full] = torch.from_numpy(np.array(arr, np.float32))

    walk(params, [])
    return out


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax param tree into ``model``; every key must match."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
