"""Carry the JAX package's flax parameters across to the port.

``state_dict_from_jax(params)`` takes a flax param tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
``state_dict``. The port names its submodules after the flax modules
(``backbone.res2_block0.conv1``, ``fcos_head.cls_tower.conv0``,
``code_generator.tower_conv0``, ...), so the mapping is mechanical:

  * conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
  * Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
  * the ROIEncoder's attention ``DenseGeneral`` leaves: ``query``/``key``/
    ``value`` kernels (d, heads, head_dim) -> ``weight`` (heads * head_dim,
    d) with their (heads, head_dim) biases kept, the ``out`` kernel (heads,
    head_dim, d) -> ``weight`` (d, heads * head_dim);
  * GroupNorm and LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
  * FrozenBN ``scale``/``bias`` -> the buffers of the same names;
  * the parameters the heads declare themselves (the two-stage box head's
    ``cosine_weight`` (C+1, D) and ``bg_weight`` (D,), the TFA cosine
    classifier's ``cosine_weight`` (N, C), ``cosine_bias``,
    ``cosine_gn_scale`` and ``cosine_gn_bias``) keep their names and shapes;
  * scalars (``Scale.scale``, ``meta_bias_value``, ``bg_bias``,
    ``cosine_scale_param``, ``cosine_scale``) -> 0-d tensors.

``load_jax_params`` loads the result with ``strict=True``: a key left
unconsumed on either side raises.

``jax_params_from_state_dict`` is the inverse, leaf for leaf: the port's
``state_dict`` (parameters and FrozenBN buffers) back to the flax tree, and
``save_flat_npz`` writes such a tree as a flat ``.npz`` keyed ``a/b/c`` (the
layout the JAX package's quality loops write for a stage's weights and its
``MODEL.WEIGHTS`` reads).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# flax GroupNorm and LayerNorm modules: FCOS towers ``gn{i}``, codegen
# ``{name}_gn`` and ``{name}_ln``, the code post-norm, the ROIEncoder's
# ``fusion_gn``, ``{local,global}_gn{i}``, ``tok_gn{i}`` and ``norm{i}``.
# FrozenBN modules (``bn{i}``, ``stem_bn1``, ``shortcut_bn``) keep ``scale``.
_GROUP_NORM = re.compile(r"^(gn\d+|.*_gn\d*|.*_ln|post_norm|norm\d+)$")
# flax self.param leaves that the port keeps as parameters of the same name
_PLAIN = {"cosine_weight": 2, "bg_weight": 1, "cosine_bias": 1,
          "cosine_gn_scale": 1, "cosine_gn_bias": 1}
# flax MultiHeadDotProductAttention's DenseGeneral projections
_HEADS_IN = ("query", "key", "value")


def _leaf(module_path, leaf: str, arr: np.ndarray):
    where = "/".join([*module_path, leaf])
    module = module_path[-1] if module_path else ""
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        if arr.ndim == 2:
            return "weight", np.ascontiguousarray(arr.T)
        if arr.ndim == 3 and module in _HEADS_IN:     # (d, heads, head_dim)
            return "weight", np.ascontiguousarray(
                arr.reshape(arr.shape[0], -1).T)
        if arr.ndim == 3 and module == "out":         # (heads, head_dim, d)
            return "weight", np.ascontiguousarray(
                arr.reshape(-1, arr.shape[-1]).T)
        raise ValueError(f"{where}: expected a 4-d conv, a 2-d Dense or an "
                         f"attention kernel, got {arr.shape}")
    if _PLAIN.get(leaf) == arr.ndim:
        return leaf, arr
    if leaf == "bias" and (arr.ndim == 1 or (arr.ndim == 2
                                             and module in _HEADS_IN)):
        return "bias", arr
    if leaf == "scale" and arr.ndim == 1:
        is_gn = bool(_GROUP_NORM.match(module))
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


def _flax_leaf(module_path, leaf: str, arr: np.ndarray, siblings: Mapping):
    """The inverse of ``_leaf``: one port leaf -> (flax name, array)."""
    where = ".".join([*module_path, leaf])
    module = module_path[-1] if module_path else ""
    if leaf == "weight":
        if arr.ndim == 4:                             # (out, in, kh, kw)
            return "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        if arr.ndim == 2 and module in _HEADS_IN:     # (heads * hd, d)
            heads, hd = siblings[(*module_path, "bias")].shape
            return "kernel", np.ascontiguousarray(
                arr.T.reshape(arr.shape[1], heads, hd))
        attention_out = (module == "out" and np.ndim(siblings.get(
            (*module_path[:-1], "query", "bias"))) == 2)
        if arr.ndim == 2 and attention_out:           # (d, heads * hd)
            heads, hd = siblings[(*module_path[:-1], "query", "bias")].shape
            return "kernel", np.ascontiguousarray(
                arr.T.reshape(heads, hd, arr.shape[0]))
        if arr.ndim == 2:
            return "kernel", np.ascontiguousarray(arr.T)
        if arr.ndim == 1:                             # GroupNorm, LayerNorm
            return "scale", arr
        raise ValueError(f"{where}: no flax counterpart for a weight of "
                         f"shape {arr.shape}")
    if _PLAIN.get(leaf) == arr.ndim or leaf in ("bias", "scale"):
        return leaf, arr
    if arr.ndim == 0:
        return leaf, arr
    raise ValueError(f"{where}: no flax counterpart for a leaf of shape "
                     f"{arr.shape}")


def jax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict:
    """The port's ``state_dict`` -> a flax param tree (nested dicts of
    float32 numpy arrays): ``state_dict_from_jax``'s inverse."""
    flat = {tuple(k.split(".")): v.detach().cpu().float().numpy()
            for k, v in state_dict.items()}
    out: Dict = {}
    for path, arr in flat.items():
        name, leaf = _flax_leaf(path[:-1], path[-1], arr, flat)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if name in node:
            raise ValueError(f"two port leaves map to {'/'.join(path[:-1])}"
                             f"/{name}")
        node[name] = np.array(leaf, np.float32)
    return out


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested param tree as flat ``a/b/c`` keys (the JAX package's
    quality-loop ``_flatten``)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_params(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def save_flat_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write the port's ``state_dict`` as a flat ``.npz`` of flax params,
    which the JAX package's MODEL.WEIGHTS and the port's both load."""
    np.savez(path, **flatten_params(jax_params_from_state_dict(state_dict)))
    return path


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax param tree into ``model``; every key must match."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
