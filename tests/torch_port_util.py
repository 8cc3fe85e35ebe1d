"""Helpers shared by the tests that hold sylph_tpu_torch against sylph_tpu.

Weights are made once, as flax param trees of numpy arrays, and carried to
the port with ``sylph_tpu_torch.utils.convert_weights.state_dict_from_jax``;
inputs are made from a seed with numpy and handed to both packages.
"""

import jax
import numpy as np


def to_numpy(tree):
    """A flax param tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def merge_trees(a, b):
    """Deep union of two nested dicts (``b`` wins on shared leaves)."""
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def randomize(params, rng):
    """Replace every leaf by detectron2-scaled random values: fan-in scaled
    conv kernels, scales near 1, biases near 0."""

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            fan_in = int(np.prod(shape[:3]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "meta_bias_value":
            return np.asarray(-4.6 + 0.1 * rng.randn(), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, to_numpy(params))
