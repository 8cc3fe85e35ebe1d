"""Seeded weights for a detector's state dict, made on its device.

No trained checkpoint is in the repository, so the benchmark draws every
parameter and buffer from ``--seed`` with one ``torch.Generator`` on the
device, in two calls (one normal and one uniform draw over all the values),
and the same dict goes to the program and to the reference. The
distributions are chosen so that a full-depth network of random weights
keeps its activations O(1) and gives spread scores:

  * convolution and linear weights: normal / sqrt(fan-in); biases
    0.1 * normal;
  * frozen BN: scale gamma / sqrt(var + 1e-5), bias beta - mean * scale,
    with gamma 1 + 0.1 * normal, beta and mean 0.1 * normal and var uniform
    in [0.8, 1.2);
  * GroupNorm: weight 1 + 0.1 * normal, bias 0.1 * normal; learned scalar
    scales 1 + 0.1 * normal;
  * the two-stage heads read maps of standard deviation ~100 with no norm
    before them, so ``GAIN`` scales their first layers down: objectness and
    class logits come out O(1) and box deltas ~0.1 (proposals stay near
    their anchors); the box head's background row is normal / sqrt(1024),
    its bias 0.

Each key is classified by its module's name as the weight conversion pins
it; an unknown name raises.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

GAIN = {"rpn_head.conv": 0.01, "rpn_head.anchor_deltas": 0.1,
        "box_head.fc1": 0.01, "box_head.bbox_pred": 0.1}
BN_EPS = 1e-5
_BN = re.compile(r"(^|\.)(stem_bn1|bn\d|shortcut_bn)$")
_GN = re.compile(r"(^|\.)(gn\d+|\w+_gn|post_norm)$")


def kind(key: str, shape: Tuple[int, ...]) -> str:
    """'bn', 'gn', 'scale', 'bg_weight', 'bg_bias', 'weight' or 'bias'."""
    module, _, leaf = key.rpartition(".")
    if _BN.search(module) and leaf in ("scale", "bias"):
        return "bn"
    if _GN.search(module) and leaf in ("weight", "bias"):
        return "gn"
    if leaf == "scale" and len(shape) == 0:
        return "scale"
    if key.endswith("box_head.bg_weight"):
        return "bg_weight"
    if key.endswith("box_head.bg_bias"):
        return "bg_bias"
    if leaf == "weight" and len(shape) in (2, 4):
        return "weight"
    if leaf == "bias" and len(shape) == 1:
        return "bias"
    raise ValueError(f"no rule for the weight {key!r} {shape}")


def seeded_state_dict(shapes: Dict[str, Tuple[int, ...]], seed: int,
                      device) -> Dict[str, torch.Tensor]:
    """float32 values for every key of ``shapes`` (state-dict order), drawn
    on ``device`` from ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    # frozen BN draws 4 normals and 1 uniform a channel (for its 2 keys)
    n_norm = sum(2 * n if kind(k, shapes[k]) == "bn" else n
                 for k, n in sizes.items())
    normal = torch.randn(n_norm, generator=gen, device=dev)
    uniform = torch.rand(sum(sizes.values()), generator=gen, device=dev)
    out, i, j = {}, 0, 0

    def take(n):
        nonlocal i
        i += n
        return normal[i - n:i]

    bn_pending = {}
    for key, shape in shapes.items():
        n, k = sizes[key], kind(key, shapes[key])
        module = key.rpartition(".")[0]
        if k == "weight":
            fan_in = math.prod(shape[1:])
            v = take(n) * GAIN.get(module, 1.0) / math.sqrt(fan_in)
        elif k == "bias":
            v = 0.1 * take(n)
        elif k == "gn":
            v = (1.0 if key.endswith("weight") else 0.0) + 0.1 * take(n)
        elif k == "scale":
            v = 1.0 + 0.1 * take(n)
        elif k == "bg_weight":
            v = take(n) / math.sqrt(n)
        elif k == "bg_bias":
            v = torch.zeros(shape, device=dev)
        else:  # frozen BN: both keys from one set of statistics
            if module not in bn_pending:
                gamma, beta, mean = 1.0 + 0.1 * take(n), 0.1 * take(n), \
                    0.1 * take(n)
                _ = take(n)  # keeps the draw count at 2 normals a key
                var = 0.8 + 0.4 * uniform[j:j + n]
                j += n
                scale = gamma / torch.sqrt(var + BN_EPS)
                bn_pending[module] = {"scale": scale,
                                      "bias": beta - mean * scale}
            v = bn_pending[module][key.rpartition(".")[2]]
        out[key] = v.reshape(shape).contiguous()
    return out
