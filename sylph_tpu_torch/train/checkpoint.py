"""Checkpoints and weight loading (port of sylph_tpu/train/checkpoint.py).

  * ``CheckpointManager``: periodic ``torch.save`` of the whole train state
    (the model's state_dict, the optimizer's count and momentum, the EMA,
    the step) as ``step_XXXXXXXX.pt`` in one directory, the newest
    ``max_to_keep`` kept, and resume from the newest;
  * ``load_params_any``: raw model weights from a flat ``.npz`` in the flax
    layout (``a/b/c`` keys, the layout of the JAX package's
    ``tools/convert_checkpoint.py``) as a nested dict, or from one of this
    module's checkpoints (a ``.pt`` file or its directory) as a state_dict.
    Orbax directories cannot be read without JAX and raise; detectron2
    ``.pth``/``.pkl`` files are converted by ``utils/convert_d2.py``;
  * ``filter_params_by_module`` (MODEL.WEIGHTS_FILTER_BY_MODULE) and
    ``merge_state_dict``: loaded leaves overlay the model's, a shape
    mismatch is skipped, and a checkpoint where most leaves mismatch is
    refused;
  * ``save_code_bank`` / ``load_code_bank``: a code bank as an ``.npz`` of
    numpy arrays with its ``class_names``, the JAX package's file format.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..models.resnet import stem_kernel_from_s2d, stem_kernel_to_s2d

_CKPT = re.compile(r"^step_(\d{8})\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _CKPT.match, os.listdir(self.directory)) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, state) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(step))
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load the newest (or the given) checkpoint into ``state``; returns
        ``(state, step)``, step 0 when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, 0
        state.load_state_dict(torch.load(self.path(step), map_location="cpu",
                                         weights_only=True))
        return state, step


def _is_port_checkpoint_dir(path: str) -> bool:
    return os.path.isdir(path) and any(_CKPT.match(f)
                                       for f in os.listdir(path))


def load_params_any(path: str) -> Union[Dict, Dict[str, torch.Tensor]]:
    """Raw weights as stored, with no template: a nested flax-layout dict of
    numpy arrays from a ``.npz``, or the model state_dict of a port
    checkpoint (file or directory, newest step)."""
    if path.endswith(".npz"):
        flat = np.load(path)
        out: Dict = {}
        for k in flat.files:
            node = out
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[k]
        return out
    if _is_port_checkpoint_dir(path):
        path = CheckpointManager(path).path(
            CheckpointManager(path).latest_step())
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu",
                          weights_only=True)["model"]
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} looks like an orbax checkpoint directory of the JAX "
            "package, which cannot be read without JAX; write its params "
            "as a flat .npz with the JAX package's "
            "tools/convert_checkpoint.py and load that")
    raise NotImplementedError(
        f"cannot load {path}: this reads flat .npz files (flax layout) and "
        "the port's own .pt checkpoints; a detectron2 .pth/.pkl goes "
        "through utils/convert_d2.py::convert_detectron2_checkpoint")


def filter_params_by_module(params: Mapping, prefixes: List[str]) -> Dict:
    """Drop every leaf whose flax path ("a/b/c") starts with a prefix. Takes
    a nested flax-layout dict, or a flat state_dict whose dotted keys are
    read as paths."""
    if not prefixes:
        return dict(params)

    def keep(path: str) -> bool:
        return not any(path.startswith(p) for p in prefixes)

    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return {k: v for k, v in params.items()
                if keep(k.replace(".", "/"))}

    def walk(node, path=""):
        out = {}
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, Mapping):
                child = walk(v, p)
                if child:
                    out[k] = child
            elif keep(p):
                out[k] = v
        return out

    return walk(params)


@torch.no_grad()
def merge_state_dict(model: nn.Module, loaded: Mapping[str, torch.Tensor]
                     ) -> nn.Module:
    """Overlay ``loaded`` onto the model's state: keys the model lacks are
    ignored; a 7x7 stride-2 stem kernel loads into a space-to-depth stem
    (TPU.S2D_STEM) and back, converted exactly (``stem_kernel_to_s2d``,
    ``stem_kernel_from_s2d``); other shape-mismatched leaves are skipped
    with a warning (the TFA flow loads a C_base-class head into a
    NUM_CLASSES one); when more leaves are skipped than merged the
    checkpoint is refused as the wrong one."""
    log = logging.getLogger(__name__)
    own = model.state_dict()
    skipped, merged = [], 0
    for k, v in loaded.items():
        if k not in own:
            continue
        v = _stem_to(torch.as_tensor(v), tuple(own[k].shape))
        if tuple(own[k].shape) != tuple(v.shape):
            skipped.append((k, tuple(v.shape), tuple(own[k].shape)))
            log.warning("merge_state_dict: skipping %s: checkpoint shape %s "
                        "!= model shape %s", *skipped[-1])
            continue
        own[k].copy_(torch.as_tensor(v))
        merged += 1
    if skipped and len(skipped) > merged:
        raise ValueError(
            f"merge_state_dict: {len(skipped)} of {len(skipped) + merged} "
            f"checkpoint leaves mismatch the model (e.g. {skipped[:3]}): "
            "the wrong checkpoint for this architecture, refusing to "
            "continue on mostly-random weights")
    return model


def _stem_to(v: torch.Tensor, shape) -> torch.Tensor:
    """``v`` converted between the 7x7 stem kernel (O, C, 7, 7) and the
    space-to-depth one (O, 4C, 4, 4) when ``shape`` is the other of the
    pair; otherwise ``v`` as it is."""
    s = tuple(v.shape)
    if len(s) != 4 or len(shape) != 4:
        return v
    if s[2:] == (7, 7) and shape == (s[0], 4 * s[1], 4, 4):
        return stem_kernel_to_s2d(v)
    if shape[2:] == (7, 7) and s == (shape[0], 4 * shape[1], 4, 4):
        return stem_kernel_from_s2d(v)
    return v


# ---------------------------------------------------------------- code banks
def save_code_bank(path: str, bank: Mapping[str, np.ndarray],
                   class_names: Optional[List[str]] = None) -> None:
    """Write ``bank`` (name -> array) to the ``.npz`` at ``path``, with
    ``class_names`` as one more array when given."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = dict(bank)
    if class_names is not None:
        payload["class_names"] = np.asarray(class_names)
    np.savez(path, **payload)


def load_code_bank(path: str) -> Dict[str, np.ndarray]:
    """Every array of a bank written by ``save_code_bank`` (either
    package's), ``class_names`` included."""
    data = np.load(path, allow_pickle=False)
    return {k: data[k] for k in data.files}
