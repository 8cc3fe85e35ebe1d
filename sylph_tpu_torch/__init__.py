"""sylph_tpu_torch — the PyTorch/CUDA port of sylph_tpu.

A second package beside the JAX one. It imports torch, numpy, PIL and yaml,
never jax, flax or anything of ``sylph_tpu``: what it needs of the JAX
package's host code (config, transforms, location grids) it keeps as its own
copy. Modules mirror the JAX layout (``models/resnet.py``, ``ops/nms.py``,
...) so each counterpart is easy to find.

Device policy: entry points (``build_model_from_cfg``, ``SylphPredictor``)
take ``device=`` and default to ``"cuda"``; without a card they raise unless
the caller asked for ``"cpu"``. Inside, each hand-written kernel's wrapper
launches the kernel for CUDA tensors and runs its plain PyTorch version only
for CPU tensors (or where a caller names ``impl="reference"``).
"""

from .config import CfgNode, get_default_cfg
from .runner import build_model_from_cfg, resolve_device

__all__ = ["CfgNode", "get_default_cfg", "build_model_from_cfg",
           "resolve_device"]
