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

Importing the package tunes glibc's allocator (``_tune_malloc``), as the
JAX package does.
"""

from .config import CfgNode, get_default_cfg
from .runner import build_model_from_cfg, resolve_device


def _tune_malloc() -> None:
    """Keep large freed buffers in the glibc arena instead of unmapping them.

    glibc serves big allocations through mmap and returns them to the OS on
    free, so every image batch the host loaders build faults its pages in
    anew. Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD to 1 GiB lets freed
    batch buffers reuse warm arena pages: the allocator's counterpart of
    ``data/loader.py::_BufferPool``. Does nothing where glibc is absent.
    """
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass


_tune_malloc()

__all__ = ["CfgNode", "get_default_cfg", "build_model_from_cfg",
           "resolve_device"]
