"""What the port's benchmark and probe drivers share: the flagship model
with weights from the flax initializers' distributions, the seeded query
images and code bank of the root ``bench.py``, the query path
(``forward_instances`` then ``decode_proposals``), the work it does, and
the timers.

Every function takes its sizes and its device as arguments, so the tests
run the drivers small on the CPU; each driver's ``main`` passes the root
driver's constants. A CUDA device without a card raises
(``runner.resolve_device``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.layers import Conv2d
from ..models.meta_arch import MetaOneStageDetector
from ..ops.decode import DecodeCfg, decode_proposals
from ..ops.locations import build_location_grid
from ..runner import init_train_weights, resolve_device

CANVAS = (768, 1280)  # fits the 800x1333 shortest-edge eval resize, /128
STRIDES = (8, 16, 32, 64, 128)
SIZES_OF_INTEREST = (64, 128, 256, 512)
N_CLASSES = 20
# NVIDIA's data sheet for the H100 SXM, dense, at the full 700 W limit:
# tensor-core bf16.
BF16_DENSE_FLOPS = 989e12


def flagship_model(device, depth: int = 50, num_classes: int = 60,
                   dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                   **kwargs) -> MetaOneStageDetector:
    """Meta-FCOS with the CodeGenerator (the reference Meta-FCOS-finetune
    model) on ``device``, in eval mode, its weights drawn by
    ``init_train_weights`` from ``seed``: float32 parameters, activations
    in ``dtype``."""
    dev = resolve_device(device)
    kwargs.setdefault("code_generator_name", "CodeGenerator")
    with torch.device("meta"):
        model = MetaOneStageDetector(depth=depth, num_classes=num_classes,
                                     compute_dtype=dtype, **kwargs)
    model = model.to_empty(device=dev)
    init_train_weights(model, seed)
    return model.eval()


def store_params(model: torch.nn.Module, dtype: torch.dtype
                 ) -> torch.nn.Module:
    """Every floating parameter and buffer held in ``dtype``: the JAX
    package's ``bf16_resident`` for ``torch.bfloat16``."""
    return model.to(dtype)


def query_images(batch: int, canvas: Sequence[int], device,
                 seed: int = 0) -> torch.Tensor:
    """``RandomState(seed).rand(batch, H, W, 3)`` in float32 on ``device``:
    values in [0, 1), as the root drivers feed them."""
    x = np.random.RandomState(seed).rand(batch, *canvas, 3)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def bank_inputs(n_classes: int = N_CLASSES, size: int = 192, seed: int = 7
                ) -> Tuple[np.ndarray, np.ndarray]:
    """bench.py's support crops (n, size, size, 3) in [0, 255) and one box
    each, drawn in its order from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    sup = rng.rand(n_classes, size, size, 3).astype(np.float32) * 255
    boxes = (rng.rand(n_classes, 4).astype(np.float32) * 60
             + np.array([10, 10, 100, 100], np.float32))
    return sup, boxes


@torch.inference_mode()
def make_bank(model: MetaOneStageDetector, sup: torch.Tensor,
              boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One class per support crop: raw codes (one shot each), then
    ``normalize_code``, as bench.py's ``make_bank``."""
    valid = torch.ones((sup.shape[0],), dtype=torch.bool, device=sup.device)
    raw = model.forward_class_code(sup, boxes, valid, 1, False)
    return model.normalize_code({"cls_conv": raw["cls_conv"],
                                 "cls_bias": raw["cls_bias"]})


def random_bank(n_classes: int, device, seed: int = 7
                ) -> Dict[str, torch.Tensor]:
    """``RandomState(seed).rand(n, 256)`` kernels and zero biases: the bank
    of the stage breakdown and the probes."""
    conv = np.random.RandomState(seed).rand(n_classes, 256)
    return {"cls_conv": torch.from_numpy(conv.astype(np.float32)).to(device),
            "cls_bias": torch.zeros((n_classes,), device=device)}


class QueryPath:
    """The conditioned query path at one canvas and batch:
    ``forward_instances`` on a code bank, then ``decode_proposals`` (the
    NMS kernel on a CUDA device)."""

    def __init__(self, model: MetaOneStageDetector,
                 bank: Dict[str, torch.Tensor], canvas: Sequence[int],
                 batch: int, dcfg: DecodeCfg = DecodeCfg()):
        dev = next(model.parameters()).device
        grid = build_location_grid(tuple(canvas), STRIDES,
                                   list(SIZES_OF_INTEREST))
        self.model, self.bank, self.dcfg = model, bank, dcfg
        self.locations = torch.from_numpy(grid.locations).to(dev)
        self.strides = torch.from_numpy(grid.strides).to(dev)
        self.level_splits = tuple(h * w for h, w in grid.level_sizes)
        self.sizes = torch.tensor([list(canvas)] * batch, dtype=torch.int32,
                                  device=dev)

    def dense(self, images: torch.Tensor):
        return self.model.forward_instances(images, self.bank)

    def decode(self, out):
        return decode_proposals(out.logits, out.reg, out.ctrness, out.iou,
                                self.locations, self.strides, self.sizes,
                                self.dcfg, self.level_splits)

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor):
        return self.decode(self.dense(images))


@torch.inference_mode()
def query_flops_per_image(path: QueryPath, canvas: Sequence[int]) -> Dict:
    """The multiply-adds of one image's query path, counted from the
    shapes each convolution gives on one image (2 FLOP a multiply-add)
    plus the conditional classifier's product; elementwise work (norms,
    activations, decode) is left out. -> {"total", "backbone_fpn",
    "head"} in FLOP."""
    counts = {"backbone_fpn": 0, "head": 0}
    hooks = []
    for name, mod in path.model.named_modules():
        if isinstance(mod, Conv2d):
            part = ("backbone_fpn" if name.startswith(("backbone.", "fpn."))
                    else "head")

            def hook(m, args, out, part=part):
                per_out = (m.in_channels // m.groups * m.kernel_size[0]
                           * m.kernel_size[1])
                counts[part] += 2 * per_out * out[0].numel()
            hooks.append(mod.register_forward_hook(hook))
    dev = next(path.model.parameters()).device
    try:
        out = path.dense(torch.zeros((1, *canvas, 3), device=dev))
    finally:
        for h in hooks:
            h.remove()
    k, n = out.logits.shape[1:]
    counts["head"] += 2 * k * n * path.bank["cls_conv"].shape[1]
    counts["total"] = counts["backbone_fpn"] + counts["head"]
    return counts


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mean_call_s(fn: Callable, args: Sequence, device, iters: int = 30,
                warmup: int = 5) -> float:
    """bench.py's ``_bench_fn``: ``warmup`` calls, then the mean of
    ``iters`` back-to-back calls between two synchronisations."""
    for _ in range(warmup):
        fn(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(device)
    return (time.perf_counter() - t0) / iters


def call_times_s(fn: Callable, args: Sequence, device, iters: int
                 ) -> List[float]:
    """The seconds of each of ``iters`` calls, each synchronised."""
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        times.append(time.perf_counter() - t0)
    return times


def best_call_ms(fn: Callable, args: Sequence, device, iters: int) -> float:
    """One warm call, then the best of ``iters`` calls, each synchronised."""
    fn(*args)
    return min(call_times_s(fn, args, device, iters)) * 1e3


def device_name(device) -> str:
    """The card's name on CUDA, else ``"cpu"``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

