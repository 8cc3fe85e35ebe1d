"""int8 weight residency for the backbone (the port's counterpart of
``tools/bench_int8_probe.py``).

    python3 -m sylph_tpu_torch.tools.bench_int8_probe [--batch 48]
        [--iters 20] [--device cuda]

Asks whether halving the weight reads again, after bf16 residency, buys
anything at batch 48, and what it costs numerically. Variant A holds every
floating parameter and buffer in bfloat16. Variant B packs each conv kernel
with at least 8 output channels as symmetric per-output-channel int8 with a
float32 scale, keeps everything else in bfloat16, and dequantizes to
bfloat16 inside the timed forward. The port's kernels are OIHW, so the
scale reduces over (I, H, W) where the JAX package's HWIO kernels reduce
over (H, W, I); ``torch.round`` rounds half to even, as ``jnp.round`` does.
Both run ``forward_base`` (backbone, FPN, the FCOS head's logits) at
768x1280 in one process, A then B then A again to bound the drift: 5
warm-up calls, then the mean of ``--iters``. Prints one JSON line with the
times and the max |logit delta| of B against A.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence, Tuple, Union

import torch
from torch.func import functional_call

from ..runner import resolve_device
from .bench_common import (CANVAS, device_name, flagship_model, mean_call_s,
                           query_images)

Packed = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def pack(x: torch.Tensor) -> Packed:
    """A conv kernel (O, I, H, W) with O >= 8 -> (int8 values, float32
    scales (O, 1, 1, 1)); anything else -> bfloat16."""
    if x.ndim == 4 and x.shape[0] >= 8:
        s = x.abs().amax(dim=(1, 2, 3), keepdim=True)
        s = torch.clamp(s, min=1e-8) / 127.0
        q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        return q, s.float()
    return x.bfloat16()


def unpack(x: Packed) -> torch.Tensor:
    if isinstance(x, tuple):
        q, s = x
        return q.bfloat16() * s.bfloat16()
    return x


def run(device="cuda", batch: int = 48, iters: int = 20, depth: int = 50,
        canvas: Sequence[int] = CANVAS) -> Dict:
    dev = resolve_device(device)
    model = flagship_model(dev, depth=depth, code_generator_name="none")
    images = query_images(batch, canvas, dev)
    state = {k: v for k, v in model.state_dict().items()
             if v.is_floating_point()}
    p_bf16 = {k: v.bfloat16() for k, v in state.items()}
    p_int8 = {k: pack(v) for k, v in state.items()}

    @torch.inference_mode()
    def fwd_bf16(p, images):
        return functional_call(model, p, (images,)).logits

    @torch.inference_mode()
    def fwd_int8(pq, images):
        p = {k: unpack(v) for k, v in pq.items()}
        return functional_call(model, p, (images,)).logits

    t_bf16 = mean_call_s(fwd_bf16, (p_bf16, images), dev, iters)
    logits_bf16 = fwd_bf16(p_bf16, images)
    t_int8 = mean_call_s(fwd_int8, (p_int8, images), dev, iters)
    logits_int8 = fwd_int8(p_int8, images)
    t_bf16b = mean_call_s(fwd_bf16, (p_bf16, images), dev, iters)

    delta = float((logits_int8.float() - logits_bf16.float()).abs().max())
    rng = float(logits_bf16.max() - logits_bf16.min())
    return {
        "batch": batch,
        "bf16_ms": round(t_bf16 * 1e3, 2),
        "bf16_ms_repeat": round(t_bf16b * 1e3, 2),
        "int8_ms": round(t_int8 * 1e3, 2),
        "bf16_img_s": round(batch / t_bf16, 1),
        "int8_img_s": round(batch / t_int8, 1),
        "max_logit_delta": round(delta, 4),
        "logit_range": round(rng, 2),
        "int8_kernels": sum(isinstance(v, tuple) for v in p_int8.values()),
        "device": device_name(dev),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    line = run(args.device, args.batch, args.iters)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
