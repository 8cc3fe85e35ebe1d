"""Launch helpers (port of sylph_tpu/utils/setup.py): the environment
summary, the config diff and ``setup_after_launch``, which writes
``config.yaml``, ``config_diff.yaml`` and ``env.txt`` into the output
directory (reference tools/setup.py: setup_after_launch, dump_cfg).
"""

from __future__ import annotations

import os
import platform
import sys
from typing import Dict


def collect_env_info() -> str:
    """Python, torch, CUDA and cuDNN versions and the cards torch sees."""
    import numpy as np
    import torch

    lines = [f"python: {sys.version.split()[0]} ({platform.platform()})",
             f"torch: {torch.__version__} (CUDA {torch.version.cuda}, "
             f"cuDNN {torch.backends.cudnn.version()})",
             f"numpy: {np.__version__}"]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        lines.append(f"devices: {n} x {torch.cuda.get_device_name(0)}")
    else:
        lines.append("devices: no CUDA device")
    for var in ("CUDA_VISIBLE_DEVICES", "SYLPH_TEST_MODE"):
        if os.environ.get(var):
            lines.append(f"{var}={os.environ[var]}")
    return "\n".join(lines)


def cfg_diff(cfg: Dict, default: Dict) -> Dict:
    """Nested diff: the keys of ``cfg`` whose value differs from
    ``default``'s (the reference dumps it beside the full config)."""
    out = {}
    for k, v in cfg.items():
        d = default.get(k) if isinstance(default, dict) else None
        if isinstance(v, dict):
            sub = cfg_diff(v, d if isinstance(d, dict) else {})
            if sub:
                out[k] = sub
        elif d != v:
            out[k] = v
    return out


def setup_after_launch(cfg, output_dir: str, default_cfg=None) -> None:
    """Create ``output_dir``; write the full config, its diff against
    ``default_cfg`` (when given) and the environment summary there."""
    import yaml

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    if default_cfg is not None:
        with open(os.path.join(output_dir, "config_diff.yaml"), "w") as f:
            yaml.safe_dump(_plain(cfg_diff(cfg, default_cfg)), f,
                           sort_keys=False)
    env = collect_env_info()
    with open(os.path.join(output_dir, "env.txt"), "w") as f:
        f.write(env + "\n")
    print("[setup] environment:\n" + env)


def _plain(d):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in d.items()}
