"""The output check's shared pieces.

After the window, a sample drawn from the seed of the completed work is
recomputed by ``port_bench/reference`` in float32 with TF32 off, from the
same state dict, code bank and images (supports), a few images at a time;
each driver (``drivers/<driver>.<family>.py``) says which numbers it
compares, and the cell's ``limits/<workload>.json`` holds each under its
own limit. Here: the draw of the sample, the arithmetic the comparisons
share, and the verdict.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .traffic import sub_seed

MATCH_IOU = 0.9
UNMATCHED_GAP = 10.0  # the log gap of a served box no candidate matches


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` of ``range(n)`` (all of them when k >= n), drawn from the seed."""
    rng = np.random.RandomState(sub_seed(seed, "sample") % 2 ** 32)
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def log_odds(score) -> np.ndarray:
    """An FCOS score s is sqrt(p * q) for two probabilities: the log-odds
    of s^2, which undo the sigmoids' flattening near 0 and 1."""
    q = np.clip(np.asarray(score, np.float64) ** 2, 1e-7, 1 - 1e-7)
    return np.log(q) - np.log1p(-q)


def update_max(out: Dict[str, float], key: str, values) -> None:
    """``out[key]``, raised to the largest of ``values`` (if any)."""
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size:
        out[key] = max(out[key], float(values.max()))


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) boxes -> (N, M) IoU."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(-1)  # noqa: E731
    union = area(a)[:, None] + area(b)[None] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def unmatched(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many of the boxes ``a`` have no box of ``b`` at IoU >=
    ``MATCH_IOU`` (all of them when ``b`` is empty)."""
    if len(a) == 0:
        return 0
    if len(b) == 0:
        return len(a)
    return int((iou_matrix(a, b).max(1).values < MATCH_IOU).sum())


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for every limited number, and whether
    each is within its limit."""
    table = {k: {"value": values[k], "limit": lim}
             for k, lim in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return {"table": table, "correct": bool(ok)}
