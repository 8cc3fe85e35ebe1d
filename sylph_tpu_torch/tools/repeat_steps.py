"""Does a training step repeat its bits on the card?

    python3 -m sylph_tpu_torch.tools.repeat_steps [--out FILE]

Three training steps at full width, each from one saved train state and
one batch of its loader:

  * ``rcnn_pretrain``: chip_smoke.py phase 15's two-stage pretraining step
    (Meta-RCNN-FPN-pretrain.yaml on one card: batch 32 in 4 micro-groups
    at 1024x1024, everything but FrozenBN trained);
  * ``rcnn_episodic``: phase 14's episodic step (Meta-RCNN-FPN-finetune.
    yaml: 48 episodes in one group, backbone and FPN frozen);
  * ``fcos_episodic``: phase 8's one-stage episodic step (Meta-FCOS-
    finetune.yaml: 48 episodes in 16 micro-groups, device RandAugment);
  * ``rcnn_quality``: the ``tfa_rcnn`` quality recipe's pretraining step
    (``tools/quality_loop.py``: R-18, FC 128, batch 8 at 128x128, fp32) on
    its learnable synthetic set, the run that read another nAP each time
    at one SEED on the card.

For each step (``repeat_case``): the step run three times from the saved
state, after one warm-up run,
with the kernels as the train steps choose them and with cuDNN left free
(``free_kernels``: the port before it held the steps to deterministic
kernels), the digest of every parameter, momentum and EMA leaf after each
run, the leaves that differ, and the ms a step. Then the bisection
(``bisect_case``): one forward and backward, run twice, with a hook on
every module that owns parameters recording the gradients that leave it
and reach it. A module whose output gradients repeat while its input or
parameter gradients do not is where a backward varies. The ops that torch
itself marks as nondeterministic on the card (its warnings under
``torch.use_deterministic_algorithms(True, warn_only=True)``) and whether
ROIAlign's backward repeats (``roi_align_repeats``: the pretraining step's
sampled ROIs of one image, forward and backward twice) complete the
picture. Last, the cost of drawing the sampling priorities on the CPU: a
host ``torch.rand`` of B x K plus its copy to the card against the same
draw on the card (``draw_ms``).

Prints one JSON line per step and writes them all to ``--out`` (default
``repeat_steps.json``), with the card's ``name, power.limit``. Needs a
card: it raises without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import tempfile
import time
import warnings
from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import torch

from ..data.catalog import register_all_coco, register_all_lvis
from ..data.synthetic import make_synthetic_coco, make_synthetic_lvis
from ..meta_faster_rcnn_runner import MetaFasterRCNNRunner, train_anchor_grid
from ..models import rcnn
from ..ops.roi_align import multilevel_roi_align
from ..runner import MetaFCOSRunner
from ..train import steps as train_steps
from . import quality_loop
from .profile_meta_test import DATA, RCNN_DATA
from .profile_train import rcnn_train_cfg, train_cfg

# rcnn_quality last: its learnable set replaces the COCO catalog entries
STEPS = ("rcnn_pretrain", "rcnn_episodic", "fcos_episodic", "rcnn_quality")


def step_cfg(name: str, work: str):
    """-> (runner, cfg) of the step ``name`` on one card. The three
    full-width steps train on what ``write_data(work)`` registered;
    ``rcnn_quality`` writes and registers its learnable set under
    ``work``."""
    if name == "rcnn_pretrain":
        return MetaFasterRCNNRunner(), rcnn_train_cfg("pretrain", 1)
    if name == "rcnn_episodic":
        return MetaFasterRCNNRunner(), rcnn_train_cfg("episodic", 1)
    if name == "fcos_episodic":
        return MetaFCOSRunner(), train_cfg("episodic", 1)
    if name == "rcnn_quality":
        quality_loop.prepare_data(SimpleNamespace(
            data_root=os.path.join(work, "learnable"), hard=False))
        runner = MetaFasterRCNNRunner()
        cfg = quality_loop.build_tfa_rcnn_pretrain_cfg(runner, 400, 0.01)
        cfg.OUTPUT_DIR = ""
        return runner, cfg
    raise ValueError(f"unknown step {name}: one of {STEPS}")


def write_data(work: str) -> None:
    """The synthetic COCO and LVIS trees the steps train on, registered."""
    coco = os.path.join(work, "coco")
    make_synthetic_coco(coco, **DATA)
    register_all_coco(coco)
    lvis, images = os.path.join(work, "lvis"), os.path.join(work, "images")
    make_synthetic_lvis(lvis, images, **RCNN_DATA)
    register_all_lvis(lvis, images)


class Case:
    """One step with its train state, the state saved on the CPU and one
    batch of its loader: ``run`` restores the state and steps once."""

    def __init__(self, runner, cfg, model=None):
        self.runner, self.cfg = runner, cfg
        self.model = model if model is not None else runner.build_model(
            cfg, init="train")
        self.state, _, _ = runner._common_train_setup(cfg, self.model)
        self.step = runner.make_train_step(cfg, self.model)
        loader = (runner._episodic_loader(cfg)
                  if cfg.MODEL.META_LEARN.EPISODIC_LEARNING
                  else runner._pretrain_loader(cfg))
        self.batch = next(loader)
        loader.close()
        # cloned: on the CPU ``state_dict`` shares the live tensors
        self.saved = _clone(self.state.state_dict())

    def run(self) -> Tuple[Dict[str, Tuple[int, int]], float]:
        """Restore the saved state, step once -> (each leaf's fingerprint,
        ms of the step on the host clock, synchronized)."""
        self.state.load_state_dict(self.saved)
        _sync()
        t0 = time.perf_counter()
        self.state, _ = self.step(self.state, self.batch)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        return leaf_fingerprints(self.state), ms


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def fingerprint(t: torch.Tensor) -> Tuple[int, int]:
    """Two sums over a tensor's bits, computed where it lies: any change of
    a bit changes them but for a chance of about 2^-64. Equal tensors give
    equal fingerprints."""
    t = t.detach().contiguous()
    ints = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()]).reshape(-1).long()
    w = torch.arange(ints.numel(), device=t.device) % 65521 + 1
    return int(ints.sum()), int((ints * w).sum())


def leaf_fingerprints(state) -> Dict[str, Tuple[int, int]]:
    """Every leaf of a train state: the model's parameters and buffers, the
    momentum, the EMA, the step count."""
    out = {f"model/{k}": fingerprint(v)
           for k, v in state.model.state_dict().items()}
    out.update({f"trace/{n}": fingerprint(t)
                for n, t in zip(state.tx.names, state.tx.trace)})
    for k, v in (state.ema or {}).items():
        out[f"ema/{k}"] = fingerprint(v)
    out["count"] = (state.tx.count, 0)
    return out


def state_digest(state) -> str:
    """sha256 over every leaf of a train state's ``state_dict``."""
    h = hashlib.sha256()
    sd = state.state_dict()
    trees = [("model", sd["model"]), ("trace", sd["tx"]["trace"]),
             ("ema", sd["ema"] or {})]
    for tree, leaves in trees:
        for name, v in leaves.items():
            h.update(f"{tree}/{name}".encode())
            h.update(v.contiguous().reshape(-1).view(torch.uint8).numpy())
    h.update(str(sd["step"]).encode())
    return h.hexdigest()


def differing(a: Dict, b: Dict) -> List[str]:
    return sorted(k for k in a if a[k] != b.get(k))


@contextlib.contextmanager
def free_kernels():
    """cuDNN left to pick any algorithm, as every step ran before the port
    held its steps to deterministic kernels: the steps' scope
    (``steps.deterministic_kernels``) replaced by a no-op and cuDNN's
    deterministic flag off; both restored on exit."""
    saved = train_steps.deterministic_kernels
    flag = torch.backends.cudnn.deterministic
    train_steps.deterministic_kernels = contextlib.nullcontext
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        train_steps.deterministic_kernels = saved
        torch.backends.cudnn.deterministic = flag


def repeat_case(case: Case, scope: Callable = contextlib.nullcontext,
                runs: int = 2) -> Dict:
    """The step ``runs`` times from the saved state under ``scope`` -> the
    leaves that differ from the first run, each run's ms and whether all
    repeat."""
    with scope():
        results = [case.run() for _ in range(runs)]
    first = results[0][0]
    diff = sorted({k for fp, _ in results[1:] for k in differing(first, fp)})
    return {"repeats": not diff, "leaves": len(first),
            "differing_leaves": len(diff), "differing": diff[:40],
            "ms": [ms for _, ms in results]}


# ------------------------------------------------------------- bisection
class _GradHooks:
    """Backward hooks on every module that owns parameters: each call's
    gradients leaving it (w.r.t. its output) and reaching it (w.r.t. its
    input), fingerprinted in call order."""

    def __init__(self, model: torch.nn.Module):
        self.calls: Dict[str, List] = {}
        self.handles = []
        for name, mod in model.named_modules():
            if any(True for _ in mod.parameters(recurse=False)):
                self.handles.append(mod.register_full_backward_hook(
                    self._hook(name)))

    def _hook(self, name: str):
        def hook(_, grad_in, grad_out):
            self.calls.setdefault(name, []).append((
                [fingerprint(g) for g in grad_out if g is not None],
                [fingerprint(g) for g in grad_in if g is not None]))
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _backward_once(case: Case):
    """One forward and backward of the step from the saved state, the
    update skipped -> (parameter gradient fingerprints, hooks' calls)."""
    case.state.load_state_dict(case.saved)
    hooks = _GradHooks(case.model)
    case.state.apply_updates = lambda: None     # keep the gradients
    try:
        case.step(case.state, case.batch)
        _sync()
    finally:
        del case.state.apply_updates
        hooks.remove()
    grads = {n: fingerprint(p.grad) for n, p in zip(case.state.tx.names,
                                                    case.state.tx.params)
             if p.grad is not None}
    case.state.tx.zero_grad()
    return grads, hooks.calls


def bisect_case(case: Case, scope: Callable = contextlib.nullcontext
                ) -> Dict:
    """Two backward passes under ``scope`` -> the parameters whose
    gradients differ (grouped by module) and the modules where a backward
    varies: their output gradients repeat, their input or parameter
    gradients do not."""
    with scope():
        (g1, c1), (g2, c2) = _backward_once(case), _backward_once(case)
    diff = differing(g1, g2)
    by_module: Dict[str, int] = {}
    for n in diff:
        by_module[n.rsplit(".", 1)[0]] = by_module.get(
            n.rsplit(".", 1)[0], 0) + 1
    culprits = []
    for mod, calls in c1.items():
        other = c2.get(mod, [])
        out_same = [a[0] for a in calls] == [b[0] for b in other]
        in_same = [a[1] for a in calls] == [b[1] for b in other]
        own = [n for n in diff if n.rsplit(".", 1)[0] == mod]
        if out_same and (not in_same or own):
            culprits.append({"module": mod,
                             "type": type(case.model.get_submodule(mod)
                                          ).__name__,
                             "input_grads_differ": not in_same,
                             "param_grads_differ": own})
    first_out = [m for m, calls in c1.items()
                 if [a[0] for a in calls] != [b[0] for b in c2.get(m, [])]]
    return {"params_with_grads": len(g1), "differing_grads": len(diff),
            "differing_by_module": by_module, "culprits": culprits,
            "modules_whose_output_grads_differ": first_out[:20]}


def nondeterministic_ops(case: Case, scope: Callable = contextlib.nullcontext
                         ) -> List[str]:
    """The ops of one step that torch flags as nondeterministic on this
    device: its warnings under ``use_deterministic_algorithms(True,
    warn_only=True)``, restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    with warnings.catch_warnings(record=True) as caught, scope():
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            case.run()
        finally:
            torch.use_deterministic_algorithms(was, warn_only=was_warn)
    msgs = sorted({str(w.message).split(". ")[0][:200] for w in caught
                   if "determinis" in str(w.message)})
    return msgs


def roi_align_repeats(case: Case, scope: Callable = contextlib.nullcontext
                      ) -> Dict:
    """ROIAlign at P2-P5 of one image's ROI batch (its first
    BATCH_SIZE_PER_IMAGE proposals, as the train step pools them), forward
    and backward twice from the same features and output gradient: whether
    the features' gradients repeat bit for bit."""
    cfg, model = case.cfg, case.model
    images = case.batch.get("images", case.batch.get("query_images"))
    dev = images.device
    grid = train_anchor_grid(cfg)
    roi_batch = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    sizes = torch.tensor([list(cfg.TPU.TRAIN_CANVAS)], dtype=torch.int32,
                         device=dev)
    with torch.no_grad():
        feats, logits, deltas = model.forward_rpn(images[:1])
        props, _, _ = rcnn.rpn_proposals(
            logits, deltas, torch.as_tensor(grid.anchors, device=dev),
            grid.level_splits, sizes,
            pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
            post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN)
    rois = props[0, :roi_batch]
    feats = [f.detach().requires_grad_() for f in feats[:4]]
    ones = torch.ones(rois.shape[0], dtype=torch.bool, device=dev)
    zeros = torch.zeros(rois.shape[0], dtype=torch.long, device=dev)
    gen = torch.Generator().manual_seed(0)
    out_grad = None
    prints = []
    with scope():
        for _ in range(2):
            out = multilevel_roi_align(feats, model.ROI_STRIDES, rois, ones,
                                       zeros, output_size=7)
            if out_grad is None:
                out_grad = torch.rand(out.shape, generator=gen).to(dev)
            grads = torch.autograd.grad(out, feats, out_grad)
            prints.append([fingerprint(g) for g in grads])
    return {"rois": int(rois.shape[0]), "repeats": prints[0] == prints[1]}


def draw_ms(b: int, k: int, device: str = "cuda") -> Dict[str, float]:
    """ms of B x K uniforms drawn on the CPU and copied to the card (the
    steps' draws) against the same draw on the card, medians of 5."""
    def timed(fn):
        times = []
        for _ in range(6):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])
    cpu_gen = torch.Generator().manual_seed(0)
    dev_gen = torch.Generator(device).manual_seed(0)
    return {"b": b, "k": k,
            "cpu_draw_and_copy_ms": timed(lambda: torch.rand(
                (b, k), generator=cpu_gen).to(device)),
            "card_draw_ms": timed(lambda: torch.rand(
                (b, k), generator=dev_gen, device=device))}


def rpn_draw_shape(cfg) -> Tuple[int, int]:
    """(B, K) of one micro-group's anchor priorities at ``cfg``."""
    k = train_anchor_grid(cfg).anchors.shape[0]
    m = max(1, cfg.TPU.GRAD_ACCUM)
    if cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
        b = cfg.SOLVER.IMS_PER_BATCH * cfg.MODEL.META_LEARN.QUERY_SHOT // m
    else:
        b = cfg.SOLVER.IMS_PER_BATCH // m
    return b, k


def measure(name: str, card: str, work: str) -> Dict:
    """Every measurement of the module's docstring for the step ``name``
    (the trees of ``write_data(work)`` already registered)."""
    runner, cfg = step_cfg(name, work)
    case = Case(runner, cfg)
    case.run()                                   # warm-up
    row = {"step": name, "card": card,
           "batch": cfg.SOLVER.IMS_PER_BATCH,
           "grad_accum": max(1, cfg.TPU.GRAD_ACCUM),
           "as_shipped": repeat_case(case, runs=3),
           "cudnn_free": repeat_case(case, free_kernels, runs=3)}
    row["bisect_as_shipped"] = bisect_case(case)
    row["bisect_cudnn_free"] = bisect_case(case, free_kernels)
    row["nondeterministic_ops"] = nondeterministic_ops(case)
    if name.startswith("rcnn"):
        row["roi_align"] = roi_align_repeats(case)
        b, k = rpn_draw_shape(cfg)
        row["draws"] = draw_ms(b, k)
        row["draws"]["groups_per_step"] = row["grad_accum"]
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", nargs="+", default=list(STEPS),
                        choices=STEPS)
    parser.add_argument("--out", default="repeat_steps.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("repeat_steps needs an NVIDIA card")
    card = quality_loop.card_line()
    print(f"[repeat] card: {card}", flush=True)
    rows = []
    work = tempfile.mkdtemp(prefix="sylph_repeat_steps_")
    try:
        write_data(work)
        for name in args.steps:
            t0 = time.perf_counter()
            row = measure(name, card, work)
            row["wall_s"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
