"""Train steps (port of sylph_tpu/train/steps.py) on one card or on each
rank of a data-parallel group.

Each step takes a batch whose tensors already sit on the model's device
(the train loaders copy them on their worker thread), applies the device
RandAugment where the loader shipped drawn ops, assigns targets, runs the
forward and backward passes and one optimizer update.

``grad_accum = m`` splits the batch into m contiguous micro-groups that act
as m data-parallel ranks (``TPU.GRAD_ACCUM``, the emulation of the reference
run's ranks on one card):

  * the loss normalizers are the cross-group means, clamped after dividing
    by m (``loss_normalizers``), computed once from every group's targets;
  * each group's losses are backpropagated on their own, the gradients
    summed in ``.grad`` and then averaged, as are the reported losses;
  * in episodic training a group's queries are classified against, and
    their GT filtered to, that group's own episode classes.

With m = 1 this is the plain step. Targets are assigned per group, which
keeps the assigner's (B, K, M, 4) intermediate at the group's size.

``group=`` (a ``parallel.mesh.DataGroup`` of W ranks) makes each rank's
batch its slice of the global one, and its m groups the global groups
``rank * m`` to ``rank * m + m - 1``: the normalizers are means over all
W * m groups, and the averaged gradients and reported losses are averaged
over the ranks in one all-reduce before the update, so the gradient clip
sees the global gradient (JAX's ``pmean`` before the optax chain). W ranks
of m groups compute what one process of W * m groups computes.

Every step runs its forward and backward passes under
``deterministic_kernels`` (cuDNN held to deterministic algorithms, the
flags restored after), so one state and one batch give the same bits on
every run on the card, as the JAX package's step does on any device.

The episodic step hands each group's forward a CPU ``torch.Generator``
seeded from (seed, iteration, global group) for the ROIEncoder's dropout,
so a resumed run draws what an uninterrupted one does, and W ranks draw
what one process draws.

``steps_per_call = K`` above 1 (``TPU.STEPS_PER_CALL``) gives every batch
tensor a leading K axis: one call runs the K steps in order, each at its own
iteration (``state.step`` after the previous update, which seeds the
dropout and sampling draws), and returns each metric stacked to (K,). K
calls of one step give the same bits.

The two-stage steps (``make_rcnn_episodic_train_step``,
``make_rcnn_pretrain_train_step``) run the same micro-groups as the ranks
of the JAX package's data-parallel mesh: each group's losses carry that
rank's own normalizers (B x 256 anchors, the sampled ROIs of each image),
so the mean over the groups is JAX's pmean. They apply no RandAugment:
the JAX package's two-stage steps never read the drawn ops. Each group
samples anchors and ROIs by the draw source ``draws(iteration, group,
groups)`` gives it (the global group index and count), by default
``SampleDraws.for_step(seed, iteration, group)``, whose uniforms come from
a CPU generator on every device.
Only their gradients and losses are averaged across ranks; each group
keeps its own normalizers, as in JAX's ``finalize_step``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.rcnn import SampleDraws
from ..ops.assigner import FCOSTargets, assign_fcos_targets
from ..ops.fcos_losses import (FCOSLossCfg, fcos_episodic_losses,
                               fcos_pretrain_losses, loss_normalizers)
from ..ops.image_aug import rand_augment_device
from ..parallel.mesh import DataGroup, all_reduce_mean_
from ..structures import GTBoxes
from .train_state import TrainState

Batch = Dict[str, object]
# (iteration, group, groups) -> a draw source with SampleDraws' methods
DrawsFactory = Callable[[int, int, int], object]


def _per_call(step, steps_per_call: int):
    """``step`` as is for K = 1; for K > 1, a step over batches stacked on a
    leading K axis that runs ``step`` on each in order and stacks each
    metric to (K,) (the JAX package's ``lax.scan`` over K steps)."""
    k = steps_per_call
    if k <= 1:
        return step

    def multi(state: TrainState, batches: Batch):
        lead = {n: len(v) for n, v in batches.items()}
        if set(lead.values()) != {k}:
            raise ValueError(f"TPU.STEPS_PER_CALL = {k} takes batches "
                             f"stacked on a leading axis of {k}: {lead}")
        rows = []
        for i in range(k):
            state, m = step(state, {n: v[i] for n, v in batches.items()})
            rows.append(m)
        return state, {n: torch.stack([r[n] for r in rows]) for n in rows[0]}

    return multi


def metric_rows(metrics: Dict[str, torch.Tensor], steps_per_call: int
                ) -> List[Dict[str, float]]:
    """A call's metrics as one row of floats a step."""
    if steps_per_call <= 1:
        return [{n: float(v) for n, v in metrics.items()}]
    return [{n: float(v[i]) for n, v in metrics.items()}
            for i in range(steps_per_call)]


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """K loader batches as one batch with a leading K axis: tensors stacked
    on their device, the host arrays with numpy."""
    return {n: (torch.stack([b[n] for b in batches])
                if isinstance(batches[0][n], torch.Tensor)
                else np.stack([b[n] for b in batches]))
            for n in batches[0]}


def _apply_device_aug(batch: Batch, img_key: str, ops_key: str,
                      params_key: str, sizes_key: str) -> Batch:
    """RandAugment on the card where the loader drew op ids (INPUT.
    RAND_AUGMENT with TPU.DEVICE_RANDAUG; the canvases are BGR, which the
    mapper guarantees for this mode)."""
    if ops_key not in batch:
        return batch
    batch = dict(batch)
    batch[img_key] = rand_augment_device(
        batch[img_key], batch.pop(ops_key), batch.pop(params_key),
        batch.pop(sizes_key), bgr=True)
    return batch


class _Grid:
    def __init__(self, grid, device):
        self.locations = torch.as_tensor(grid.locations, device=device)
        self.strides = torch.as_tensor(grid.strides, device=device)
        self.size_ranges = torch.as_tensor(grid.size_ranges, device=device)


def _assign(g: _Grid, boxes, labels, valid, center_sample, radius):
    return assign_fcos_targets(g.locations, g.strides, g.size_ranges, boxes,
                               labels, valid, center_sample=center_sample,
                               radius=radius)


def _cat_targets(ts) -> FCOSTargets:
    return FCOSTargets(*(torch.cat(x, 0) for x in zip(*ts)))


def _ranks(group: Optional[DataGroup]) -> Tuple[int, int]:
    return (group.rank, group.world) if group is not None else (0, 1)


@contextlib.contextmanager
def deterministic_kernels():
    """cuDNN held to its deterministic algorithms, benchmark off, for the
    scope; both flags restored on exit. Left free, cuDNN may pick backward
    algorithms that sum in a varying order, and a step then differs from
    run to run on the card."""
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags


def _run_micro_groups(state: TrainState, m: int,
                      loss_at: Callable[[int], Dict[str, torch.Tensor]],
                      group: Optional[DataGroup] = None
                      ) -> Dict[str, torch.Tensor]:
    """Backpropagate each group's summed losses, average the gradients and
    losses over the groups and then over the ranks of ``group``, apply one
    update; returns the losses."""
    state.tx.zero_grad()
    acc: Optional[Dict[str, torch.Tensor]] = None
    with deterministic_kernels():
        for gi in range(m):
            losses = loss_at(gi)
            total = sum(losses.values())
            if total.requires_grad:
                total.backward()
            det = {k: v.detach() for k, v in losses.items()}
            acc = det if acc is None else {k: acc[k] + det[k] for k in acc}
    if m > 1:
        scale = 1.0 / m
        grads = [p.grad for p in state.tx.params if p.grad is not None]
        if grads:
            torch._foreach_mul_(grads, scale)
        acc = {k: v * scale for k, v in acc.items()}
    if group is not None and group.world > 1:
        # a gradient-free parameter counts as a zero gradient, as in the
        # update itself; every rank then reduces the same tensors
        for p in state.tx.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        keys = sorted(acc)
        losses = torch.stack([acc[k].float() for k in keys])
        all_reduce_mean_([p.grad for p in state.tx.params] + [losses], group)
        acc = dict(zip(keys, losses.unbind()))
    state.apply_updates()
    return acc


def make_pretrain_train_step(model, grid, loss_cfg: FCOSLossCfg,
                             center_sample: bool = True, radius: float = 1.5,
                             steps_per_call: int = 1, grad_accum: int = 1,
                             group: Optional[DataGroup] = None
                             ) -> Callable[[TrainState, Batch],
                                           Tuple[TrainState, Dict]]:
    """Batch (this rank's slice): images (B, H, W, 3) uint8 BGR, gt_boxes
    (B, M, 4), gt_labels (B, M), gt_valid (B, M), and optionally aug_ops,
    aug_params, image_sizes; B divisible by ``grad_accum``."""
    m = max(1, grad_accum)
    g = _Grid(grid, next(model.parameters()).device)

    def step(state: TrainState, batch: Batch):
        batch = _apply_device_aug(batch, "images", "aug_ops", "aug_params",
                                  "image_sizes")
        images = batch["images"]
        mb = images.shape[0] // m
        sl = [slice(i * mb, (i + 1) * mb) for i in range(m)]
        targets = [_assign(g, batch["gt_boxes"][s], batch["gt_labels"][s],
                           batch["gt_valid"][s], center_sample, radius)
                   for s in sl]
        npa, ld = loss_normalizers(_cat_targets(targets), m, group)

        def loss_at(gi):
            out = model.forward_base(images[sl[gi]])
            return fcos_pretrain_losses(out.logits, out.reg, out.ctrness,
                                        out.iou, targets[gi], loss_cfg,
                                        num_pos_avg=npa, loss_denorm=ld)

        return state, _run_micro_groups(state, m, loss_at, group)

    return _per_call(step, steps_per_call)


def make_episodic_train_step(model, grid, loss_cfg: FCOSLossCfg,
                             num_shots: int, center_sample: bool = True,
                             radius: float = 1.5, pretrained_kernel=None,
                             steps_per_call: int = 1, grad_accum: int = 1,
                             seed: int = 0, group: Optional[DataGroup] = None
                             ) -> Callable[[TrainState, Batch],
                                           Tuple[TrainState, Dict]]:
    """Batch (this rank's E episodes): support_images (E*shot, Hs, Ws, 3),
    support_boxes (E*shot, 4), support_box_valid (E*shot,), query_images
    (E*Q, H, W, 3), query_gt_{boxes,labels,valid} (E*Q, M, ...),
    episode_class_ids (E,), and optionally query_aug_ops,
    query_aug_params, query_image_sizes; E divisible by ``grad_accum``."""
    m = max(1, grad_accum)
    g = _Grid(grid, next(model.parameters()).device)
    rank, _ = _ranks(group)

    def step(state: TrainState, batch: Batch):
        it = state.step
        batch = _apply_device_aug(batch, "query_images", "query_aug_ops",
                                  "query_aug_params", "query_image_sizes")
        ids_m = batch["episode_class_ids"].reshape(m, -1)     # (m, E/m)
        labels = batch["query_gt_labels"]                     # (Bq, M)
        bq, mx = labels.shape
        # group g's queries see only group g's episode classes
        lab_m = labels.reshape(m, bq // m, mx)
        in_ep = (lab_m[..., None] == ids_m[:, None, None, :]).any(-1)
        valid = batch["query_gt_valid"] & in_ep.reshape(bq, mx)
        qmb = bq // m
        smb = batch["support_images"].shape[0] // m
        qs = [slice(i * qmb, (i + 1) * qmb) for i in range(m)]
        ss = [slice(i * smb, (i + 1) * smb) for i in range(m)]
        targets = [_assign(g, batch["query_gt_boxes"][s], labels[s],
                           valid[s], center_sample, radius) for s in qs]
        npa, ld = loss_normalizers(_cat_targets(targets), m, group)

        def loss_at(gi):
            out, codes = model.forward_episodic_train(
                batch["support_images"][ss[gi]],
                batch["support_boxes"][ss[gi]],
                batch["support_box_valid"][ss[gi]],
                batch["query_images"][qs[gi]], num_shots,
                generator=torch.Generator().manual_seed(
                    SampleDraws.step_seed(seed, it, rank * m + gi)))
            losses = fcos_episodic_losses(
                out.logits, out.reg, out.ctrness, targets[gi], ids_m[gi],
                loss_cfg, class_code=codes,
                pretrained_kernel=pretrained_kernel, num_pos_avg=npa,
                loss_denorm=ld)
            if "snnl" in codes:
                losses["loss_snnl"] = codes["snnl"]
            return losses

        return state, _run_micro_groups(state, m, loss_at, group)

    return _per_call(step, steps_per_call)


class _RCNNStepSetup:
    """What both two-stage steps share: the anchors on the model's device,
    the canvas as every image's size, the micro-group count, the rank and
    the draw sources by global group."""

    def __init__(self, model, grid, canvas: Sequence[int], seed: int,
                 draws: Optional[DrawsFactory], grad_accum: int,
                 group: Optional[DataGroup]):
        self.m = max(1, grad_accum)
        self.group = group
        self.rank, self.world = _ranks(group)
        self.device = next(model.parameters()).device
        self.anchors = torch.as_tensor(grid.anchors, device=self.device)
        self.splits = tuple(grid.level_splits)
        self.canvas = torch.tensor([list(canvas)], dtype=torch.int32,
                                   device=self.device)
        self.draws = draws or (lambda it, g, m: SampleDraws.for_step(
            seed, it, g, self.device))

    def sizes(self, b: int) -> torch.Tensor:
        return self.canvas.expand(b, 2)

    def draws_of(self, it: int, gi: int):
        """The draw source of this rank's group ``gi``: global group
        ``rank * m + gi`` of ``world * m``."""
        return self.draws(it, self.rank * self.m + gi, self.world * self.m)


def make_rcnn_episodic_train_step(model, grid, num_shots: int,
                                  canvas: Sequence[int], rpn_pre_nms: int,
                                  rpn_post_nms: int, roi_batch: int,
                                  seed: int = 0,
                                  draws: Optional[DrawsFactory] = None,
                                  steps_per_call: int = 1,
                                  grad_accum: int = 1,
                                  group: Optional[DataGroup] = None
                                  ) -> Callable[[TrainState, Batch],
                                                Tuple[TrainState, Dict]]:
    """Episodic two-stage step. ``grid``: the ``AnchorGrid`` of ``canvas``
    (TPU.TRAIN_CANVAS). Batch (E episodes) as for
    ``make_episodic_train_step``; E divisible by ``grad_accum``. A group's
    queries keep only the GT of that group's episode classes."""
    s = _RCNNStepSetup(model, grid, canvas, seed, draws, grad_accum, group)
    m = s.m

    def step(state: TrainState, batch: Batch):
        it = state.step
        ids_m = batch["episode_class_ids"].reshape(m, -1)     # (m, E/m)
        labels = batch["query_gt_labels"]                     # (Bq, M)
        bq, mx = labels.shape
        in_ep = (labels.reshape(m, bq // m, mx)[..., None]
                 == ids_m[:, None, None, :]).any(-1)
        valid = batch["query_gt_valid"] & in_ep.reshape(bq, mx)
        qmb = bq // m
        smb = batch["support_images"].shape[0] // m

        def loss_at(gi):
            qs = slice(gi * qmb, (gi + 1) * qmb)
            ss = slice(gi * smb, (gi + 1) * smb)
            gt = GTBoxes(batch["query_gt_boxes"][qs], labels[qs], valid[qs])
            return model.forward_episodic_train(
                batch["support_images"][ss], batch["support_boxes"][ss],
                batch["support_box_valid"][ss], batch["query_images"][qs],
                gt, ids_m[gi], s.draws_of(it, gi), s.anchors, s.splits,
                s.sizes(qmb), num_shots, rpn_post_nms=rpn_post_nms,
                roi_batch=roi_batch, rpn_pre_nms=rpn_pre_nms)

        return state, _run_micro_groups(state, m, loss_at, s.group)

    return _per_call(step, steps_per_call)


def make_rcnn_pretrain_train_step(model, grid, canvas: Sequence[int],
                                  rpn_pre_nms: int, rpn_post_nms: int,
                                  roi_batch: int, seed: int = 0,
                                  draws: Optional[DrawsFactory] = None,
                                  steps_per_call: int = 1,
                                  grad_accum: int = 1,
                                  group: Optional[DataGroup] = None
                                  ) -> Callable[[TrainState, Batch],
                                                Tuple[TrainState, Dict]]:
    """Plain two-stage step (pretraining, TFA-RCNN). Batch: images (B, H, W,
    3) uint8 BGR, gt_boxes (B, M, 4), gt_labels (B, M), gt_valid (B, M); B
    divisible by ``grad_accum``."""
    s = _RCNNStepSetup(model, grid, canvas, seed, draws, grad_accum, group)
    m = s.m

    def step(state: TrainState, batch: Batch):
        it = state.step
        images = batch["images"]
        mb = images.shape[0] // m

        def loss_at(gi):
            sl = slice(gi * mb, (gi + 1) * mb)
            gt = GTBoxes(batch["gt_boxes"][sl], batch["gt_labels"][sl],
                         batch["gt_valid"][sl])
            return model.forward_pretrain_train(
                images[sl], gt, s.draws_of(it, gi), s.anchors, s.splits,
                s.sizes(mb), rpn_post_nms=rpn_post_nms, roi_batch=roi_batch,
                rpn_pre_nms=rpn_pre_nms)

        return state, _run_micro_groups(state, m, loss_at, s.group)

    return _per_call(step, steps_per_call)
