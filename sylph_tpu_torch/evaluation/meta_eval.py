"""Two-phase meta-test drivers (port of sylph_tpu/evaluation/meta_eval.py).

  PHASE 1 -- per class: the K-shot support set goes through the frozen
  backbone and the code generator; base classes may instead accumulate
  codes over chunks of all their ground truths; one ``.npz`` of RAW codes
  is saved per class; then the whole bank is normalized in one call.

  PHASE 2 -- conditioned query inference against the N-row bank, decode
  (with the CUDA NMS kernel on the card), postprocess into the evaluator.

``MetaTestDriver.run_repeated`` reproduces the REPEAT_TEST mean±std
aggregation (reference meta_fcos_runner.py:597-631). Given a data-parallel
group of more than one rank (``mesh=``), phase 1 is sharded over the ranks
(``generate_class_codes_sharded``); phase 2 is not, as in the JAX package:
every rank runs the whole query set.

Every entry point takes ``device=`` (default ``"cuda"``, which raises
without a card). Batches are copied to the device on a worker thread as
they come off the loader; the copy is a real one on the CPU too, because
the query loader reuses its host buffers.

Each phase adds its wall time to a ``stats`` dict when one is passed (the
driver keeps the last run's as ``MetaTestDriver.stats``): ``*_wait_s`` is
time spent waiting for the loader and the copy, ``codegen_s`` / ``query_s``
the model calls up to their results on the host, ``evaluator_s`` the
postprocess and ``evaluator.process``, ``evaluate_s`` the final AP. Each
timer is a span (``utils/spans.py``), so under a profiler the same
intervals appear as ``sylph.*`` ranges: ``h2d`` (the copy, on the worker
thread), ``wait``, ``infer``, ``fetch``, ``register``, ``evaluator``,
``evaluate``, ``gather``, ``normalize``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..data.loader import (_prefetch, build_query_loader,
                           build_support_set_base_loader,
                           build_support_set_loader)
from ..data.meta_dataset import MetaDataset
from ..ops.decode import DecodeCfg, decode_proposals
from ..parallel.mesh import DataGroup, gather_class_codes
from ..runner import resolve_device
from ..utils.spans import span
from .postprocess import detections_to_coco_results

WARMUP = 5
_END = object()
_SUPPORT_KEYS = ("support_images", "support_boxes", "support_box_valid")


def _np_f32(x) -> np.ndarray:
    """Device -> host fetch that lands floating values as np.float32: the
    card may compute in bf16, but host artifacts (saved ``.npz`` codes,
    COCO result floats) stay plain numpy dtypes."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating) and a.dtype.itemsize < 4:
        return a.astype(np.float32)
    return a


def _add(stats: Optional[Dict], key: str, value: float) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + value


def format_class_codes(code_list: List[Dict]) -> Dict[str, np.ndarray]:
    """Per-class {cls_conv (1, C), cls_bias (1,)} list -> stacked bank
    {"cls_conv": (N, C), "cls_bias": (N,)} (reference :71-103)."""
    conv = np.concatenate([np.asarray(c["cls_conv"]).reshape(1, -1)
                           for c in code_list], 0)
    bias = np.concatenate([np.asarray(c["cls_bias"]).reshape(1)
                           for c in code_list], 0)
    return {"cls_conv": conv.astype(np.float32),
            "cls_bias": bias.astype(np.float32)}


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device`` (also on the CPU: the source
    may be a loader buffer that is about to be rewritten). From pageable
    memory a CUDA copy returns once the source has been read."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, copy=True)


def _device_prefetch(loader, keys, device: torch.device, depth: int = 2):
    """Yield loader items with ``keys`` copied to ``device`` on a worker
    thread, so the copy of item i+1 overlaps the work on item i. The host
    original stays under ``key + "_host"`` for host-side consumers."""
    def gen():
        for item in loader:
            out = dict(item)
            with span("h2d"):
                for k in keys:
                    out[k] = _to_device(item[k], device)
            for k in keys:
                out[k + "_host"] = item[k]
            yield out

    return _prefetch(gen, depth=depth)


def _taken(items, stats: Optional[Dict], key: str):
    """``items`` one at a time, each take a ``wait`` span timed into
    ``stats[key]`` (the last one finds the end of the stream)."""
    it = iter(items)
    try:
        while True:
            with span("wait", stats, key):
                item = next(it, _END)
            if item is _END:
                return
            yield item
    finally:
        it.close()


def _save_code(save_dir: Optional[str], name: str,
               code: Dict[str, np.ndarray]) -> None:
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.savez(os.path.join(save_dir, f"{name}.npz"), **code)


def _class_groups(support_loader, class_batch: int, pad: bool):
    """The loader's classes stacked ``class_batch`` at a time; ``pad``
    zero-fills the tail group to ``class_batch`` classes (JAX
    ``_pad_group``), whose padded rows the caller drops."""
    group: List[Dict] = []

    def stacked():
        items = [(g["class_id"], g["class_name"]) for g in group]
        while pad and len(group) < class_batch:
            group.append({k: np.zeros_like(group[0][k])
                          for k in _SUPPORT_KEYS})
        out = {k: np.concatenate([g[k] for g in group])
               for k in _SUPPORT_KEYS}
        out["items"] = items
        out["shot"] = len(group[0]["support_box_valid"])
        group.clear()
        return out

    for item in support_loader:
        group.append(item)
        if len(group) == class_batch:
            yield stacked()
    if group:
        yield stacked()


def _class_code_calls(model, groups, class_batch: int, dev: torch.device,
                      stats: Optional[Dict]):
    """One ``forward_class_code`` call per group: yields (the group's
    (class_id, class_name) items, its code rows on the device). A call's
    time runs until the card has finished it and the caller has taken its
    rows: the ``register`` span holds the caller's ``fetch``."""
    stats = {} if stats is None else stats
    times: List = []
    for g in _taken(_device_prefetch(groups, _SUPPORT_KEYS, dev), stats,
                    "support_wait_s"):
        with span("register", stats, "codegen_s") as call:
            with torch.inference_mode():
                out = model.forward_class_code(g["support_images"],
                                               g["support_boxes"],
                                               g["support_box_valid"],
                                               g["shot"], False)
            yield g["items"], out
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        _add(stats, "classes", len(g["items"]))
        times.append((call.seconds, len(g["items"])))
    if len(times) > WARMUP:
        t = sum(t for t, _ in times[WARMUP:])
        n = sum(n for _, n in times[WARMUP:])
        print(f"[meta-eval] code-gen: {t/max(n,1)*1e3:.2f} ms/class "
              f"({class_batch} classes/call)")


def generate_class_codes(model, support_loader, *,
                         save_dir: Optional[str] = None,
                         class_batch: int = 1,
                         device: Union[str, torch.device] = "cuda",
                         stats: Optional[Dict] = None) -> Dict[int, Dict]:
    """PHASE 1: raw codes per class (+ one ``.npz`` per class in
    ``save_dir``): {class_id: {"code": {cls_conv (1, C), cls_bias (1,)},
    "class_name": str}}.

    ``class_batch`` classes are registered per model call: their
    ``class_batch`` x shot support images go through the backbone as one
    batch, and the code generator turns each class's ``shot`` consecutive
    images into one code row (``forward_class_code`` with
    ``num_shots=shot``). The tail group is simply smaller; nothing is
    padded. One class per call is ``class_batch=1``.
    """
    dev = resolve_device(device)
    codes: Dict[int, Dict] = {}
    for items, out in _class_code_calls(
            model, _class_groups(support_loader, class_batch, pad=False),
            class_batch, dev, stats):
        with span("fetch"):
            bank = {k: _np_f32(v) for k, v in out.items()}
        for i, (cid, cname) in enumerate(items):
            code = {k: v[i:i + 1] for k, v in bank.items()}
            codes[cid] = {"code": code, "class_name": cname}
            _save_code(save_dir, cname, code)
    return codes


def generate_class_codes_sharded(model, support_loader, group: DataGroup, *,
                                 save_dir: Optional[str] = None,
                                 class_batch: int = 1,
                                 device: Union[str, torch.device] = "cuda",
                                 stats: Optional[Dict] = None
                                 ) -> Dict[int, Dict]:
    """PHASE 1 with the classes sharded over the ranks of ``group`` (JAX
    ``generate_class_codes_sharded``; reference meta_fcos_runner.py:381-439).

    ``support_loader`` yields this rank's share of the classes
    (``build_support_set_loader(..., rank=group.rank,
    world_size=group.world)``). Each rank registers its share
    ``class_batch`` classes per call, its tail call zero-padded to
    ``class_batch`` (the padded rows are dropped), then the ranks exchange
    their (class_id, class_name) lists and all-gather their code rows, each
    rank's padded to the longest share (``gather_class_codes``). Every rank
    returns the same dict as ``generate_class_codes`` over all the classes;
    rank 0 alone writes the ``.npz`` files. ``stats["gather_s"]`` is the
    all-gather's wall time.
    """
    dev = resolve_device(device)
    items: List = []
    rows: Dict[str, List[torch.Tensor]] = {"cls_conv": [], "cls_bias": []}
    for its, out in _class_code_calls(
            model, _class_groups(support_loader, class_batch, pad=True),
            class_batch, dev, stats):
        items += its
        for k in rows:
            rows[k].append(out[k][:len(its)].float())
    width = rows["cls_conv"][0].shape[1] if items else 0
    shares = group.gather_objects((items, width))
    n = max(len(its) for its, _ in shares)
    width = max(w for _, w in shares)
    local = {}
    for k, shape in (("cls_conv", (n, width)), ("cls_bias", (n,))):
        mine = (torch.cat(rows[k]) if items else
                torch.zeros((0, *shape[1:]), device=dev))
        local[k] = torch.cat([mine, mine.new_zeros(
            (n - len(items), *shape[1:]))])
    with span("gather", stats, "gather_s"):
        bank = {k: _np_f32(v) for k, v in gather_class_codes(local,
                                                             group).items()}
    codes: Dict[int, Dict] = {}
    for r, (its, _) in enumerate(shares):
        for j, (cid, cname) in enumerate(its):
            i = r * n + j
            code = {k: v[i:i + 1] for k, v in bank.items()}
            codes[cid] = {"code": code, "class_name": cname}
            if group.is_main:
                _save_code(save_dir, cname, code)
    return codes


def normalize_class_codes(model, codes: Dict[int, Dict], *,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Dict[str, np.ndarray]:
    """PHASE 1b: one normalization call over the stacked bank, rows in
    class-id order."""
    dev = resolve_device(device)
    order = sorted(codes)
    raw = format_class_codes([codes[c]["code"] for c in order])
    if model.code_generator_name == "ROIEncoder":
        return raw  # the ROIEncoder emits final codes directly
    with torch.inference_mode():
        out = model.normalize_code({k: torch.as_tensor(v, device=dev)
                                    for k, v in raw.items()})
    return {k: _np_f32(v) for k, v in out.items()}


def accumulate_base_codes(chunks: List[Dict[str, np.ndarray]],
                          weights: List[float]) -> Dict[str, np.ndarray]:
    """Weighted accumulation of chunked base-class codes (reference
    reduce_class_code, code_generator/utils.py:397-427)."""
    total = float(sum(weights))
    conv = sum(np.asarray(c["cls_conv"]) * (w / total)
               for c, w in zip(chunks, weights))
    bias = sum(np.asarray(c["cls_bias"]) * (w / total)
               for c, w in zip(chunks, weights))
    return {"cls_conv": conv, "cls_bias": bias}


def generate_base_class_codes(model, dataset, mapper, *,
                              chunk_size: int = 10, max_records: int = 100,
                              device: Union[str, torch.device] = "cuda",
                              stats: Optional[Dict] = None
                              ) -> Dict[int, Dict]:
    """Base-class registration over ALL ground truths, chunked + weighted
    (reference inference_on_support_set_dataset_base,
    meta_learn_evaluation.py:118-254): each chunk of support records gives
    one raw code; a class's chunks accumulate by their record-count
    weight."""
    dev = resolve_device(device)
    per_class: Dict[int, List] = {}
    weights: Dict[int, List[float]] = {}
    names = {}
    for item in _taken(_device_prefetch(
            build_support_set_base_loader(dataset, mapper,
                                          chunk_size=chunk_size,
                                          max_records=max_records),
            _SUPPORT_KEYS, dev), stats, "base_wait_s"):
        with span("register", stats, "base_codegen_s"):
            with torch.inference_mode():
                out = model.forward_class_code(item["support_images"],
                                               item["support_boxes"],
                                               item["support_box_valid"],
                                               chunk_size, False)
            with span("fetch"):
                code = {k: _np_f32(v) for k, v in out.items()}
            cid = item["class_id"]
            per_class.setdefault(cid, []).append(code)
            weights.setdefault(cid, []).append(item["weight"])
            names[cid] = item["class_name"]
    return {cid: {"code": accumulate_base_codes(per_class[cid],
                                                weights[cid]),
                  "class_name": names[cid]}
            for cid in per_class}


def replace_with_base_codes(codes: Dict[int, Dict],
                            base_codes: Dict[int, Dict]) -> Dict[int, Dict]:
    """Few-shot codes overridden by base-GT codes where available
    (reference replace_class_code, code_generator/utils.py:376-394)."""
    out = dict(codes)
    out.update(base_codes)
    return out


def make_fcos_infer(model, bank: Dict[str, np.ndarray], grid,
                    decode_cfg: DecodeCfg,
                    class_valid: Optional[np.ndarray] = None, *,
                    device: Union[str, torch.device] = "cuda") -> Callable:
    """One-stage phase-2 inference: ``infer(images, image_sizes)`` runs
    the conditioned dense head against ``bank`` and decodes (the default
    MetaTestDriver query path)."""
    dev = resolve_device(device)
    locations = torch.as_tensor(grid.locations, device=dev)
    strides = torch.as_tensor(grid.strides, device=dev)
    level_splits = tuple(h * w for h, w in grid.level_sizes)
    bank_t = {k: torch.as_tensor(v, device=dev) for k, v in bank.items()}
    cv = (torch.as_tensor(class_valid, device=dev)
          if class_valid is not None else
          torch.ones((bank["cls_conv"].shape[0],), dtype=torch.bool,
                     device=dev))

    @torch.inference_mode()
    def infer(images: torch.Tensor, image_sizes: torch.Tensor):
        out = model.forward_instances(images, bank_t)
        return decode_proposals(out.logits, out.reg, out.ctrness, out.iou,
                                locations, strides, image_sizes, decode_cfg,
                                level_splits, class_valid=cv)

    return infer


def make_rcnn_infer(model, bank: Dict[str, np.ndarray], anchor_grid, *,
                    rpn_post_nms: int = 1000, score_thresh: float = 0.05,
                    nms_thresh: float = 0.5, max_dets: int = 100,
                    class_valid: Optional[np.ndarray] = None,
                    rpn_pre_nms: int = 1000,
                    device: Union[str, torch.device] = "cuda") -> Callable:
    """Two-stage phase-2 inference: ``infer(images, image_sizes)`` runs
    ``FewShotRCNN.forward_instances`` against ``bank`` with the anchors of
    ``anchor_grid`` (reference FewShotDetector "meta_learn_test_instance",
    few_shot_rcnn.py:230-306)."""
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchor_grid.anchors, device=dev)
    splits = tuple(anchor_grid.level_splits)
    bank_t = {k: torch.as_tensor(v, device=dev) for k, v in bank.items()}
    cv = (torch.as_tensor(class_valid, device=dev)
          if class_valid is not None else
          torch.ones((bank["cls_conv"].shape[0],), dtype=torch.bool,
                     device=dev))

    @torch.inference_mode()
    def infer(images: torch.Tensor, image_sizes: torch.Tensor):
        return model.forward_instances(
            images, bank_t, anchors, splits, image_sizes, rpn_post_nms,
            score_thresh, nms_thresh, max_dets, cv, rpn_pre_nms)

    return infer


def run_query_inference(infer: Callable, query_loader,
                        id_map: Dict[int, int], evaluator, *,
                        device: Union[str, torch.device] = "cuda",
                        stats: Optional[Dict] = None) -> Dict:
    """PHASE 2: ``infer(images, image_sizes) -> Detections`` over the query
    set, into ``evaluator``; returns ``evaluator.evaluate()``."""
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    contiguous_to_dataset = {v: k for k, v in id_map.items()}
    times, n_imgs = [], 0
    for i, batch in enumerate(_taken(_device_prefetch(
            query_loader, ("images", "image_sizes"), dev), stats,
            "query_wait_s")):
        with span("infer", stats, "query_s") as enqueue:
            out = infer(batch["images"], batch["image_sizes"])
        with span("fetch", stats, "query_s") as fetch:
            det = out.numpy()
        n = int(batch["batch_valid"].sum())
        _add(stats, "query_batches", 1)
        _add(stats, "query_images", n)
        if i >= WARMUP:
            times.append((enqueue.seconds + fetch.seconds, n))
        n_imgs += n
        with span("evaluator", stats, "evaluator_s"):
            evaluator.process(detections_to_coco_results(
                det, batch["image_ids"], batch["image_sizes_host"],
                batch["orig_sizes"], contiguous_to_dataset,
                batch_valid=batch["batch_valid"]))
    if times:
        tot_t = sum(t for t, _ in times)
        tot_n = sum(n for _, n in times)
        print(f"[meta-eval] query inference: {tot_n/max(tot_t,1e-9):.2f} "
              f"img/s ({n_imgs} images)")
    with span("evaluate", stats, "evaluate_s"):
        return evaluator.evaluate()


class MetaTestDriver:
    """Repeat-seeded meta-test: phases 1+2 per seed, mean±std aggregation
    (reference TEST.REPEAT_TEST, meta_fcos_runner.py:480-631).

    ``infer_factory(model, bank) -> infer(images, sizes)`` overrides the
    default one-stage decode path. ``mesh``: a ``DataGroup``; with more
    than one rank, phase 1 is sharded over them
    (``generate_class_codes_sharded``, JAX :479-482). After ``run_once``
    the driver keeps the normalized bank it served (``bank``) and its phase
    times (``stats``).
    """

    def __init__(self, model, dataset_dict, mapper, grid,
                 decode_cfg: DecodeCfg, *, eval_shot: int = 10,
                 evaluator_factory: Callable = None,
                 save_dir: Optional[str] = None,
                 use_all_gts_in_base: bool = False,
                 base_chunk_size: int = 10, base_max_records: int = 100,
                 eval_batch: int = 1,
                 infer_factory: Optional[Callable] = None,
                 class_batch: int = 1,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[DataGroup] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model
        self.dataset_dict = dataset_dict
        self.mapper = mapper
        self.grid = grid
        self.decode_cfg = decode_cfg
        self.eval_shot = eval_shot
        self.evaluator_factory = evaluator_factory
        self.save_dir = save_dir
        self.use_all_gts_in_base = use_all_gts_in_base
        self.base_chunk_size = base_chunk_size
        self.base_max_records = base_max_records
        self.eval_batch = eval_batch
        self.infer_factory = infer_factory
        self.class_batch = class_batch
        self.bank: Optional[Dict[str, np.ndarray]] = None
        self.stats: Dict[str, float] = {}

    def run_once(self, meta_test_seed: int = 0) -> Dict:
        stats: Dict[str, float] = {}
        t_start = time.perf_counter()
        sup_ds = MetaDataset(self.dataset_dict, "episodic_test_supportset",
                             num_shot=self.eval_shot,
                             meta_test_seed=meta_test_seed)
        if self.mesh is not None and self.mesh.world > 1:
            codes = generate_class_codes_sharded(
                self.model, build_support_set_loader(
                    sup_ds, self.mapper, rank=self.mesh.rank,
                    world_size=self.mesh.world), self.mesh,
                save_dir=self.save_dir, class_batch=self.class_batch,
                device=self.device, stats=stats)
        else:
            codes = generate_class_codes(
                self.model, build_support_set_loader(sup_ds, self.mapper),
                save_dir=self.save_dir, class_batch=self.class_batch,
                device=self.device, stats=stats)
        meta = self.dataset_dict["metadata"]
        if self.use_all_gts_in_base:
            # base classes get all-GT accumulated codes; few-shot codes
            # stay for classes marked novel (reference
            # USE_ALL_GTS_IN_BASE_CLASSES, meta_fcos_runner.py:520-532)
            id_map = meta["thing_dataset_id_to_contiguous_id"]
            novel_cids = {id_map[d] for d in meta.get("novel_dataset_ids", [])
                          if d in id_map}
            base_codes = generate_base_class_codes(
                self.model, sup_ds, self.mapper,
                chunk_size=self.base_chunk_size,
                max_records=self.base_max_records, device=self.device,
                stats=stats)
            codes = replace_with_base_codes(
                codes, {c: v for c, v in base_codes.items()
                        if c not in novel_cids})
        with span("normalize", stats, "normalize_s"):
            bank = normalize_class_codes(self.model, codes, device=self.device)
        self.bank = bank

        qry_ds = MetaDataset(self.dataset_dict, "episodic_test_queryset",
                             num_shot=self.eval_shot)
        evaluator = self.evaluator_factory(qry_ds.query, meta)
        if self.infer_factory is not None:
            infer = self.infer_factory(self.model, bank)
        else:
            infer = make_fcos_infer(self.model, bank, self.grid,
                                    self.decode_cfg, device=self.device)
        res = run_query_inference(
            infer, build_query_loader(qry_ds, self.mapper,
                                      batch_size=self.eval_batch),
            meta["thing_dataset_id_to_contiguous_id"], evaluator,
            device=self.device, stats=stats)
        stats["total_s"] = time.perf_counter() - t_start
        self.stats = stats
        return res

    def run_repeated(self, repeats: int = 1) -> Dict:
        import warnings

        all_res = [self.run_once(s) for s in range(repeats)]
        flat = [r["bbox"] for r in all_res]
        keys = [k for k in flat[0] if isinstance(flat[0][k], float)]
        agg = {}
        with warnings.catch_warnings():
            # all-NaN metric slices (e.g. APl with no large GT) mean
            # "undefined for this data", as the reference's -1 does
            warnings.simplefilter("ignore", RuntimeWarning)
            for k in keys:
                vals = np.asarray([f[k] for f in flat], np.float64)
                agg[k] = float(np.nanmean(vals))
                agg[f"{k}_std"] = float(np.nanstd(vals))
        return {"bbox": agg, "runs": flat}
