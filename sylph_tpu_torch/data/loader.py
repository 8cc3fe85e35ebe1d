"""Batch assembly and prefetching (port of sylph_tpu/data/loader.py).

Each loader yields dicts of fixed-shape arrays; a thread pool decodes and
maps records ahead of the consumer (PIL releases the GIL in its decode and
resample paths, so threads scale).

The train and query loaders write their images into a reused ring of batch
buffers (``_BufferPool``): a consumer that keeps a batch past the ring's
depth must copy it. ``evaluation/meta_eval.py`` copies every query batch to
the model's device (a real copy on the CPU too) before the slot can come
round again; the train loaders, given ``device=``, make that copy on their
own worker thread, so the copy of batch i+1 overlaps the step on batch i.

The train loaders take ``rank`` and ``world_size`` for data parallelism:
every rank draws the whole global batch (its classes or images, records
and per-record seeds, which are cheap), then maps only its contiguous
slice, so each rank's batch is byte-equal to that slice of the batch one
process would make, and decoding is split across the ranks.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from .mapper import EpisodicMapper
from .meta_dataset import MetaDataset
from .samplers import (EpochShuffleSampler, RepeatFactorClassSampler,
                       RepeatFactorImageSampler, TrainingClassSampler)

_POOL = ThreadPoolExecutor(max_workers=8)


class _BufferPool:
    """Ring of reusable batch image buffers the mappers write into.

    Recycling the batch canvases keeps every page warm after the first lap
    (fresh allocations pay first-touch page faults on every batch).

    CONTRACT: a yielded buffer is rewritten after ``depth - 1`` further
    batches are produced. Depth must exceed every stage that can hold a
    batch at once: the loader's prefetch queue, the consumer's own
    prefetch, the batch being filled and the one in use.
    """

    def __init__(self, shape, dtype=np.uint8, depth: int = 8):
        self._bufs = [np.zeros(shape, dtype) for _ in range(depth)]
        self._i = 0

    def next(self) -> np.ndarray:
        buf = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        return buf


def _prefetch(gen_fn, depth: int = 2):
    """Run a generator on a daemon thread with a bounded queue.

    An exception in the generator is forwarded to the consumer and raised
    there, never turned into an early end (a silently truncated query set
    would skew AP). Abandoning the iterator (``.close()``, garbage
    collection, an exception in the consumer) cancels the worker and waits
    for it to finish the item it is making: a worker left copying to the
    card while the interpreter exits aborts the process.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    cancelled = threading.Event()

    def _put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in gen_fn():
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded, not dropped
            _put((stop, e))
        else:
            _put((stop, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        cancelled.set()
        if t is not threading.current_thread():
            t.join()


# host-side keys: the device RandAugment reads its op ids and sizes on the
# host, so choosing an op never waits on the card
_HOST_KEYS = ("aug_ops", "aug_params", "image_sizes", "query_aug_ops",
              "query_aug_params", "query_image_sizes")


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: Optional[Union[str, torch.device]]) -> Dict:
    """Copy a batch's arrays to ``device`` (a real copy on the CPU too: the
    images sit in a ring buffer that is rewritten later); ``None`` keeps
    numpy."""
    if device is None:
        return batch
    return {k: v if k in _HOST_KEYS else
            torch.from_numpy(np.ascontiguousarray(v)).to(device, copy=True)
            for k, v in batch.items()}


def _rank_slice(n: int, rank: int, world_size: int) -> slice:
    """The contiguous ``rank``-th of ``world_size`` equal parts of n."""
    if n % world_size:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{world_size} ranks")
    per = n // world_size
    return slice(rank * per, (rank + 1) * per)


def build_episodic_train_loader(
    dataset: MetaDataset, mapper: EpisodicMapper, *, episodes_per_batch: int,
    seed: int = 0, sampler: str = "TrainingSampler",
    repeat_thresh: float = 0.001, prefetch: int = 2, retain: int = 2,
    device: Optional[Union[str, torch.device]] = None,
    rank: int = 0, world_size: int = 1,
) -> Iterator[Dict]:
    """Infinite episodic batches (reference
    build_meta_detection_train_loader, data/build.py:424-492): E episodes,
    each SHOT support and QUERY_SHOT query records of one class, in the
    ``make_episodic_train_step`` layout.

    ``retain``: the most batches the consumer holds at once; it sizes the
    buffer ring. Per-record seeds keep the result independent of the order
    in which the pool finishes. ``rank`` of ``world_size``: this rank's
    contiguous slice of the E episodes."""
    if sampler == "RepeatFactorTrainingSampler":
        counts = {c: len(dataset.support[c]) for c in dataset.classes}
        class_iter = iter(RepeatFactorClassSampler(
            counts, repeat_thresh, seed))
    else:
        class_iter = iter(TrainingClassSampler(len(dataset.classes), seed))
    rng = np.random.RandomState(seed + 1)
    e = episodes_per_batch
    mine = _rank_slice(e, rank, world_size)

    def gen():
        sup_pool = qry_pool = None
        while True:
            sup_recs, qry_recs, class_ids = [], [], []
            for _ in range(e):
                ci = next(class_iter)
                item = dataset._train_item(ci)
                class_ids.append(item["support_set_target"])
                sup_recs.extend(item["support_set"])
                qry_recs.extend(item["query_set"])
            seeds = rng.randint(0, 2 ** 31, len(sup_recs) + len(qry_recs))
            sup_seeds, qry_seeds = (seeds[:len(sup_recs)],
                                    seeds[len(sup_recs):])
            ns, nq = len(sup_recs) // e, len(qry_recs) // e  # per episode
            sup_sl = slice(mine.start * ns, mine.stop * ns)
            qry_sl = slice(mine.start * nq, mine.stop * nq)
            sup_recs, sup_seeds = sup_recs[sup_sl], sup_seeds[sup_sl]
            qry_recs, qry_seeds = qry_recs[qry_sl], qry_seeds[qry_sl]
            class_ids = class_ids[mine]
            if sup_pool is None:
                sup_pool = _BufferPool(
                    (len(sup_recs), *mapper.support_canvas, 3),
                    depth=retain + prefetch + 4)
                qry_pool = _BufferPool(
                    (len(qry_recs), *mapper.train_canvas, 3),
                    depth=retain + prefetch + 4)
            sup_buf, qry_buf = sup_pool.next(), qry_pool.next()
            sup_f = [_POOL.submit(
                mapper.map_support, r, np.random.RandomState(s), True,
                sup_buf[i])
                for i, (r, s) in enumerate(zip(sup_recs, sup_seeds))]
            qry_f = [_POOL.submit(
                mapper.map_query_train, r, np.random.RandomState(s),
                qry_buf[i])
                for i, (r, s) in enumerate(zip(qry_recs, qry_seeds))]
            sup = [f.result() for f in sup_f]
            qmaps = [f.result() for f in qry_f]
            batch = {
                "support_images": sup_buf,
                "support_boxes": np.stack([m["box"] for m in sup]),
                "support_box_valid": np.asarray(
                    [m["box_valid"] for m in sup], bool),
                "query_images": qry_buf,
                "query_gt_boxes": np.stack([m["gt_boxes"] for m in qmaps]),
                "query_gt_labels": np.stack(
                    [m["gt_labels"] for m in qmaps]).astype(np.int32),
                "query_gt_valid": np.stack([m["gt_valid"] for m in qmaps]),
                "episode_class_ids": np.asarray(class_ids, np.int32),
            }
            if "aug_ops" in qmaps[0]:
                batch["query_aug_ops"] = np.stack(
                    [m["aug_ops"] for m in qmaps])
                batch["query_aug_params"] = np.stack(
                    [m["aug_params"] for m in qmaps])
                batch["query_image_sizes"] = np.stack(
                    [m["image_size"] for m in qmaps])
            yield batch_to_device(batch, device)

    return _prefetch(gen, prefetch)


def build_pretrain_loader(
    records, mapper: EpisodicMapper, *, batch_size: int, seed: int = 0,
    sampler: str = "TrainingSampler", repeat_thresh: float = 0.001,
    prefetch: int = 2, retain: int = 2,
    device: Optional[Union[str, torch.device]] = None,
    rank: int = 0, world_size: int = 1,
) -> Iterator[Dict]:
    """Plain detection batches for pretraining: epoch-shuffled, or
    image-level repeat-factor sampled (DATALOADER.SAMPLER_TRAIN ==
    RepeatFactorTrainingSampler). Records without annotations are dropped
    (detectron2's train-time filter). ``rank`` of ``world_size``: this
    rank's contiguous slice of the ``batch_size`` images."""
    records = [r for r in records if r.get("annotations")]
    if sampler == "RepeatFactorTrainingSampler":
        idx_iter = iter(RepeatFactorImageSampler(
            records, repeat_thresh, seed))
    else:
        idx_iter = iter(EpochShuffleSampler(len(records), seed))
    rng = np.random.RandomState(seed + 1)
    mine = _rank_slice(batch_size, rank, world_size)

    def gen():
        pool = _BufferPool((mine.stop - mine.start, *mapper.train_canvas, 3),
                           depth=retain + prefetch + 4)
        while True:
            buf = pool.next()
            idx = [next(idx_iter) for _ in range(batch_size)]
            seeds = rng.randint(0, 2 ** 31, len(idx))
            idx, seeds = idx[mine], seeds[mine]
            futs = [_POOL.submit(
                mapper.map_query_train, records[i],
                np.random.RandomState(s), buf[j])
                for j, (i, s) in enumerate(zip(idx, seeds))]
            mapped = [f.result() for f in futs]
            batch = {
                "images": buf,
                "gt_boxes": np.stack([m["gt_boxes"] for m in mapped]),
                "gt_labels": np.stack(
                    [m["gt_labels"] for m in mapped]).astype(np.int32),
                "gt_valid": np.stack([m["gt_valid"] for m in mapped]),
            }
            if "aug_ops" in mapped[0]:
                batch["aug_ops"] = np.stack([m["aug_ops"] for m in mapped])
                batch["aug_params"] = np.stack(
                    [m["aug_params"] for m in mapped])
                batch["image_sizes"] = np.stack(
                    [m["image_size"] for m in mapped])
            yield batch_to_device(batch, device)

    return _prefetch(gen, prefetch)


def build_support_set_loader(
    dataset: MetaDataset, mapper: EpisodicMapper, *,
    rank: int = 0, world_size: int = 1,
) -> Iterator[Dict]:
    """Per-class support batches for code generation (reference
    build_..._test_support_set_loader, data/build.py:519-593). The class
    axis is split across ranks like the reference's InferenceSampler."""
    rng = np.random.RandomState(0)

    def gen():
        # fresh arrays, not a ring: registration groups TPU.CLASS_BATCH
        # items, more retention than a ring can promise
        for ci in range(rank, len(dataset.classes), world_size):
            item = dataset._test_support_item(ci)
            imgs, boxes, valid = [], [], []
            for rec in item["support_set"]:
                m = mapper.map_support(rec, rng, train=False)
                imgs.append(m["image"])
                boxes.append(m["box"])
                valid.append(m["box_valid"])
            yield {
                "support_images": np.stack(imgs),
                "support_boxes": np.stack(boxes),
                "support_box_valid": np.asarray(valid, bool),
                "class_id": item["support_set_target"],
                "class_name": item["class_name"],
            }

    return _prefetch(gen)


def build_support_set_base_loader(
    dataset: MetaDataset, mapper: EpisodicMapper, *, chunk_size: int = 10,
    max_records: int = -1, rank: int = 0, world_size: int = 1,
) -> Iterator[Dict]:
    """Chunked base-class support batches for all-GT code accumulation
    (reference build_..._test_support_set_base_loader,
    data/build.py:620-688). Each item is one fixed-size chunk (padded with
    an invalid tail) plus its accumulation weight."""
    rng = np.random.RandomState(0)

    def gen():
        for i, item in enumerate(
                dataset.continual_support_items(chunk_size, max_records)):
            if i % world_size != rank:
                continue
            imgs, boxes, valid = [], [], []
            for rec in item["support_set"]:
                m = mapper.map_support(rec, rng, train=False)
                imgs.append(m["image"])
                boxes.append(m["box"])
                valid.append(m["box_valid"])
            while len(imgs) < chunk_size:
                imgs.append(imgs[-1])
                boxes.append(boxes[-1])
                valid.append(False)
            yield {
                "support_images": np.stack(imgs),
                "support_boxes": np.stack(boxes),
                "support_box_valid": np.asarray(valid, bool),
                "class_id": item["support_set_target"],
                "class_name": item["class_name"],
                "weight": item["weight"],
            }

    return _prefetch(gen)


def build_query_loader(
    dataset: MetaDataset, mapper: EpisodicMapper, *, batch_size: int = 1,
    rank: int = 0, world_size: int = 1,
) -> Iterator[Dict]:
    """Eval query batches; the last batch is padded to full size by
    repeating its last image, with a validity mask (static shapes)."""
    def gen():
        records = dataset.query[rank::world_size]
        pool = _BufferPool((batch_size, *mapper.eval_canvas, 3))
        for i in range(0, len(records), batch_size):
            chunk = records[i:i + batch_size]
            buf = pool.next()
            mapped = list(_POOL.map(mapper.map_query_eval, chunk,
                                    [buf[j] for j in range(len(chunk))]))
            n = len(mapped)
            for j in range(n, batch_size):
                buf[j] = buf[n - 1]  # padded tail
                mapped.append(mapped[-1])
            yield {
                "images": buf,
                "image_sizes": np.stack([m["image_size"] for m in mapped]),
                "image_ids": np.asarray(
                    [m["image_id"] for m in mapped], np.int64),
                "orig_sizes": np.stack(
                    [np.asarray([m["orig_height"], m["orig_width"]])
                     for m in mapped]),
                "batch_valid": np.arange(batch_size) < n,
            }

    return _prefetch(gen)
