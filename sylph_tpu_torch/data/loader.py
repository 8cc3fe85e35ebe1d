"""Meta-test batch assembly and prefetching (port of the eval loaders of
sylph_tpu/data/loader.py).

Each loader yields dicts of fixed-shape numpy arrays; a thread pool
decodes and maps records ahead of the consumer (PIL releases the GIL in
its decode and resample paths, so threads scale). The episodic and
pretrain train loaders, and their samplers, belong to the training slice.

The query loader writes its images into a reused ring of batch buffers
(``_BufferPool``): a consumer that keeps a batch past the ring's depth
must copy it. ``evaluation/meta_eval.py`` copies every batch to the model's
device (a real copy on the CPU too) before the slot can come round again.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .mapper import EpisodicMapper
from .meta_dataset import MetaDataset

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
    collection, an exception in the consumer) cancels the worker.
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
