"""Samplers for the train loaders (port of sylph_tpu/data/samplers.py).

* ``TrainingClassSampler`` — infinite shuffled stream of class indices
  (detectron2 TrainingSampler over the class axis); ``EpochShuffleSampler``
  is the same loop over image indices.
* ``RepeatFactorClassSampler`` — LVIS-style repeat-factor sampling over
  classes keyed by support-set counts (reference
  ``SupportSetRepeatFactorTrainingSampler``, dataset_sampler/sampler.py:
  16-65): r(c) = max(1, sqrt(t / f(c))), fractional parts rounded
  stochastically per epoch.
* ``RepeatFactorImageSampler`` — detectron2's image-level
  RepeatFactorTrainingSampler (LVIS pretraining).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List

import numpy as np


class TrainingClassSampler:
    def __init__(self, num_classes: int, seed: int = 0, shuffle: bool = True):
        self.num_classes = num_classes
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        while True:
            order = np.arange(self.num_classes)
            if self.shuffle:
                self.rng.shuffle(order)
            yield from order.tolist()


class RepeatFactorImageSampler:
    """Category frequency f(c) = share of images containing c; r(c) =
    max(1, sqrt(t / f(c))); an image's factor is the largest of its
    categories'; fractional parts rounded stochastically per epoch, then
    shuffled."""

    def __init__(self, records, repeat_thresh: float = 0.001, seed: int = 0,
                 shuffle: bool = True):
        n = len(records)
        counts = Counter()
        for rec in records:
            counts.update({a["category_id"] for a in rec["annotations"]})
        cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / (cnt / n)))
                   for c, cnt in counts.items()}
        self.repeat_factors = np.asarray([
            max((cat_rep[a["category_id"]] for a in rec["annotations"]),
                default=1.0)
            for rec in records])
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle

    def _epoch_indices(self) -> List[int]:
        rands = self.rng.rand(len(self.repeat_factors))
        ints = np.floor(self.repeat_factors)
        rep = (ints + (rands < (self.repeat_factors - ints))).astype(int)
        out = np.repeat(np.arange(len(rep)), rep)
        if self.shuffle:
            self.rng.shuffle(out)
        return out.tolist()

    def __iter__(self) -> Iterator[int]:
        while True:
            yield from self._epoch_indices()


# every index once per epoch, reshuffled each epoch: the class sampler's loop
EpochShuffleSampler = TrainingClassSampler


class RepeatFactorClassSampler:
    def __init__(self, support_counts: Dict[int, int],
                 repeat_thresh: float = 0.001, seed: int = 0):
        self.classes = sorted(support_counts)
        total = float(sum(support_counts.values()))
        freq = np.asarray([support_counts[c] / total for c in self.classes])
        self.repeat_factors = np.maximum(
            1.0, np.sqrt(repeat_thresh / np.maximum(freq, 1e-12)))
        self.rng = np.random.RandomState(seed)

    def _epoch_indices(self) -> List[int]:
        rands = self.rng.rand(len(self.classes))
        ints = np.floor(self.repeat_factors)
        rep = ints + (rands < (self.repeat_factors - ints))
        out = []
        for ci, r in enumerate(rep.astype(int)):
            out.extend([self.classes[ci]] * r)
        order = np.asarray(out)
        self.rng.shuffle(order)
        return order.tolist()

    def __iter__(self) -> Iterator[int]:
        while True:
            yield from self._epoch_indices()
