"""Episodic dataset construction and sampling (the port's own copy of
sylph_tpu/data/meta_dataset.py; the test stages draw exactly what the JAX
package draws).

Rebuilds the reference's dict-of-datasets representation and
``MetaDatasetFromDict`` (data/build.py:50-295, meta_coco.py:289-392,
meta_lvis.py):

  * ``load_coco_json`` — plain-json COCO parsing into detectron2-style
    records (no pycocotools dependency);
  * ``load_meta_coco`` — {contiguous cid: per-class support records
    (anns filtered to that class, meta_coco.py:133-164), -1: query list,
    "metadata": ...}; support always comes from train2017, query from
    the stage's json (meta_coco.py:320-340); split=="all" downsamples
    novel-class support to EVAL_SHOT (meta_coco.py:355-364);
  * ``MetaDataset`` — the 4 stages with the reference's exact
    determinism: test support sets drawn under
    ``temp_seed(2021 + meta_test_seed + class_idx)``
    (data/build.py:121, 259-269); train episodes sample SHOT+QUERY_SHOT
    records per class without replacement when possible
    (data/build.py:188-230; query records are re-expanded to the full
    image annotation list via img2annotation);
  * SYLPH_TEST_MODE shrink: val query truncated to 10 images
    (meta_coco.py:370-373).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def temp_seed(seed: int):
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


def _test_mode() -> bool:
    return bool(os.environ.get("SYLPH_TEST_MODE", False))


# --------------------------------------------------------------------- COCO IO
def _parse_coco(json_file: str):
    with open(json_file) as f:
        data = json.load(f)
    anns_by_img = defaultdict(list)
    for a in data.get("annotations", []):
        anns_by_img[a["image_id"]].append(a)
    return data, anns_by_img


def load_coco_json(json_file: str, image_root: str,
                   id_map: Dict[int, int],
                   filter_empty: bool = False) -> List[dict]:
    """COCO json → list of records with anns remapped to contiguous ids.

    Record format mirrors detectron2: file_name, image_id, height, width,
    annotations=[{bbox (XYWH abs), category_id (contiguous), iscrowd}].

    Images with no in-split annotations are KEPT by default — the
    reference appends every image unconditionally (meta_coco.py:66-89,
    ``record["annotations"] = objs`` may be empty), so eval-query sets
    include GT-free images on which false positives must count against
    AP. Pass ``filter_empty=True`` for training loaders (detectron2's
    filter_empty_annotations behavior).
    """
    data, anns_by_img = _parse_coco(json_file)
    out = []
    for img in data["images"]:
        objs = []
        for a in anns_by_img.get(img["id"], []):
            if a.get("ignore", 0):
                continue
            if a["category_id"] not in id_map:
                continue
            objs.append({
                "bbox": list(a["bbox"]),
                "category_id": id_map[a["category_id"]],
                "iscrowd": a.get("iscrowd", 0),
            })
        if objs or not filter_empty:
            out.append({
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": objs,
            })
    return out


def _image_rel_path(img: dict) -> str:
    """file_name for COCO; LVIS stores coco_url .../train2017/xxx.jpg."""
    if "file_name" in img:
        return img["file_name"]
    return "/".join(img["coco_url"].split("/")[-2:])


def _support_index(records_json, image_root, id_map):
    """Per-class support records: one (image, anns-of-that-class) pair
    per image per class (meta_coco.py:133-164)."""
    data, anns_by_img = records_json
    support = defaultdict(list)
    for img in data["images"]:
        per_class = defaultdict(list)
        for a in anns_by_img.get(img["id"], []):
            if a.get("ignore", 0) or a.get("iscrowd", 0):
                continue
            if a["category_id"] in id_map:
                per_class[id_map[a["category_id"]]].append({
                    "bbox": list(a["bbox"]),
                    "category_id": id_map[a["category_id"]],
                    "iscrowd": 0,
                })
        base = {
            "file_name": os.path.join(image_root, _image_rel_path(img)),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
        }
        for cid, objs in per_class.items():
            support[cid].append({**base, "annotations": objs})
    return support


def load_meta_coco(root: str, stage: str, split: str, metadata: dict,
                   eval_shot: int = 10) -> Dict:
    """Build the episodic dict-of-datasets for COCO (meta_coco.py:289-374)."""
    anno_dir = os.path.join(root, "annotations")
    id_map = metadata["thing_dataset_id_to_contiguous_id"]

    support_json = _parse_coco(
        os.path.join(anno_dir, "instances_train2017.json"))
    dataset: Dict = {"metadata": copy.deepcopy(metadata)}
    dataset.update(_support_index(
        support_json, os.path.join(root, "train2017"), id_map))

    if split == "all":
        # novel-class support downsampled to EVAL_SHOT (meta_coco.py:355-364)
        for did in metadata.get("novel_dataset_ids", []):
            if did not in id_map:  # robust to subset jsons
                continue
            cid = id_map[did]
            if cid in dataset and len(dataset[cid]) > eval_shot:
                dataset[cid] = list(np.random.choice(
                    dataset[cid], eval_shot, replace=False))

    query_json = os.path.join(anno_dir, f"instances_{stage}2017.json")
    dataset[-1] = load_coco_json(
        query_json, os.path.join(root, f"{stage}2017"), id_map)
    if _test_mode() and stage == "val":
        dataset[-1] = dataset[-1][:10]
    return dataset


# --------------------------------------------------------------------- LVIS IO
def load_lvis_json(json_file: str, coco_image_root: str,
                   category_ids: List[int],
                   filter_empty: bool = False) -> List[dict]:
    """LVIS v1 json → records (category names live in the json itself).

    GT-empty images are KEPT by default (see ``load_coco_json``): they
    carry ``neg_category_ids`` that define the federated-evaluation
    universe, and FPs on them must count (reference meta_lvis.py keeps
    every image). ``filter_empty=True`` is for training loaders only.

    ``json_file`` may be an already-parsed LVIS dict — callers that
    also need the json's ``categories`` (the partial-vocabulary
    contiguous-id map in ``catalog.py``) parse once and pass it in;
    a full-scale lvis_v1_train.json is ~1 GB and json.load dominates.
    """
    if isinstance(json_file, dict):
        data = json_file
    else:
        with open(json_file) as f:
            data = json.load(f)
    id_map = {did: i for i, did in enumerate(sorted(category_ids))}
    anns_by_img = defaultdict(list)
    for a in data.get("annotations", []):
        anns_by_img[a["image_id"]].append(a)
    out = []
    for img in data["images"]:
        # LVIS stores coco_url like .../train2017/xxx.jpg
        coco_url = img.get("coco_url", "")
        rel = "/".join(coco_url.split("/")[-2:]) if coco_url else \
            img.get("file_name", "")
        objs = []
        for a in anns_by_img.get(img["id"], []):
            if a["category_id"] in id_map:
                objs.append({
                    "bbox": list(a["bbox"]),
                    "category_id": id_map[a["category_id"]],
                    "iscrowd": 0,
                })
        if objs or not filter_empty:
            out.append({
                "file_name": os.path.join(coco_image_root, rel),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": objs,
                "not_exhaustive_category_ids":
                    img.get("not_exhaustive_category_ids", []),
                "neg_category_ids": img.get("neg_category_ids", []),
            })
    return out


def _support_index_per_annotation(records_json, image_root, id_map):
    """LVIS support protocol: ONE record per (image, annotation) — the
    reference explicitly splits multi-instance images so "each record has
    only one annotation" (meta_lvis.py:268-272). Classes appear in
    first-seen order (defaultdict insertion order), which the shuffle
    below depends on for stream parity."""
    data, anns_by_img = records_json
    support = defaultdict(list)
    for img in data["images"]:
        per_class = defaultdict(list)
        for a in anns_by_img.get(img["id"], []):
            if a.get("ignore", 0):
                continue
            if a["category_id"] in id_map:
                per_class[id_map[a["category_id"]]].append({
                    "bbox": list(a["bbox"]),
                    "category_id": id_map[a["category_id"]],
                    "iscrowd": 0,
                })
        base = {
            "file_name": os.path.join(image_root, _image_rel_path(img)),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
        }
        for cid, objs in per_class.items():
            for obj in objs:
                support[cid].append({**base, "annotations": [obj]})
    return support


def _lvis_ids_for_split(split: str, cats: Dict[int, dict]):
    """Split table lookup, plus the synset-defined 'cnno' split (LVIS
    minus COCO-novel-overlapping synsets, reference classes.py:44,147)."""
    if split == "cnno":
        from .class_splits import LVIS_COCO_NOVEL_OVERLAP_SYNSETS
        return [d for d, c in cats.items()
                if c.get("synset") not in LVIS_COCO_NOVEL_OVERLAP_SYNSETS]
    from .class_splits import lvis_split_ids
    return lvis_split_ids(split)


def downsample_class_annotations(records: List[dict], class_ids, shot: int,
                                 seed: int = 2021) -> List[dict]:
    """Keep at most ``shot`` annotations per class in ``class_ids``
    (other classes keep everything) — the joint-pretrain protocol where
    the "all" split carries full base GT but TRAIN_SHOT-limited novel GT
    (reference meta_coco.py pretrain split=="all" path, :167-286).
    Records left with no annotations are dropped."""
    class_ids = set(class_ids)
    per_class = defaultdict(list)
    for ri, rec in enumerate(records):
        for ai, a in enumerate(rec["annotations"]):
            if a["category_id"] in class_ids:
                per_class[a["category_id"]].append((ri, ai))
    drop = set()
    with temp_seed(seed):
        for cid in sorted(per_class):
            pairs = per_class[cid]
            if len(pairs) <= shot:
                continue
            keep_idx = set(np.random.choice(len(pairs), shot,
                                            replace=False).tolist())
            drop.update(p for i, p in enumerate(pairs)
                        if i not in keep_idx)
    out = []
    for ri, rec in enumerate(records):
        anns = [a for ai, a in enumerate(rec["annotations"])
                if (ri, ai) not in drop]
        if anns:
            rec = dict(rec)
            rec["annotations"] = anns
            out.append(rec)
    return out


def sample_fewshot_records(records: List[dict], shot: int,
                           seed: int = 2021) -> List[dict]:
    """Balanced K-shot subset for TFA-style finetuning (the reference
    registers coco_pretrain_finetune_* via the TFA few-shot protocol):
    up to ``shot`` annotations per class, selected deterministically,
    re-grouped into image records carrying only the kept annotations."""
    per_class = defaultdict(list)
    for ri, rec in enumerate(records):
        for ai, a in enumerate(rec["annotations"]):
            per_class[a["category_id"]].append((ri, ai))
    keep = defaultdict(list)  # record idx -> kept annotation idxs
    with temp_seed(seed):
        for cid in sorted(per_class):
            pairs = per_class[cid]
            idx = np.random.choice(len(pairs), min(shot, len(pairs)),
                                   replace=False)
            for i in idx:
                ri, ai = pairs[i]
                keep[ri].append(ai)
    out = []
    for ri in sorted(keep):
        rec = dict(records[ri])
        rec["annotations"] = [records[ri]["annotations"][ai]
                              for ai in sorted(keep[ri])]
        out.append(rec)
    return out


def load_meta_lvis(root: str, coco_image_root: str, stage: str,
                   split: str) -> Dict:
    """Episodic dict for LVIS (meta_lvis.py analog). Support always from
    the train json, one record per annotation; per-class lists shuffled
    under a SINGLE temp_seed(2021) spanning the whole loop in first-seen
    class order (meta_lvis.py:279-281 — one seeding, sequential Mersenne
    draws across classes)."""
    from .class_splits import lvis_split_ids

    with open(os.path.join(root, "lvis_v1_train.json")) as f:
        train = json.load(f)
    cats = {c["id"]: c for c in train["categories"]}
    # intersect the benchmark split table with the categories actually
    # present in the json (robust to subset jsons)
    ids = sorted(d for d in _lvis_ids_for_split(split, cats) if d in cats)
    id_map = {did: i for i, did in enumerate(ids)}
    metadata = {
        "split": split,
        "thing_classes": [cats[d]["name"] for d in ids],
        "thing_dataset_id_to_contiguous_id": id_map,
        "categories": [cats[d] for d in ids],
        "evaluator_type": "lvis_meta_learn",
        # the Sylph LVIS benchmark's novel classes are the rare ones
        # (novelr = rare split, classes.py:108-161): all-GT base-code
        # accumulation (USE_ALL_GTS_IN_BASE_CLASSES) must not overwrite
        # their few-shot codes
        "novel_dataset_ids": [d for d in ids
                              if cats[d].get("frequency") == "r"],
    }
    anns_by_img = defaultdict(list)
    for a in train.get("annotations", []):
        anns_by_img[a["image_id"]].append(a)
    support = _support_index_per_annotation(
        (train, anns_by_img), coco_image_root, id_map)
    dataset: Dict = {"metadata": metadata}
    with temp_seed(2021):
        for cid in support:
            np.random.shuffle(support[cid])
    dataset.update(support)
    dataset[-1] = load_lvis_json(
        os.path.join(root, f"lvis_v1_{stage}.json"), coco_image_root, ids)
    if _test_mode() and stage == "val":
        dataset[-1] = dataset[-1][:10]
    return dataset


# ------------------------------------------------------------------- sampling
class MetaDataset:
    """Stage-dispatched episodic sampler over the dict-of-datasets.

    Stages (data/build.py:180-295): episodic_train_both,
    episodic_test_supportset, episodic_test_queryset.
    """

    def __init__(self, dataset_dict: Dict, stage: str, num_shot: int,
                 num_query_shot: int = 1, meta_test_seed: int = 0,
                 train_seed: int = 0):
        self.metadata = dataset_dict["metadata"]
        self.support = {cid: recs for cid, recs in dataset_dict.items()
                        if isinstance(cid, int) and cid >= 0}
        self.query = dataset_dict.get(-1, [])
        self.img2record = {r["image_id"]: r for r in self.query}
        self.classes = sorted(self.support)
        self.stage = stage
        self.num_shot = num_shot
        self.num_query_shot = num_query_shot
        self.seed = 2021 + meta_test_seed
        # Private RNG for train-time episode sampling: the reference
        # samples from the GLOBAL numpy RNG inside DataLoader workers
        # (data/build.py:202-212); with thread-based loaders a private
        # stream is required — the global one races against temp_seed
        # users on other threads.
        self._train_rng = np.random.RandomState(train_seed)

    def __len__(self):
        if self.stage == "episodic_train_both":
            return len(self.classes)
        if self.stage == "episodic_test_supportset":
            return len(self.classes)
        if self.stage == "episodic_test_queryset":
            return len(self.query)
        if self.stage == "episodic_test_continualsupportset":
            return len(self._continual_items())
        raise NotImplementedError(self.stage)

    def __getitem__(self, idx):
        if self.stage == "episodic_train_both":
            return self._train_item(idx)
        if self.stage == "episodic_test_supportset":
            return self._test_support_item(idx)
        if self.stage == "episodic_test_queryset":
            return self.query[idx]
        if self.stage == "episodic_test_continualsupportset":
            return self._continual_items()[idx]
        raise NotImplementedError(self.stage)

    def _continual_items(self, chunk_size: int = 10):
        """Materialized continual-support chunks (reference stage
        episodic_test_continualsupportset, data/build.py:232-237)."""
        if not hasattr(self, "_continual_cache"):
            self._continual_cache = list(
                self.continual_support_items(chunk_size))
        return self._continual_cache

    def _sample(self, recs, n, rng=None):
        rng = rng if rng is not None else self._train_rng
        replace = len(recs) < n
        idx = rng.choice(len(recs), n, replace=replace)
        return [recs[i] for i in idx]

    def _train_item(self, class_idx):
        cid = self.classes[class_idx]
        recs = self.support[cid]
        picked = self._sample(recs, self.num_shot + self.num_query_shot)
        support = picked[:self.num_shot]
        # query records carry the image's FULL annotation list; class
        # filtering happens on-device (steps.py) as in the reference.
        query = []
        for q in picked[self.num_shot:]:
            full = self.img2record.get(q["image_id"], q)
            query.append(full)
        return {"support_set": support, "query_set": query,
                "support_set_target": cid}

    def continual_support_items(self, chunk_size: int = 10,
                                max_records: int = -1):
        """Chunked base-class support stream for weighted code
        accumulation (reference meta_lvis.py:284-311 builds chunks of 10
        annotations with len/total weights; here chunks are records —
        each record carries the image's annotations of that class).

        Yields {support_set, support_set_target, class_name, weight}.
        """
        for ci, cid in enumerate(self.classes):
            recs = self.support[cid]
            if max_records > 0:
                recs = recs[:max_records]
            total = len(recs)
            for i in range(0, total, chunk_size):
                chunk = recs[i:i + chunk_size]
                yield {
                    "support_set": chunk,
                    "support_set_target": cid,
                    "class_name": self.metadata["thing_classes"][cid],
                    "weight": len(chunk) / total,
                }

    def _test_support_item(self, class_idx):
        cid = self.classes[class_idx]
        recs = self.support[cid]
        # RandomState(seed) reproduces the reference's
        # temp_seed(2021+seed+idx) global-RNG draws exactly (same
        # Mersenne stream) without touching the global state — immune to
        # concurrent loader threads.
        rng = np.random.RandomState(self.seed + class_idx)
        replace = len(recs) < self.num_shot
        picked = [recs[i] for i in rng.choice(len(recs), self.num_shot,
                                              replace=replace)]
        name = self.metadata["thing_classes"][cid]
        return {"support_set": picked, "support_set_target": cid,
                "class_name": name}
