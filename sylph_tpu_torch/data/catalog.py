"""Dataset and metadata catalogs (the port's own copy of
sylph_tpu/data/catalog.py, with catalogs of its own: registering a root
here does not register it in the JAX package).

Lightweight equivalents of detectron2's DatasetCatalog/MetadataCatalog,
plus registration of the Sylph dataset family under the reference naming
convention ``{coco,lvis}_{pretrain,meta}_{train,val}_{split}``
(builtin_dataset_few_shot_detection.py:38-224).

Unlike the reference (module-import side effects + a mutable global
config read inside loaders — SURVEY.md §5 flags this as a wart),
registration here is explicit: call ``register_all_coco(root)`` /
``register_all_lvis(root)`` with the dataset root.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, List


class _Catalog:
    def __init__(self):
        self._map: Dict[str, Callable] = {}

    def register(self, name: str, fn: Callable):
        self._map[name] = fn

    def get(self, name: str, **kwargs):
        """kwargs are forwarded to the factory (e.g. ``shot=`` for the
        TFA few-shot subsets — the reference reads TRAIN_SHOT through
        its global cfg; here the runner passes it explicitly)."""
        return self._map[name](**kwargs)

    def list(self) -> List[str]:
        return sorted(self._map)

    def __contains__(self, name):
        return name in self._map

    def clear(self):
        self._map.clear()


class _MetaCatalog:
    def __init__(self):
        self._map: Dict[str, dict] = {}

    def set(self, name: str, **kwargs):
        self._map.setdefault(name, {}).update(kwargs)

    def get(self, name: str) -> dict:
        return self._map[name]

    def __contains__(self, name):
        return name in self._map

    def clear(self):
        self._map.clear()


DatasetCatalog = _Catalog()
MetadataCatalog = _MetaCatalog()


def _coco_metadata(split: str, categories: List[dict],
                   evaluator_type: str = "coco_meta_learn") -> dict:
    """Build the id maps + class names for one split.

    categories: COCO-format category dicts (id, name) restricted to the
    split, sorted by original id — matching the reference's contiguous
    id assignment (builtin_meta_dataset_few_shot_detection.py).
    evaluator_type drives runner.get_evaluator dispatch (reference
    meta_fcos_runner.py:116-149 reads MetadataCatalog.evaluator_type).
    """
    cats = sorted(categories, key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    return {
        "split": split,
        "thing_classes": [c["name"] for c in cats],
        "thing_dataset_id_to_contiguous_id": id_map,
        "evaluator_type": evaluator_type,
    }


def register_all_coco(root: str = "datasets/coco",
                      categories: List[dict] = None):
    """Register the COCO few-shot family.

    Names (reference builtin_dataset_few_shot_detection.py:42-224):
      coco_pretrain_{train,val}_base       — 60 base classes
      coco_meta_{train,val}_{base,novel,all}
    """
    from .class_splits import coco_split_ids
    from .meta_dataset import load_coco_json, load_meta_coco

    anno_dir = os.path.join(root, "annotations")

    def cats_for(split):
        ids = set(coco_split_ids(split))
        if categories is not None:
            return [c for c in categories if c["id"] in ids]
        # late-bind names from the train json when first loaded
        train_json = os.path.join(anno_dir, "instances_train2017.json")
        import json
        with open(train_json) as f:
            all_cats = json.load(f)["categories"]
        return [c for c in all_cats if c["id"] in ids]

    for stage in ("train", "val"):
        img_dir = os.path.join(root, f"{stage}2017")
        json_file = os.path.join(anno_dir, f"instances_{stage}2017.json")
        # pretraining (plain detection) on each split; "all" carries
        # novel_dataset_ids so evaluators can report nAP/bAP
        for split in ("base", "novel", "all"):
            name = f"coco_pretrain_{stage}_{split}"

            def make_pretrain(json_file=json_file, img_dir=img_dir,
                              split=split, stage=stage, shot=10):
                from .meta_dataset import downsample_class_annotations
                m = _coco_metadata(split, cats_for(split),
                                   evaluator_type="coco")
                # train: filter GT-empty images (detectron2 training
                # behavior); val: keep them — FPs there must count
                # (reference meta_coco.py:66-89 keeps every image)
                recs = load_coco_json(
                    json_file, img_dir,
                    m["thing_dataset_id_to_contiguous_id"],
                    filter_empty=(stage == "train"))
                if split == "all":
                    m["novel_dataset_ids"] = list(coco_split_ids("novel"))
                    if stage == "train":
                        # joint pretrain: full base GT, novel classes
                        # limited to TRAIN_SHOT annotations (reference
                        # meta_coco.py pretrain split=="all", :167-286)
                        id_map = m["thing_dataset_id_to_contiguous_id"]
                        novel_cids = [id_map[d]
                                      for d in m["novel_dataset_ids"]
                                      if d in id_map]
                        recs = downsample_class_annotations(
                            recs, novel_cids, shot)
                return {"records": recs, "metadata": m}

            DatasetCatalog.register(name, make_pretrain)
            MetadataCatalog.set(name, lazy_split=split, root=root)

    # TFA K-shot finetune subsets (reference registers
    # coco_pretrain_finetune_* through the TFA few-shot protocol)
    for split in ("all", "novel"):
        name = f"coco_pretrain_finetune_{split}"

        def make_finetune(split=split, shot=10):
            from .meta_dataset import sample_fewshot_records
            m = _coco_metadata(split, cats_for(split),
                               evaluator_type="coco")
            if split == "all":
                m["novel_dataset_ids"] = list(coco_split_ids("novel"))
            recs = load_coco_json(
                os.path.join(anno_dir, "instances_train2017.json"),
                os.path.join(root, "train2017"),
                m["thing_dataset_id_to_contiguous_id"])
            return {"records": sample_fewshot_records(recs, shot),
                    "metadata": m}

        DatasetCatalog.register(name, make_finetune)
        MetadataCatalog.set(name, lazy_split=split, root=root)

    for stage in ("train", "val"):
        img_dir = os.path.join(root, f"{stage}2017")
        json_file = os.path.join(anno_dir, f"instances_{stage}2017.json")

        for split in ("base", "novel", "all"):
            name = f"coco_meta_{stage}_{split}"

            def make_meta(stage=stage, split=split, img_dir=img_dir):
                m = _coco_metadata(split, cats_for(split))
                if split == "all":
                    m["novel_dataset_ids"] = list(coco_split_ids("novel"))
                return load_meta_coco(root, stage, split, m)

            DatasetCatalog.register(name, make_meta)
            MetadataCatalog.set(name, lazy_split=split, root=root)


def register_all_lvis(root: str = "datasets/lvis",
                      coco_image_root: str = "datasets/coco"):
    """Register the LVIS v1 few-shot family (meta_lvis.py analog):
      lvis_pretrain_{train,val}_{basefc,basemix,basev1,basev2,...}
      lvis_meta_{train,val}_{split}
    """
    from .class_splits import lvis_split_ids
    from .meta_dataset import load_meta_lvis, load_lvis_json

    pretrain_splits = ("basefc", "basemix", "basev1", "basev2", "novelr",
                       "novelv1", "all")
    meta_splits = ("basefc", "novelr", "basemix", "novelmix", "basev1",
                   "novelv1", "all", "cnno")

    # plain full-vocabulary LVIS (lvis_v1_train / lvis_v1_val)
    for stage in ("train", "val"):
        name = f"lvis_v1_{stage}"

        def make_plain(stage=stage):
            import json as _json
            with open(os.path.join(root, "lvis_v1_train.json")) as f:
                cats = _json.load(f)["categories"]
            ids = sorted(c["id"] for c in cats)
            id_map = {d: i for i, d in enumerate(ids)}
            by_id = {c["id"]: c for c in cats}
            recs = load_lvis_json(
                os.path.join(root, f"lvis_v1_{stage}.json"),
                coco_image_root, ids)
            return {"records": recs,
                    "metadata": {"split": "v1",
                                 "thing_classes": [by_id[d]["name"]
                                                   for d in ids],
                                 "thing_dataset_id_to_contiguous_id":
                                     id_map,
                                 "categories": [by_id[d] for d in ids],
                                 "evaluator_type": "lvis"}}

        DatasetCatalog.register(name, make_plain)
        MetadataCatalog.set(name, lazy_split="v1", root=root)

    # TFA K-shot finetune subset over all classes
    def make_lvis_finetune(shot=10):
        from .meta_dataset import sample_fewshot_records
        d = DatasetCatalog.get("lvis_pretrain_train_all")
        return {"records": sample_fewshot_records(d["records"], shot),
                "metadata": d["metadata"]}

    DatasetCatalog.register("lvis_pretrain_finetune_all",
                            make_lvis_finetune)
    MetadataCatalog.set("lvis_pretrain_finetune_all", lazy_split="all",
                        root=root)

    for stage in ("train", "val"):
        json_file = os.path.join(root, f"lvis_v1_{stage}.json")
        for split in pretrain_splits:
            name = f"lvis_pretrain_{stage}_{split}"

            def make_pre(json_file=json_file, split=split, stage=stage):
                # contiguous ids over the split classes PRESENT in the
                # json (detectron2 semantics: the metadata map covers
                # the dataset's categories) — mapping over the full
                # benchmark table instead put labels >= NUM_CLASSES on
                # partial-vocabulary jsons, silently zeroing every cls
                # target (caught by the LVIS held-out pretrain stage:
                # cls loss pinned at 1e-4, AP exactly 0). On full-scale
                # LVIS jsons every table id is present, so this is a
                # no-op there.
                import json as _json
                with open(json_file) as f:
                    data = _json.load(f)
                present = {c["id"] for c in data["categories"]}
                ids = sorted(set(lvis_split_ids(split)) & present)
                # pass the parsed dict: a second json.load of a
                # full-scale LVIS json costs minutes on this host
                recs = load_lvis_json(data, coco_image_root, ids,
                                      filter_empty=(stage == "train"))
                id_map = {d: i for i, d in enumerate(ids)}
                return {"records": recs,
                        "metadata": {"split": split,
                                     "thing_classes": [str(d) for d in
                                                       sorted(ids)],
                                     "thing_dataset_id_to_contiguous_id":
                                         id_map,
                                     "evaluator_type": "lvis"}}

            DatasetCatalog.register(name, make_pre)
            MetadataCatalog.set(name, lazy_split=split, root=root)
        for split in meta_splits:
            name = f"lvis_meta_{stage}_{split}"

            def make_meta(stage=stage, split=split):
                return load_meta_lvis(root, coco_image_root, stage, split)

            DatasetCatalog.register(name, make_meta)
            MetadataCatalog.set(name, lazy_split=split, root=root)
