"""Meta Faster R-CNN and TFA-RCNN runners (port of
sylph_tpu/runner/meta_faster_rcnn_runner.py): ``add_rcnn_config``,
``build_rcnn_model_from_cfg``, ``MetaFasterRCNNRunner`` (``get_default_cfg``,
``build_model`` with MODEL.WEIGHTS, ``do_train`` and ``do_test``, episodic
and plain) and ``TFAFasterRCNNRunner`` (non-episodic config, the
base-classifier surgery).

``do_train`` runs the two-stage steps of ``train/steps.py`` (episodic
meta-training, or the plain step of pretraining and the TFA-RCNN finetune)
through the one-stage runner's setup, loop, loaders and checkpoints, with
the anchors built once at the train canvas. The episodic ``do_test`` is the
two-phase meta-test with the two-stage query path
(``evaluation/meta_eval.py::make_rcnn_infer``); the plain one evaluates the
trained classifier through ``forward_base_instances``, with the anchors at
the eval canvas. Everything runs on the runner's device (default
``"cuda"``, which raises without a card), or as one rank of a
data-parallel group, as the one-stage runner does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Union

import torch

from .config import CfgNode
from .data.catalog import DatasetCatalog, MetadataCatalog
from .models.rcnn import FewShotRCNN, build_anchor_grid
from .runner import (MetaFCOSRunner, _codegen_kwargs, _mapper,
                     _plain_eval_loop, init_random_weights,
                     init_train_weights, resolve_device)
from .train.checkpoint import load_params_any
from .utils.convert_d2 import (convert_detectron2_checkpoint,
                               load_torch_state_dict)
from .train.steps import (DrawsFactory, make_rcnn_episodic_train_step,
                          make_rcnn_pretrain_train_step)
from .parallel.mesh import DataGroup


def add_rcnn_config(cfg: CfgNode) -> CfgNode:
    """RPN and ROI keys (reference Base-RCNN-FPN.yaml + detectron2
    defaults)."""
    cfg.MODEL.RPN = CfgNode()
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 1000
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    cfg.MODEL.RPN.NMS_THRESH = 0.7
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.5
    cfg.MODEL.ANCHOR_GENERATOR = CfgNode()
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    cfg.MODEL.ROI_HEADS = CfgNode()
    cfg.MODEL.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    cfg.MODEL.ROI_HEADS.FREEZE = False
    cfg.MODEL.ROI_HEADS.FREEZE_FEAT = False       # TFA-RCNN (tfa_rcnn.py:30)
    cfg.MODEL.ROI_HEADS.COSINE_SCALE = -1.0       # tfa_fast_rcnn.py:52-55
    cfg.MODEL.ROI_BOX_HEAD = CfgNode()
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    return cfg


def build_rcnn_model_from_cfg(cfg, device: Union[str, torch.device] = "cuda",
                              seed: int = None, init: str = "random"
                              ) -> FewShotRCNN:
    """``FewShotRCNN`` for ``cfg`` on ``device``, initialized from ``seed``
    (default ``max(cfg.SEED, 0)``) by ``init_random_weights``
    (``init="random"``) or the flax initializers' distributions
    (``init="train"``), in eval mode. Parameters are float32; the backbone,
    FPN and code generator run in ``TPU.COMPUTE_DTYPE``, the RPN head and
    the box head in float32."""
    dev = resolve_device(device)
    episodic = cfg.MODEL.META_LEARN.EPISODIC_LEARNING
    with torch.device("meta"):
        model = FewShotRCNN(
            depth=cfg.MODEL.RESNETS.DEPTH,
            backbone_out_features=tuple(cfg.MODEL.RESNETS.OUT_FEATURES),
            fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            fc_dim=cfg.MODEL.ROI_BOX_HEAD.FC_DIM,
            num_fc=cfg.MODEL.ROI_BOX_HEAD.NUM_FC,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            cosine_sim=cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT,
            cosine_scale=cfg.MODEL.ROI_HEADS.COSINE_SCALE,
            code_generator_name=("CodeGenerator" if episodic else "none"),
            code_generator_kwargs=_codegen_kwargs(cfg) if episodic else None,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            anchor_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            stop_backbone_grad=cfg.MODEL.BACKBONE.FREEZE,
            s2d_stem=cfg.TPU.S2D_STEM,
            compute_dtype=(torch.bfloat16
                           if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32))
    model = model.to_empty(device=dev)
    seed = max(cfg.SEED, 0) if seed is None else seed
    if init == "train":
        init_train_weights(model, seed)
    elif init == "random":
        init_random_weights(model, seed)
    else:
        raise ValueError(f"init {init!r}: 'random' or 'train'")
    return model.eval()


def _anchor_grid(cfg, canvas):
    return build_anchor_grid(
        tuple(canvas),
        sizes=tuple(s[0] for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES),
        aspect_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]))


def eval_anchor_grid(cfg):
    """The anchor grid of the eval canvas, built once per ``do_test``."""
    return _anchor_grid(cfg, cfg.TPU.EVAL_CANVAS)


def train_anchor_grid(cfg):
    """The anchor grid of the train canvas, built once per ``do_train``."""
    return _anchor_grid(cfg, cfg.TPU.TRAIN_CANVAS)


class MetaFasterRCNNRunner(MetaFCOSRunner):
    """Config, model, ``do_train`` and ``do_test`` for the two-stage
    detector. ``draws``: the sampling draw sources of training, a function
    (iteration, group, groups) -> source; by default
    ``SampleDraws.for_step`` seeded from ``max(cfg.SEED, 0)``, called with
    the global micro-group index. ``group``: as for ``MetaFCOSRunner``."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 draws: Optional[DrawsFactory] = None,
                 group: Optional[DataGroup] = None):
        super().__init__(device=device, group=group)
        self.draws = draws

    @classmethod
    def get_default_cfg(cls) -> CfgNode:
        cfg = super().get_default_cfg()
        add_rcnn_config(cfg)
        cfg.MODEL.META_ARCHITECTURE = "FewShotDetector"
        cfg.MODEL.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
        cfg.MODEL.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
        # the R-CNN code generator emits FC-dim (1024) codes
        cfg.MODEL.META_LEARN.CODE_GENERATOR.OUT_CHANNEL = 1024
        return cfg

    def build_model(self, cfg, init: str = "random") -> FewShotRCNN:
        """``build_rcnn_model_from_cfg`` on the runner's device from
        ``cfg.SEED``, then MODEL.WEIGHTS over it."""
        model = build_rcnn_model_from_cfg(cfg, device=self.device, init=init)
        return self._load_weights(cfg, model)

    def do_train(self, cfg, model: FewShotRCNN = None):
        """Train ``model`` (built from scratch when None) for
        SOLVER.MAX_ITER iterations, episodic or plain by the config,
        resuming from ``{OUTPUT_DIR}/ckpt``; returns ``(model, state)``."""
        if model is None:
            model = self.build_model(cfg, init="train")
        state, schedule, ckpt = self._common_train_setup(cfg, model)
        loader = (self._episodic_loader(cfg)
                  if cfg.MODEL.META_LEARN.EPISODIC_LEARNING
                  else self._pretrain_loader(cfg))
        return model, self._train_loop(cfg, state,
                                       self.make_train_step(cfg, model),
                                       loader, schedule, ckpt)

    def make_train_step(self, cfg, model: FewShotRCNN):
        """The two-stage step of the config's mode for ``model``, with the
        RPN top-k and the ROI batch of the config and the anchors of the
        train canvas: ``step(state, batch) -> (state, losses)``."""
        kw = dict(canvas=tuple(cfg.TPU.TRAIN_CANVAS),
                  rpn_pre_nms=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
                  rpn_post_nms=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
                  roi_batch=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
                  seed=max(cfg.SEED, 0), draws=self.draws,
                  steps_per_call=cfg.TPU.STEPS_PER_CALL,
                  grad_accum=max(1, cfg.TPU.GRAD_ACCUM), group=self.group)
        grid = train_anchor_grid(cfg)
        if not cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
            return make_rcnn_pretrain_train_step(model, grid, **kw)
        return make_rcnn_episodic_train_step(
            model, grid, num_shots=cfg.MODEL.META_LEARN.SHOT, **kw)

    def make_infer(self, cfg, model, bank, grid):
        """The episodic query path: ``make_rcnn_infer`` with the config's
        RPN and ROI settings."""
        from .evaluation.meta_eval import make_rcnn_infer
        return make_rcnn_infer(
            model, bank, grid,
            rpn_post_nms=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
            rpn_pre_nms=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            max_dets=cfg.TEST.DETECTIONS_PER_IMAGE, device=self.device)

    def _do_test_episodic(self, cfg, model) -> Dict[str, Dict]:
        """The two-phase meta-test of ``do_test`` with the two-stage query
        path on every ``DATASETS.TEST`` entry (REPEAT_TEST aggregated)."""
        from .evaluation.meta_eval import MetaTestDriver

        grid = eval_anchor_grid(cfg)
        results = {}
        for name in cfg.DATASETS.TEST:
            driver = MetaTestDriver(
                model, self._dataset(cfg, name), _mapper(cfg), None, None,
                eval_shot=cfg.MODEL.META_LEARN.EVAL_SHOT,
                evaluator_factory=lambda recs, meta, n=name:
                    self.get_evaluator(cfg, n, recs, meta),
                save_dir=(os.path.join(cfg.OUTPUT_DIR, "class_codes", name)
                          if cfg.OUTPUT_DIR else None),
                eval_batch=cfg.TPU.EVAL_BATCH,
                infer_factory=lambda m, bank: self.make_infer(cfg, m, bank,
                                                              grid),
                class_batch=cfg.TPU.CLASS_BATCH, device=self.device,
                mesh=self.group)
            self.drivers[name] = driver
            results[name] = driver.run_repeated(cfg.TEST.REPEAT_TEST)
        return results

    def make_plain_infer(self, cfg, model, grid):
        """The base classifier's inference: ``forward_base_instances``."""
        anchors = torch.as_tensor(grid.anchors, device=self.device)
        splits = tuple(grid.level_splits)

        @torch.inference_mode()
        def infer(images, sizes):
            return model.forward_base_instances(
                images, anchors, splits, sizes,
                cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
                cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                cfg.TEST.DETECTIONS_PER_IMAGE,
                rpn_pre_nms=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST)

        return infer

    def _do_test_plain(self, cfg, model) -> Dict[str, Dict]:
        """The plain evaluation of ``do_test``: the base classifier
        (pretraining, TFA-RCNN) through the shared eval loop over
        ``forward_base_instances``."""
        infer = self.make_plain_infer(cfg, model, eval_anchor_grid(cfg))
        results = {}
        for name in cfg.DATASETS.TEST:
            data = DatasetCatalog.get(name)
            if isinstance(data, dict) and "records" in data:
                records, meta = data["records"], data["metadata"]
            else:  # meta-format dict: evaluate on its query list
                records, meta = data[-1], data["metadata"]
            evaluator = self.get_evaluator(cfg, name, records, meta)
            results[name] = _plain_eval_loop(
                infer, records, _mapper(cfg),
                meta["thing_dataset_id_to_contiguous_id"], evaluator,
                batch_size=cfg.TPU.EVAL_BATCH, device=self.device)
        return results


def _base_classifier_rows(loaded):
    """The base detector's classifier as rows (C_base + 1, fc_dim) and a
    bias (or None), from a flax-layout tree: cosine rows, or the columns of
    the linear ``cls_score`` kernel; (None, None) when the checkpoint has no
    box-head classifier."""
    bh = loaded.get("box_head", {})
    if "cosine_weight" in bh:
        return torch.as_tensor(bh["cosine_weight"]), None
    if "kernel" in bh.get("cls_score", {}):
        return (torch.as_tensor(bh["cls_score"]["kernel"]).t(),
                torch.as_tensor(bh["cls_score"]["bias"]))
    return None, None


class TFAFasterRCNNRunner(MetaFasterRCNNRunner):
    """TFA two-stage baseline: a plain Faster R-CNN (reference
    meta_arch/tfa_rcnn.py:18-34) with the cosine ROI output layer
    (roi_heads/tfa_fast_rcnn.py:22-86) when MODEL.FCOS.L2_NORM_CLS_WEIGHT;
    base-class classifier rows are transplanted from the pretrained base
    detector (the TFA weight surgery)."""

    @classmethod
    def get_default_cfg(cls) -> CfgNode:
        cfg = super().get_default_cfg()
        cfg.MODEL.META_LEARN.EPISODIC_LEARNING = False
        cfg.MODEL.TFA.FINETINE = True
        return cfg

    def build_model(self, cfg, init: str = "random") -> FewShotRCNN:
        model = super().build_model(cfg, init=init)
        if (cfg.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS
                and cfg.MODEL.WEIGHTS
                and cfg.DATASETS.BASE_CLASSES_SPLIT
                and cfg.DATASETS.TRAIN):
            state = {k: v for k, v in model.state_dict().items()
                     if k.startswith("box_head.")}
            out = self._preload_roi_cls_rows(cfg, state)
            if out is not state:
                model.load_state_dict(out, strict=False)
        return model

    def _preload_roi_cls_rows(self, cfg, state: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
        """TFA surgery for the two-stage head: copy the base detector's
        classifier rows (and its background row) from MODEL.WEIGHTS (a
        flat ``.npz`` or a detectron2 ``.pth``/``.pkl``) into
        the all-classes head of ``state`` (``box_head.cosine_weight``, or
        ``box_head.cls_score.weight``/``bias``) at the positions the
        current dataset gives those classes. Linear -> cosine is exact up
        to the per-row normalization the cosine layer applies anyway.
        Returns a new dict, or ``state`` itself with a warning when the
        surgery cannot be made."""
        log = logging.getLogger(__name__)
        path = cfg.MODEL.WEIGHTS
        if path.endswith((".pth", ".pkl")):
            loaded = convert_detectron2_checkpoint(load_torch_state_dict(path))
        else:
            try:
                loaded = load_params_any(path)
            except Exception as e:  # noqa: BLE001 — surfaced below
                log.warning(
                    "[TFA-RCNN] cls surgery REQUESTED but MODEL.WEIGHTS=%r "
                    "could not be read (%s) — surgery SKIPPED, base rows stay "
                    "at their init", path, e)
                return state
        base_rows, base_bias = _base_classifier_rows(loaded)
        if base_rows is None:
            log.warning(
                "[TFA-RCNN] cls surgery REQUESTED but checkpoint %r has no "
                "box_head classifier — surgery SKIPPED", path)
            return state

        base_ids = MetadataCatalog.get(cfg.DATASETS.BASE_CLASSES_SPLIT).get(
            "thing_dataset_id_to_contiguous_id")
        if base_ids is None:  # lazily registered: load the dataset
            base_ids = DatasetCatalog.get(cfg.DATASETS.BASE_CLASSES_SPLIT)[
                "metadata"]["thing_dataset_id_to_contiguous_id"]
        cur_ids = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])["metadata"][
            "thing_dataset_id_to_contiguous_id"]
        moves = [(bi, cur_ids[did]) for did, bi in base_ids.items()
                 if did in cur_ids] + [(-1, -1)]   # + the background row

        out = dict(state)
        cosine = "box_head.cosine_weight" in state
        rows_key = ("box_head.cosine_weight" if cosine
                    else "box_head.cls_score.weight")
        rows = state[rows_key].clone()
        bias = None if cosine else state["box_head.cls_score.bias"].clone()
        for bi, ci in moves:
            rows[ci] = base_rows[bi].to(rows)
            if bias is not None and base_bias is not None:
                bias[ci] = base_bias[bi]
        out[rows_key] = rows
        if bias is not None:
            out["box_head.cls_score.bias"] = bias
        print(f"[TFA-RCNN] preloaded {len(moves) - 1} base classifier rows "
              f"+ background")
        return out
