"""Model construction and the meta-test runner (port of
sylph_tpu/runner/meta_fcos_runner.py without its training half):
``build_model_from_cfg``, ``_codegen_kwargs``, ``_decode_cfg``, ``_mapper``,
``MetaFCOSRunner`` (``get_default_cfg``, ``build_model``, ``get_evaluator``,
``do_test``) and ``create_runner``.

The repo ships no checkpoint, so ``build_model_from_cfg`` initializes the
weights from an explicit ``torch.Generator`` seed, detectron2-style
(fan-in scaled convs, random frozen-BN statistics) so that activations stay
O(1) through the full-depth network. Pretrained weights come in through
``load_state_dict`` (the port's own) or ``utils.convert_weights``
(the JAX package's).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Union

import numpy as np
import torch
import torch.nn as nn

from .config import CfgNode, get_default_cfg
from .data.catalog import DatasetCatalog
from .data.loader import _POOL
from .data.mapper import EpisodicMapper
from .evaluation.evaluators import (AREvaluator, COCOMetaEvaluator,
                                    COCOOWDEvaluator, FewshotLVISEvaluator)
from .evaluation.postprocess import detections_to_coco_results
from .models.layers import Conv2d, GroupNorm, Scale
from .models.meta_arch import MetaOneStageDetector
from .models.resnet import FrozenBatchNorm
from .ops.decode import DecodeCfg, decode_proposals
from .ops.locations import build_location_grid
from .utils.tb_writer import write_eval_results_tb

BN_EPS = 1e-5


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is
    none raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def _codegen_kwargs(cfg) -> Dict:
    cg = cfg.MODEL.META_LEARN.CODE_GENERATOR
    if cg.NAME == "ROIEncoder":
        raise NotImplementedError("the ROIEncoder is not ported yet")
    return dict(
        pooler_resolution=cg.ROI_BOX.POOLER_RESOLUTION,
        out_channel=cg.OUT_CHANNEL,
        tower_layers=tuple(tuple(t) for t in cg.TOWER_LAYERS),
        cls_layer=tuple(cg.CLS_LAYER), bias_layer=tuple(cg.BIAS_LAYER),
        weight_layer=tuple(cg.WEIGHT_LAYER),
        scale_layer=tuple(cg.SCALE_LAYER), conv_l2_norm=cg.CONV_L2_NORM,
        bias_l2_norm=cg.BIAS_L2_NORM,
        post_norm=cg.POST_NORM, use_weight_scale=cg.USE_WEIGHT_SCALE,
        compress_code_w_max=cg.COMPRESS_CODE_W_MAX,
        meta_bias=cg.META_BIAS, contrastive_loss=cg.CONTRASTIVE_LOSS)


def _decode_cfg(cfg, train: bool = False) -> DecodeCfg:
    f = cfg.MODEL.FCOS
    return DecodeCfg(
        pre_nms_thresh=(f.INFERENCE_TH_TRAIN if train else
                        f.INFERENCE_TH_TEST),
        pre_nms_topk=(f.PRE_NMS_TOPK_TRAIN if train else
                      f.PRE_NMS_TOPK_TEST),
        post_nms_topk=(f.POST_NMS_TOPK_TRAIN if train else
                       f.POST_NMS_TOPK_TEST),
        nms_thresh=f.NMS_TH, thresh_with_ctr=f.THRESH_WITH_CTR,
        box_quality=tuple(sorted(f.BOX_QUALITY)),
        owd=cfg.MODEL.PROPOSAL_GENERATOR.OWD)


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer from a CPU ``torch.Generator``.

    The draws happen on the CPU and are copied to the model's device, so a
    model built on ``cuda`` and one built on ``cpu`` from the same seed hold
    the same weights.
    """
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    for module in model.modules():
        if isinstance(module, Conv2d):
            fan_in = module.weight[0].numel()
            module.weight.copy_(randn(*module.weight.shape)
                                / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.copy_(0.1 * randn(*module.bias.shape))
        elif isinstance(module, FrozenBatchNorm):
            c = module.scale.numel()
            gamma = 1.0 + 0.1 * randn(c)
            beta = 0.1 * randn(c)
            mean = 0.1 * randn(c)
            var = 0.8 + 0.4 * torch.rand((c,), generator=gen)
            scale = gamma / torch.sqrt(var + BN_EPS)
            module.scale.copy_(scale)
            module.bias.copy_(beta - mean * scale)
        elif isinstance(module, GroupNorm):
            module.weight.copy_(1.0 + 0.1 * randn(module.num_channels))
            module.bias.copy_(0.1 * randn(module.num_channels))
        elif isinstance(module, Scale):
            module.scale.copy_(module.init_value * (1.0 + 0.1 * randn()))
    cg = getattr(model, "code_generator", None)
    if cg is not None and cg.meta_bias:
        cg.meta_bias_value.fill_(cg.prior)
    return model


def build_model_from_cfg(cfg, device: Union[str, torch.device] = "cuda",
                         seed: int = None) -> MetaOneStageDetector:
    """MetaOneStageDetector for ``cfg`` on ``device``, randomly initialized
    from ``seed`` (default ``max(cfg.SEED, 0)``), in eval mode.

    Parameters are float32; activations run in ``TPU.COMPUTE_DTYPE``, with
    GroupNorm and logits in float32.
    """
    dev = resolve_device(device)
    episodic = cfg.MODEL.META_LEARN.EPISODIC_LEARNING
    with torch.device("meta"):
        model = MetaOneStageDetector(
            depth=cfg.MODEL.RESNETS.DEPTH,
            backbone_out_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
            fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            fpn_top_levels=cfg.MODEL.FPN.TOP_LEVELS,
            num_classes=cfg.MODEL.FCOS.NUM_CLASSES,
            num_cls_convs=cfg.MODEL.FCOS.NUM_CLS_CONVS,
            num_box_convs=cfg.MODEL.FCOS.NUM_BOX_CONVS,
            num_share_convs=cfg.MODEL.FCOS.NUM_SHARE_CONVS,
            fcos_norm=cfg.MODEL.FCOS.NORM,
            use_scale=cfg.MODEL.FCOS.USE_SCALE,
            prior_prob=cfg.MODEL.FCOS.PRIOR_PROB,
            cls_kernel_size=cfg.MODEL.FCOS.CLS_LOGITS_KERNEL_SIZE,
            l2_norm_cls_weight=cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT,
            use_deformable=cfg.MODEL.FCOS.USE_DEFORMABLE,
            fpn_strides=tuple(cfg.MODEL.FCOS.FPN_STRIDES),
            code_generator_name=(cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME
                                 if episodic else "none"),
            code_generator_kwargs=_codegen_kwargs(cfg) if episodic else None,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            s2d_stem=cfg.TPU.S2D_STEM,
            compute_dtype=(torch.bfloat16
                           if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32))
    model = model.to_empty(device=dev)
    init_random_weights(model, max(cfg.SEED, 0) if seed is None else seed)
    return model.eval()


def _mapper(cfg) -> EpisodicMapper:
    return EpisodicMapper(
        eval_canvas=tuple(cfg.TPU.EVAL_CANVAS),
        support_canvas=tuple(cfg.TPU.SUPPORT_CANVAS),
        max_gt_boxes=cfg.TPU.MAX_GT_BOXES,
        min_size_test=cfg.INPUT.MIN_SIZE_TEST,
        max_size_test=cfg.INPUT.MAX_SIZE_TEST, fmt=cfg.INPUT.FORMAT)


def _eval_grid(cfg):
    return build_location_grid(
        tuple(cfg.TPU.EVAL_CANVAS), tuple(cfg.MODEL.FCOS.FPN_STRIDES),
        list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))


class MetaFCOSRunner:
    """The meta-test half of the JAX ``MetaFCOSRunner``: config, model,
    evaluator dispatch and ``do_test`` on ``device`` (default ``"cuda"``,
    which raises without a card). Training belongs to a later slice."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.drivers: Dict[str, object] = {}

    @classmethod
    def get_default_cfg(cls) -> CfgNode:
        return get_default_cfg()

    def build_model(self, cfg) -> MetaOneStageDetector:
        """``build_model_from_cfg`` on the runner's device (random weights
        from ``cfg.SEED``; ``MODEL.WEIGHTS`` loading is not ported yet)."""
        if cfg.MODEL.WEIGHTS:
            raise NotImplementedError("loading MODEL.WEIGHTS is not ported "
                                      "yet; load a state_dict instead")
        return build_model_from_cfg(cfg, device=self.device)

    def get_evaluator(self, cfg, dataset_name: str, query_records, metadata):
        """Evaluator dispatch on the dataset's evaluator_type (reference
        meta_fcos_runner.py:116-149): OWD first, then lvis/tao ->
        FewshotLVISEvaluator, coco_meta_learn -> COCOMetaEvaluator,
        anything else -> the AP + AR table."""
        etype = metadata.get("evaluator_type") or (
            "lvis_meta_learn" if dataset_name.startswith("lvis")
            else "coco_meta_learn" if "_meta_" in dataset_name
            else "coco")
        novel = None
        if metadata.get("split") == "all":
            novel = metadata.get("novel_dataset_ids")
        if cfg.MODEL.PROPOSAL_GENERATOR.OWD:
            return COCOOWDEvaluator(query_records, metadata)
        if etype in ("lvis", "lvis_meta_learn", "tao_meta_learn"):
            return FewshotLVISEvaluator(
                query_records, metadata,
                categories=metadata.get("categories"),
                max_dets=cfg.TEST.DETECTIONS_PER_IMAGE)
        if etype == "coco_meta_learn":
            return COCOMetaEvaluator(query_records, metadata,
                                     novel_dataset_ids=novel)
        return AREvaluator(query_records, metadata,
                           novel_dataset_ids=novel)

    def _do_test_plain(self, cfg, model) -> Dict[str, Dict]:
        """Non-episodic evaluation (pretrain / TFA finetune path)."""
        infer = _make_plain_fcos_infer(model, _eval_grid(cfg),
                                       _decode_cfg(cfg), self.device)
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

    def do_test(self, cfg, model, step: int = 0) -> Dict[str, Dict]:
        """The two-phase meta-test on every ``DATASETS.TEST`` entry, with
        REPEAT_TEST aggregation (reference :451-672); the plain base
        detector evaluation when the config is not episodic. Scalars go to
        ``{OUTPUT_DIR}/tb`` and raw codes to
        ``{OUTPUT_DIR}/class_codes/{dataset}/`` when OUTPUT_DIR is set.
        The drivers stay in ``self.drivers`` (bank and phase times)."""
        from .evaluation.meta_eval import MetaTestDriver

        if not cfg.MODEL.META_LEARN.EPISODIC_LEARNING:
            results = self._do_test_plain(cfg, model)
            write_eval_results_tb(results, cfg.OUTPUT_DIR, step)
            return results
        results = {}
        grid = _eval_grid(cfg)
        for name in cfg.DATASETS.TEST:
            dataset_dict = DatasetCatalog.get(name)
            # all-GT base-class codes only make sense on splits that
            # contain base classes (reference meta_fcos_runner.py:520-532)
            split = dataset_dict["metadata"].get("split", "")
            use_base = (cfg.MODEL.META_LEARN.USE_ALL_GTS_IN_BASE_CLASSES
                        and split in ("all", "base"))
            driver = MetaTestDriver(
                model, dataset_dict, _mapper(cfg), grid, _decode_cfg(cfg),
                eval_shot=cfg.MODEL.META_LEARN.EVAL_SHOT,
                evaluator_factory=lambda recs, meta, n=name:
                    self.get_evaluator(cfg, n, recs, meta),
                save_dir=(os.path.join(cfg.OUTPUT_DIR, "class_codes", name)
                          if cfg.OUTPUT_DIR else None),
                use_all_gts_in_base=use_base,
                base_max_records=cfg.MODEL.META_LEARN.BASE_EVAL_SHOT * 10,
                eval_batch=cfg.TPU.EVAL_BATCH,
                class_batch=cfg.TPU.CLASS_BATCH, device=self.device)
            self.drivers[name] = driver
            results[name] = driver.run_repeated(cfg.TEST.REPEAT_TEST)
        write_eval_results_tb(results, cfg.OUTPUT_DIR, step)
        return results


def _make_plain_fcos_infer(model, grid, dcfg: DecodeCfg,
                           device: torch.device):
    """Base-detector inference (trained cls_logits, no bank)."""
    locations = torch.as_tensor(grid.locations, device=device)
    strides = torch.as_tensor(grid.strides, device=device)
    splits = tuple(h * w for h, w in grid.level_sizes)

    @torch.inference_mode()
    def infer(images, sizes):
        out = model.forward_base(images)
        return decode_proposals(out.logits, out.reg, out.ctrness, out.iou,
                                locations, strides, sizes, dcfg, splits)

    return infer


def _plain_eval_loop(infer, records, mapper, id_map, evaluator,
                     batch_size: int, device: torch.device):
    """Base-detector evaluation: each batch of records is mapped on the
    thread pool just before its model call; the tail batch repeats its
    last image and is masked out."""
    contiguous_to_dataset = {v: k for k, v in id_map.items()}
    for i in range(0, len(records), batch_size):
        chunk = list(_POOL.map(mapper.map_query_eval,
                               records[i:i + batch_size]))
        n = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
        sizes = np.stack([m["image_size"] for m in chunk])
        det = infer(torch.as_tensor(np.stack([m["image"] for m in chunk]),
                                    device=device),
                    torch.as_tensor(sizes, device=device)).numpy()
        evaluator.process(detections_to_coco_results(
            det, [m["image_id"] for m in chunk], sizes,
            np.stack([np.asarray([m["orig_height"], m["orig_width"]])
                      for m in chunk]),
            contiguous_to_dataset,
            batch_valid=np.arange(batch_size) < n))
    return evaluator.evaluate()


def create_runner(name: str, device: Union[str, torch.device] = "cuda"
                  ) -> MetaFCOSRunner:
    """``MetaFCOSRunner`` by name (reference-style dotted names accepted);
    the other runners of the JAX package are not ported yet and raise."""
    key = name.split(".")[-1]
    if key != "MetaFCOSRunner":
        raise NotImplementedError(f"runner {name} is not ported yet")
    return MetaFCOSRunner(device=device)
