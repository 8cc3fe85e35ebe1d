"""Evaluation: the numpy COCO protocol with its native matcher, the Sylph
evaluators and the two-phase meta-test drivers (port of
sylph_tpu/evaluation/)."""

from .coco_eval_np import COCOEval, DetEvalInputs
from .evaluators import (AREvaluator, COCOMetaEvaluator, COCOOWDEvaluator,
                         FewshotLVISEvaluator)
from .postprocess import detections_to_coco_results

__all__ = ["COCOEval", "DetEvalInputs", "COCOMetaEvaluator", "AREvaluator",
           "COCOOWDEvaluator", "FewshotLVISEvaluator",
           "detections_to_coco_results"]
