from .decode import DecodeCfg, decode_proposals, select_candidates
from .locations import LocationGrid, build_location_grid
from .nms import (batched_multiclass_nms, class_offset_boxes,
                  nms_select_reference)
from .roi_align import multilevel_roi_align, roi_align

__all__ = ["DecodeCfg", "decode_proposals", "select_candidates",
           "LocationGrid", "build_location_grid", "batched_multiclass_nms",
           "class_offset_boxes", "nms_select_reference",
           "multilevel_roi_align", "roi_align"]
