"""Host-side data layer: catalogs, episodic datasets, mapper, loaders,
transforms and the synthetic COCO/LVIS trees (the port's own copies)."""

from .catalog import DatasetCatalog, MetadataCatalog, register_all_coco, \
    register_all_lvis
from .loader import (build_episodic_train_loader, build_pretrain_loader,
                     build_query_loader, build_support_set_base_loader,
                     build_support_set_loader)
from .mapper import EpisodicMapper
from .meta_dataset import MetaDataset
from .transforms import pad_to_canvas, resize_shortest_edge

__all__ = ["DatasetCatalog", "MetadataCatalog", "register_all_coco",
           "register_all_lvis", "build_episodic_train_loader",
           "build_pretrain_loader", "build_query_loader",
           "build_support_set_base_loader", "build_support_set_loader",
           "EpisodicMapper", "MetaDataset", "pad_to_canvas",
           "resize_shortest_edge"]
