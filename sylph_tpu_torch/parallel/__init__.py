from .mesh import (DataGroup, all_reduce_mean_, create_mesh,
                   cross_rank_mean, gather_class_codes, shard_batch)

__all__ = ["DataGroup", "all_reduce_mean_", "create_mesh", "cross_rank_mean",
           "gather_class_codes", "shard_batch"]
