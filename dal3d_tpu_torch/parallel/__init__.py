"""Data parallelism over ``torch.distributed`` ranks (port of
``dal3d_tpu/parallel``)."""
from .dist import all_gather_objects, get_dist_info, init_dist, master_only, synchronize
from .mesh import data_parallel_predict, shard_batch, sharded_eval_predict

__all__ = [
    "shard_batch",
    "data_parallel_predict",
    "sharded_eval_predict",
    "get_dist_info",
    "master_only",
    "all_gather_objects",
    "synchronize",
    "init_dist",
]
