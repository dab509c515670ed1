from .comm import (all_gather, all_reduce, barrier, broadcast, get_rank,
                   get_world_size, reduce_scatter)

__all__ = ["all_gather", "all_reduce", "barrier", "broadcast", "get_rank",
           "get_world_size", "reduce_scatter"]
