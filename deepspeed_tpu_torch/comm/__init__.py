from .comm import (all_gather, all_reduce, all_to_all, barrier, broadcast,
                   get_rank, get_world_size, reduce_scatter)
from .compressed import int8_psum

__all__ = ["all_gather", "all_reduce", "all_to_all", "barrier", "broadcast",
           "get_rank", "get_world_size", "int8_psum", "reduce_scatter"]
