from .partitioning import ZeroPartitioner, add_axis_to_spec
from .shards import Cut, GatherSet, LeafPlan

__all__ = ["Cut", "GatherSet", "LeafPlan", "ZeroPartitioner",
           "add_axis_to_spec"]
