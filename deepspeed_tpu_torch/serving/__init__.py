"""Continuous-batching serving (counterpart of ``deepspeed_tpu/serving/``):
a slot-based persistent KV cache (``slots.py``) or the paged KV pool with
radix prefix sharing (``pages.py``), a host-side scheduler with chunked
prefill (``scheduler.py``), the slot decode step captured once as a CUDA
graph (``graph.py``), and the ``submit()/step()/drain()`` engine
(``engine.py``).
"""

from ..resilience.guards import (PagePoolExhausted, QueueFullError,
                                 RequestStatus)
from .engine import ServingEngine
from .graph import SlotGraph
from .pages import (PageAllocation, PagePool, RadixPrefixTree, hydrate_cache,
                    init_paged_slots, insert_paged)
from .scheduler import ChunkPlan, Request, Scheduler, plan_chunks
from .slots import init_slots, insert_request

__all__ = ["ServingEngine", "Scheduler", "Request", "ChunkPlan",
           "plan_chunks", "init_slots", "insert_request", "SlotGraph",
           "PagePool", "RadixPrefixTree", "PageAllocation",
           "init_paged_slots", "insert_paged", "hydrate_cache",
           "RequestStatus", "QueueFullError", "PagePoolExhausted"]
