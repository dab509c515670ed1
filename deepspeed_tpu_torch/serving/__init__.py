"""Continuous-batching serving over contiguous KV slots (counterpart of
``deepspeed_tpu/serving/``): a slot-based persistent KV cache
(``slots.py``), a host-side scheduler with chunked prefill
(``scheduler.py``), the slot decode step captured once as a CUDA graph
(``graph.py``), and the ``submit()/step()/drain()`` engine (``engine.py``).
"""

from ..resilience.guards import QueueFullError, RequestStatus
from .engine import ServingEngine
from .graph import SlotGraph
from .scheduler import ChunkPlan, Request, Scheduler, plan_chunks
from .slots import init_slots, insert_request

__all__ = ["ServingEngine", "Scheduler", "Request", "ChunkPlan",
           "plan_chunks", "init_slots", "insert_request", "SlotGraph",
           "RequestStatus", "QueueFullError"]
