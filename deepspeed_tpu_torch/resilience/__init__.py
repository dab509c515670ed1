from . import chaos
from .guards import (CheckpointIntegrityError, NonFiniteLossError,
                     PagePoolExhausted, QueueFullError, RequestStatus)
from .integrity import (list_tags, newest_verified_tag, prune_tags,
                        verify_tag, write_manifest)
from .preempt import PreemptionGuard

__all__ = ["CheckpointIntegrityError", "NonFiniteLossError",
           "PagePoolExhausted", "PreemptionGuard", "QueueFullError",
           "RequestStatus", "chaos", "list_tags", "newest_verified_tag",
           "prune_tags", "verify_tag", "write_manifest"]
