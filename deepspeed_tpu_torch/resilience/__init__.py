from .guards import QueueFullError, RequestStatus

__all__ = ["QueueFullError", "RequestStatus"]
