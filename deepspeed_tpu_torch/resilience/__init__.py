from .guards import PagePoolExhausted, QueueFullError, RequestStatus

__all__ = ["PagePoolExhausted", "QueueFullError", "RequestStatus"]
