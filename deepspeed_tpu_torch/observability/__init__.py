from .metrics import MetricsRegistry
from .tracing import ServingStats

__all__ = ["MetricsRegistry", "ServingStats"]
