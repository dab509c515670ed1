"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

The rank is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    level = getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(),
                    logging.INFO)
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: list[int] | None = None,
             level: int | str = logging.INFO) -> None:
    """Log ``message`` only on the listed ranks (``[-1]`` or None = all)."""
    rank = _rank()
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    if ranks is None or -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")


def warning_once(message: str, _seen: set = set()) -> None:  # noqa: B006 - intentional cache
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
