"""Process-level logging with a host prefix.

Counterpart of ``better_search_rag_rust_tpu/utils/logging.py``. The port runs
one process on one card, so the host index is always 0; the prefix is kept so
log lines from the two packages read the same.
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "bsr_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def host_log(msg: str) -> None:
    """Log with the reference's ``[Host h]`` prefix."""
    get_logger().info("[Host 0] %s", msg)
