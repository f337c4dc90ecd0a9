"""Copy of qwen3_tts_tpu/utils/logging.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

Structured logging: a named logger plus JSON generation events at DEBUG
level.  The JAX package's environment switches for level and JSON output
are not carried over; configure the `qwen3_tts_tpu_torch` logger instead.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("qwen3_tts_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            logger.addHandler(handler)
        if logger.level == logging.NOTSET:
            logger.setLevel(logging.WARNING)
        _LOGGER = logger
    return _LOGGER


def log_event(event: str, **fields: Any) -> None:
    """Log a JSON metrics event (RTF, steps, EOS cause, ...) at DEBUG."""
    record: Dict[str, Any] = {"event": event, "ts": time.time(), **fields}
    get_logger().debug(json.dumps(record, default=str))
