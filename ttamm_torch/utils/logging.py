"""Logging setup honoring the config ``logging.level`` key.

The reference declares ``logging.level`` in ``configs/default.yaml:114-115``
but never consumes it; this framework actually applies it (SURVEY.md §5).
Uses the stdlib ``logging`` module (no loguru dependency) with a compact
structured format.
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "ttamm_torch"


def get_logger(name: str | None = None) -> logging.Logger:
    full = _LOGGER_NAME if not name else f"{_LOGGER_NAME}.{name}"
    return logging.getLogger(full)


def configure_logging(level: str = "INFO") -> None:
    """Configure the framework logger once; safe to call repeatedly."""
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s | %(levelname)-7s | %(name)s | %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
    logger.propagate = False
