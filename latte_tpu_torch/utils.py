"""Logging for the port's entry points (counterpart of ``latte_tpu/utils.py``)."""

from __future__ import annotations

import logging


def create_logger() -> logging.Logger:
    """Logger to stdout."""
    logger = logging.getLogger("latte_tpu_torch")
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(sh)
    return logger
