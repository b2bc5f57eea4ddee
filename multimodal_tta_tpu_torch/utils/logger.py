"""Framework logger (the port's copy of ``multimodal_tta_tpu/utils/logger.py``,
console only): a named logger with the ``[time] name - LEVEL [file:line]``
record format."""

from __future__ import annotations

import logging
import sys

_DEFAULT_NAME = "multimodal_tta_tpu_torch"
_FMT = "[%(asctime)s] %(name)s - %(levelname)s [%(filename)s:%(lineno)d] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def get_logger(name: str = _DEFAULT_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        logger.propagate = False
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(handler)
    return logger
