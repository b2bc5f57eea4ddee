"""Framework logger (the port's copy of ``multimodal_tta_tpu/utils/logger.py``):
a named logger with console + optional file handler and the
``[time] name - LEVEL [file:line]`` record format."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_DEFAULT_NAME = "multimodal_tta_tpu_torch"
_FMT = "[%(asctime)s] %(name)s - %(levelname)s [%(filename)s:%(lineno)d] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def setup_logger(log_file: Optional[str] = None, name: str = _DEFAULT_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False

    # Reset handlers so repeated setup (tests, several CLI runs in one
    # process) doesn't duplicate output or keep an earlier run's file open.
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()

    formatter = logging.Formatter(_FMT, datefmt=_DATEFMT)

    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    return logger


def get_logger(name: str = _DEFAULT_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        setup_logger(name=name)
    return logger
