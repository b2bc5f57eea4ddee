"""Config access, logging and metric helpers of the port."""

from .config import get_config, require_config
from .logger import LoggerWriter, get_logger, setup_logger
from .metrics import AverageMeter, set_random_seed

__all__ = ["get_config", "require_config", "get_logger", "setup_logger", "LoggerWriter", "AverageMeter",
           "set_random_seed"]
