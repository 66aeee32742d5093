from .gt_bytes import gt_format, gt_parse
from .profiling import logger, timed, trace

__all__ = ["gt_format", "gt_parse", "logger", "timed", "trace"]
