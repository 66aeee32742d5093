from .gt_bytes import gt_format, gt_parse
from .profiling import count, device_span, logger, span, timed, trace

__all__ = ["count", "device_span", "gt_format", "gt_parse", "logger", "span", "timed", "trace"]
