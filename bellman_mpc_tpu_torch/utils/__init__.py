from .gt_bytes import gt_format, gt_parse

__all__ = ["gt_format", "gt_parse"]
