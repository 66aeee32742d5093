"""Profiling/observability helpers.

Copy of bellman_mpc_tpu/utils/profiling.py on torch.profiler.  The
reference's observability is `log` trace/error in multicore.rs plus manual
Instant timing in the MiMC bench (SURVEY.md §5).  The port exposes:

  * `trace(dir)`  — context manager around torch.profiler (CPU activity,
    and CUDA activity where a card is present), written as a Chrome trace
    (viewable in Perfetto or chrome://tracing),
  * `timed(name)` — wall-clock block timing with device synchronization,
  * module-level `logger` — structured logging (BMT_LOG=debug for verbose).
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger("bellman_mpc_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_h)
logger.setLevel(
    logging.DEBUG if os.environ.get("BMT_LOG") == "debug" else logging.WARNING
)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler and write its Chrome trace,
    `trace_<pid>_<ns>.json`, into `log_dir` (default: bmt_trace under the
    temporary directory).  Yields the profiler, whose `key_averages()`
    sums the block's operators and kernels."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "bmt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def timed(name: str, sync: bool = True) -> Iterator[None]:
    """Wall-clock timing with optional device barrier (Instant-style): with
    `sync`, queued CUDA work is waited for before the clock is read."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        logger.info("%s: %.4fs", name, time.perf_counter() - t0)
