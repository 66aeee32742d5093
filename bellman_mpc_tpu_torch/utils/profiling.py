"""Profiling/observability helpers.

Copy of bellman_mpc_tpu/utils/profiling.py on torch.profiler.  The
reference's observability is `log` trace/error in multicore.rs plus manual
Instant timing in the MiMC bench (SURVEY.md §5).  The port exposes:

  * `trace(dir)`  — context manager around torch.profiler (CPU activity,
    and CUDA activity where a card is present), written as a Chrome trace
    (viewable in Perfetto or chrome://tracing),
  * `timed(name)` — wall-clock block timing with device synchronization,
  * module-level `logger` — structured logging (BMT_LOG=debug for verbose),
  * a registry of named spans and counters that stays on: `span(name)`
    times a block by the host clock, `device_span(name, device)` by two
    CUDA events on the current stream (no synchronization; the events are
    read only by `read()`), `count(name)` adds to a counter; `read()` gives
    every span's (seconds, units) records and the counters, `reset()`
    clears them.  A device span's seconds are the stream's between its
    events, so they include any wait for the host to queue the block's
    work.  Each record notes whether torch.profiler was recording, and
    `read(traced=True)` keeps only those records.  A process keeps one
    registry; each span keeps its last `SPAN_RECORDS` records.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Tuple

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


# ------------------------------------------------------------------ registry
SPAN_RECORDS = 4096

_spans: Dict[str, collections.deque] = {}
_counters: Dict[str, int] = collections.Counter()


def _record(name: str, value, units: int) -> None:
    q = _spans.get(name)
    if q is None:
        q = _spans[name] = collections.deque(maxlen=SPAN_RECORDS)
    q.append((value, units, torch.autograd._profiler_enabled()))


@contextlib.contextmanager
def span(name: str, units: int = 1) -> Iterator[None]:
    """Time the block by the host clock: one record of (seconds, units)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0, units)


@contextlib.contextmanager
def device_span(name: str, device, units: int = 1) -> Iterator[None]:
    """Time the block's device work: on a CUDA device two timing events on
    the current stream, resolved only by `read()`; elsewhere (where the
    work is done when the block ends) the host clock."""
    if torch.device(device).type != "cuda":
        with span(name, units):
            yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        yield
    finally:
        end.record()
        _record(name, (start, end), units)


def count(name: str, n: int = 1) -> None:
    _counters[name] += n


def read(traced: bool = False) -> Dict[str, Dict]:
    """{"spans": {name: [(seconds, units), ...]}, "counters": {name: n}};
    with `traced`, only the span records made while torch.profiler was
    recording.  Reading a device span waits for its end event."""
    spans: Dict[str, List[Tuple[float, int]]] = {}
    for name, q in _spans.items():
        out = []
        for value, units, under_profiler in q:
            if traced and not under_profiler:
                continue
            if isinstance(value, tuple):
                start, end = value
                end.synchronize()
                value = start.elapsed_time(end) / 1e3
            out.append((value, units))
        spans[name] = out
    return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    _spans.clear()
    _counters.clear()
