"""Worker/Waiter — host-side task-pool facade (multicore.rs parity).

Copy of bellman_mpc_tpu/parallel/worker.py.  The reference's `Worker`
(bellman/src/multicore.rs:21-92) chunks data across rayon threads and
spawns async jobs returning `Waiter` futures (:94-118), with spawn-count
backpressure (:14-18, 47-73) and a serial fallback (:145-213).  The
device compute needs none of this (PyTorch queues CUDA work
asynchronously on its stream), so this shim exists for the HOST side only
— parallel serialization, witness synthesis fan-out — and for API parity:

    worker = Worker()
    with worker.scope(len(items)) as (scope, chunk): ...
    waiter = worker.compute(fn); waiter.wait()

`BMT_NUM_THREADS` mirrors the reference's RAYON_NUM_THREADS env control
(CHANGELOG.md:24-27).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, List, Optional, TypeVar

T = TypeVar("T")


def log2_floor(num: int) -> int:
    """multicore.rs:120-130."""
    assert num > 0
    pow2 = 0
    while (1 << (pow2 + 1)) <= num:
        pow2 += 1
    return pow2


class Waiter:
    """A joinable async result (multicore.rs:94-118)."""

    def __init__(self, future: Future, pool_threads: Optional[set] = None):
        self._future = future
        self._pool_threads = pool_threads

    def wait(self):
        # Deadlock guard (multicore.rs:100-108): joining a Waiter FROM a
        # pool worker thread can deadlock the pool (the waited job may be
        # queued behind the waiter).  The reference logs an error and
        # panics; raising is the Python equivalent.
        if (
            self._pool_threads is not None
            and threading.get_ident() in self._pool_threads
            and not self._future.done()
        ):
            raise RuntimeError(
                "Waiter.wait() called from within a worker thread "
                "(multicore.rs:100-108 misuse guard): this can deadlock "
                "the pool; restructure to join from the spawning thread"
            )
        return self._future.result()

    def done(self) -> bool:
        return self._future.done()


class Worker:
    def __init__(self, num_threads: Optional[int] = None):
        self.num_threads = num_threads or int(
            os.environ.get("BMT_NUM_THREADS", os.cpu_count() or 1)
        )
        # Backpressure: at most 4x thread count in-flight (multicore.rs:18).
        self._pool_threads: set = set()
        self._pool = ThreadPoolExecutor(
            max_workers=self.num_threads,
            initializer=lambda: self._pool_threads.add(threading.get_ident()),
        )
        self._sema = threading.Semaphore(4 * self.num_threads)

    def log_num_threads(self) -> int:
        return log2_floor(self.num_threads)

    def compute(self, fn: Callable[[], T]) -> Waiter:
        """Spawn an async job (multicore.rs:33-76); blocks when saturated."""
        self._sema.acquire()

        def run():
            try:
                return fn()
            finally:
                self._sema.release()

        return Waiter(self._pool.submit(run), self._pool_threads)

    @contextmanager
    def scope(self, elements: int):
        """Chunked data-parallel scope (multicore.rs:78-91).

        Yields (scope, chunk_size); scope.spawn(fn) runs fn asynchronously,
        all joined at scope exit.
        """
        chunk = max(1, elements // self.num_threads) if elements else 1

        class _Scope:
            def __init__(self, pool):
                self._pool = pool
                self.futures: List[Future] = []

            def spawn(self, fn: Callable[[], object]) -> None:
                self.futures.append(self._pool.submit(fn))

        s = _Scope(self._pool)
        try:
            yield s, chunk
        finally:
            for f in s.futures:
                f.result()

    def map_chunked(self, items: List[T], fn: Callable[[T], object]) -> List[object]:
        """Convenience: parallel map preserving order."""
        return list(self._pool.map(fn, items))
