"""The benchmark's own tests, on the CPU at small sizes:

    python3 -m pytest bench_port/tests -q

They put the benchmark's folder and the repository's root on sys.path, as
run.py does, and import no JAX."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
