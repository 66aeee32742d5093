"""The port's CUDA kernel library: build, load, launch helpers and counts.

Every `csrc/*.cu` source is compiled by nvcc for sm_90a (one process per
source, all started together) and linked into one shared library,
`build/libbmt_fold.so`, with plain C entry points bound through ctypes.
The library is built at first use and rebuilt whenever a source is newer
than it, so a library from before a source changed is never loaded.

`launch_counts` has one entry per kernel wrapper (ops/fold_kernels.py,
ops/mont_kernels.py); a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_SO = _BUILD / "libbmt_fold.so"
_lib = None

launch_counts: Dict[str, int] = {
    "mont_mul": 0, "rns_mul_many": 0, "rns_fold_window": 0, "rns_fold_window_g2": 0,
    "lazy_cols": 0, "lazy_redc": 0,
}
# calls of a kernel's plain version on a CUDA tensor (LimbField.mul_plain,
# lazy_cols_plain and lazy_redc_plain count here), so a run can show that
# its path took none of them
plain_counts: Dict[str, int] = {"mont_mul": 0, "lazy_cols": 0, "lazy_redc": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, plain_counts):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return exe


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def nvcc_command(src, out, shared: bool = False) -> List[str]:
    """The nvcc command line for one source: sm_90a, -O3, ptxas's report;
    an object file, or with `shared` a shared library of that source alone."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared" if shared else "-c",
            str(src), "-o", str(out)]


def build(verbose: bool = False) -> float:
    """Compile csrc/*.cu for sm_90a, one nvcc per source in parallel, and
    link them into build/libbmt_fold.so.  Returns the build seconds; raises
    with nvcc's output on failure.  verbose prints ptxas's register and
    shared-memory report."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = _BUILD / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(nvcc_command(src, obj), stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    reports, failed = [], []
    for src, obj, proc in jobs:
        out, err = proc.communicate()
        reports.append(f"{src.name}:\n{err.strip()}")
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{out}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = _SO.with_name(f"{_SO.name}.{tag}")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in jobs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, _SO)
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("\n".join(reports), file=sys.stderr)
    return time.perf_counter() - t0


def _stale() -> bool:
    if not _SO.exists():
        return True
    built = _SO.stat().st_mtime
    return any(src.stat().st_mtime > built for src in _sources())


_P, _I = ctypes.c_void_p, ctypes.c_int
# every C entry point's argument types (each returns an int)
ARGTYPES = {
    "bmt_mont_mul": [_P, _P, _P, _P, _P, _I, _I, _P],
    "bmt_mont_mul_wave_lanes": [_I],
    "bmt_rns_mul": [_P, _P, _P, _P, _P, _I, _P],
    "bmt_fold_g1": [_P] * 6 + [_P] * 3 + [_P, _P, _P, _I, _I, _P],
    "bmt_fold_g2": [_P] * 6 + [_P] * 3 + [_P, _P, _P, _I, _I, _P],
    "bmt_fold_g1_wave_lanes": [],
    "bmt_fold_g2_wave_lanes": [],
    "bmt_rns_mul_wave_lanes": [],
    "bmt_lazy_cols": [_P, _P, _P, _P, _I, _I, _P],
    "bmt_lazy_redc": [_P, _P, _P, _P, _I, _I, _P],
    "bmt_lazy_cols_wave_lanes": [_I],
    "bmt_lazy_redc_wave_lanes": [_I],
}


def bind(lib: ctypes.CDLL, names=ARGTYPES) -> ctypes.CDLL:
    """Set the ctypes signature of each named entry point of `lib`."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def load():
    """The loaded library with every entry point's ctypes signature."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        _lib = bind(ctypes.CDLL(str(_SO)))
    return _lib


def device_kind(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
