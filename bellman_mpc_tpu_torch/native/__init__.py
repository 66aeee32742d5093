"""Native host runtime: C-ABI kernels loaded via ctypes.

Builds this package's copy of the JAX package's C evaluator,
native/bmt_native.c (byte-identical to bellman_mpc_tpu/native/bmt_native.c),
into this package's build/ directory on first use (cc -O3 -shared) and
exposes `lc_eval_abc`,
the sparse linear-combination evaluator used by the compiled-circuit prover
path (groth16/compiled.py).  Falls back to pure Python transparently when no
C toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "bmt_native.c"
_SO = _DIR.parent / "build" / "libbmt_native.so"

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _SO.parent.mkdir(parents=True, exist_ok=True)
            # build under a per-process name, then rename: concurrent test
            # workers never load a half-written library
            tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
            subprocess.run(
                ["cc", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(str(_SO))
        lib.lc_eval.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint32,
        ]
        lib.lc_eval.restype = None
        lib.lc_eval_mod.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.lc_eval_mod.restype = None
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _vals_to_limbs(vals: List[int]) -> np.ndarray:
    out = np.empty((len(vals), 4), dtype=np.uint64)
    for i, v in enumerate(vals):
        out[i, 0] = v & 0xFFFFFFFFFFFFFFFF
        out[i, 1] = (v >> 64) & 0xFFFFFFFFFFFFFFFF
        out[i, 2] = (v >> 128) & 0xFFFFFFFFFFFFFFFF
        out[i, 3] = (v >> 192) & 0xFFFFFFFFFFFFFFFF
    return out


class PackedLcTable:
    """Per-constraint sparse LC terms packed for the native evaluator."""

    def __init__(self, per_constraint_terms: List[List[Tuple[int, int, int]]]):
        # term = (kind, index, coeff) with kind 0=input, 1=aux
        n_terms = sum(len(t) for t in per_constraint_terms)
        self.n_cons = len(per_constraint_terms)
        self.offsets = np.zeros(self.n_cons + 1, dtype=np.uint32)
        self.kinds = np.zeros(n_terms, dtype=np.uint8)
        self.indices = np.zeros(n_terms, dtype=np.uint32)
        coeffs: List[int] = []
        k = 0
        for c, terms in enumerate(per_constraint_terms):
            self.offsets[c] = k
            for kind, idx, coeff in terms:
                self.kinds[k] = kind
                self.indices[k] = idx
                coeffs.append(coeff)
                k += 1
        self.offsets[self.n_cons] = k
        self.coeffs = _vals_to_limbs(coeffs)


_MOD_CONSTS = {}


def _mod_consts(modulus: int):
    """(p_limbs, rk, mu) arrays for the C reducer, cached per modulus."""
    if modulus not in _MOD_CONSTS:
        p_limbs = _vals_to_limbs([modulus])
        rk = _vals_to_limbs([pow(2, 64 * k, modulus) for k in range(5, 9)])
        mu_v = (1 << 322) // modulus
        mu = np.asarray([mu_v & ((1 << 64) - 1), mu_v >> 64], np.uint64)
        _MOD_CONSTS[modulus] = (p_limbs, rk, mu)
    return _MOD_CONSTS[modulus]


def lc_eval_bytes(
    table: PackedLcTable,
    in_arr: np.ndarray,
    aux_arr: np.ndarray,
    modulus: int,
    nbytes: int,
) -> np.ndarray:
    """Evaluate all constraints' LCs mod `modulus` straight to packed
    little-endian bytes ((n_cons, nbytes) uint8, the pack_std wire format).

    in_arr/aux_arr are (n, 4) u64 limb arrays from `vals_to_limbs`; the
    reduction and byte packing run in C (no Python bigints on this path)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    # the C reducer's Barrett stage assumes a 255-bit modulus
    assert (1 << 254) < modulus < (1 << 255)
    p_limbs, rk, mu = _mod_consts(modulus)
    if aux_arr.shape[0] == 0:
        aux_arr = np.zeros((1, 4), np.uint64)
    out = np.zeros((table.n_cons, nbytes), dtype=np.uint8)
    lib.lc_eval_mod(
        in_arr.ctypes.data, aux_arr.ctypes.data,
        table.offsets.ctypes.data, table.kinds.ctypes.data,
        table.indices.ctypes.data, table.coeffs.ctypes.data,
        p_limbs.ctypes.data, rk.ctypes.data, mu.ctypes.data,
        out.ctypes.data, nbytes, table.n_cons,
    )
    return out


def vals_to_limbs(vals: List[int]) -> np.ndarray:
    """Public alias: host ints (< 2^256) -> (n, 4) u64 LE limb array."""
    return _vals_to_limbs(vals)


def limbs_to_bytes(arr: np.ndarray, nbytes: int) -> np.ndarray:
    """(n, 4) u64 LE limbs -> (n, nbytes) uint8 (pack_std wire format)."""
    raw = arr.view(np.uint8).reshape(arr.shape[0], 32)
    if nbytes <= 32:
        return raw[:, :nbytes]
    return np.pad(raw, ((0, 0), (0, nbytes - 32)))


def lc_eval(
    table: PackedLcTable,
    inputs: List[int],
    aux: List[int],
    modulus: int,
) -> List[int]:
    """Evaluate all constraints' LCs; returns values mod `modulus`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    in_arr = _vals_to_limbs(inputs)
    aux_arr = _vals_to_limbs(aux) if aux else np.zeros((1, 4), np.uint64)
    out = np.zeros((table.n_cons, 9), dtype=np.uint64)
    lib.lc_eval(
        in_arr.ctypes.data, aux_arr.ctypes.data,
        table.offsets.ctypes.data, table.kinds.ctypes.data,
        table.indices.ctypes.data, table.coeffs.ctypes.data,
        out.ctypes.data, table.n_cons,
    )
    raw = out.tobytes()  # 72 bytes per constraint, little-endian
    return [
        int.from_bytes(raw[i * 72 : (i + 1) * 72], "little") % modulus
        for i in range(table.n_cons)
    ]
