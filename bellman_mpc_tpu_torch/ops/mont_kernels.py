"""The limb Montgomery multiply kernel: plain PyTorch version and CUDA wrapper.

Counterpart of the TPU kernel K4 of bellman_mpc_tpu/ops/pallas_kernels.py,
`_jit_mont_mul_pallas` (body `_mont_mul_block`, entry `mont_mul_pallas`):
the Montgomery product a*b*R^-1 of int32 tensors of 11-bit limbs, limbs
first.  `LimbField.mul` calls `mont_mul`, so every limb multiply of the
port (the h(x) pipeline's NTT stages and scalings, Montgomery conversions,
Fermat inversions on decode) goes through it.

The plain version is `LimbField.mul_plain` (product columns, then
`redc_cols`): the reference asserts the same of its kernel and its
`LimbField.mul`.  `mont_mul` takes it ONLY for tensors on the CPU; a CUDA
tensor goes to the hand-written kernel (csrc/mont_mul.cu `bmt_mont_mul`) or
the wrapper raises.  Raw output limbs of the kernel, of the reference kernel
and of the plain version are equal.

Operands come as the call sites have them: broadcast constants (stride 0),
strided views such as the NTT's upper half `xr[..., half:]`.  The kernel
reads each operand through a limb stride and a two-level lane index with
strides (`lane_map`), so no operand is copied unless its lanes need three
levels; the output is a new contiguous tensor of the broadcast shape.

The lazy columns (`LazyCols`, fields/limb.py) are the same product split
in two, with integer column arithmetic (sums, differences with their
offsets, scalings, folds) between the halves and ONE reduction.  Every
caller of `lazy_mul_many` / `lazy_reduce_many` runs through them: the limb
point operations of curves/device.py (proof assembly, CRS ladders, the
table build's bucket chains, the limb MSMs), the RNS-to-limb bridge and the
Fp2/Fp6/Fp12 tower of the pairing.

* K5, `lazy_cols`: the (2L, *batch) schoolbook columns of two broadcastable
  (L, *batch) int32 digit tensors (digits or raw digit sums, as the callers'
  bounds allow).  Plain version `LimbField.mul_cols`, through
  `LimbField.lazy_cols_plain`.
* K6, `lazy_redc`: (2L, *batch) non-negative int32 columns of value
  T < 3pR -> the (L, *batch) canonical digits of (T + M p) / R.  Plain
  version `LimbField.lazy_redc_plain`: the carry folds of the host's
  `_reduce_plan`, then `LimbField.redc_cols`.

No TPU kernel is replaced by these two (the reference leaves this path to
XLA's fusion).  Both wrappers check and dispatch as `mont_mul` does, with
the same helpers; the kernels (csrc/mont_mul.cu, beside K4) need neither
the fold plan nor the bounds, which the host keeps proving (`_product_hi`,
`_reduce_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING, Optional, Tuple

import torch

from .kernel_lib import device_kind, launch_counts, load, raise_on, stream

if TYPE_CHECKING:
    from ..fields.limb import LimbField

# limb counts the CUDA kernel is instantiated for: mock (2), Fr (24), Fp (36)
KERNEL_L = (2, 24, 36)


@functools.lru_cache(maxsize=None)
def word_consts(p: int, L: int) -> ctypes.Array:
    """The kernel's modulus constants, host uint32 words: N (the 32-bit
    words of a value below 2p), p's N words, -p^-1 mod 2^32 (the whole-word
    steps' m) and -p^-1 mod 2^(11L - 32 floor(11L/32)) (the final step's)."""
    n_words = -(-(2 * p - 1).bit_length() // 32)
    r_bits = 11 * L - 32 * (11 * L // 32)
    vals = ([n_words] + [(p >> (32 * k)) & 0xFFFFFFFF for k in range(n_words)]
            + [-pow(p, -1, 1 << 32) % (1 << 32), -pow(p, -1, 1 << r_bits) % (1 << r_bits)])
    return (ctypes.c_uint32 * len(vals))(*vals)


def lane_map(t: torch.Tensor, shape: Tuple[int, ...]) -> Optional[Tuple[int, int, int, int]]:
    """(limb stride, n0, s1, s0) such that lane i = i1 * n0 + i0 of the
    (L, *batch) broadcast `shape`, in row-major order over the batch, lies at
    element offset i1 * s1 + i0 * s0 (+ limb * limb stride) of t (whose
    shape broadcasts to `shape`, axis for axis); None when t's batch axes do
    not merge into two."""
    strides = t.stride()
    dims = []  # (size, stride), outer first, size-1 axes dropped, mergeable axes merged
    for size, own, st in zip(shape[1:], t.shape[1:], strides[1:]):
        if size == 1:
            continue
        if own == 1:
            st = 0  # broadcast
        if dims and dims[-1][1] == st * size:
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    if len(dims) > 2:
        return None
    dims = [(1, 0)] * (2 - len(dims)) + dims
    return strides[0], dims[1][0], dims[0][1], dims[1][1]


def check_limbs(name: str, rows: int, *ts: torch.Tensor) -> Tuple[int, ...]:
    """The operand checks of K4, K5 and K6, on every device: `ts` are int32
    (rows, *batch) tensors of one rank whose batch axes broadcast; returns
    the broadcast batch shape."""
    if (any(t.dim() != ts[0].dim() or t.dim() == 0 or t.shape[0] != rows for t in ts)
            or any(len(set(sizes) - {1}) > 1 for sizes in zip(*(t.shape[1:] for t in ts)))):
        raise ValueError(f"{name} expected broadcastable ({rows}, *batch) limb tensors, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype != torch.int32 for t in ts):
        raise ValueError(f"{name} takes int32 limbs, got {[t.dtype for t in ts]}")
    return tuple(max(set(sizes) - {1}, default=1) for sizes in zip(*(t.shape[1:] for t in ts)))


def on_cpu(name: str, field: "LimbField", *ts: torch.Tensor) -> bool:
    """True where every operand is on the CPU (the plain version's case);
    for CUDA operands, checks that they share one device and that the
    kernels are built for field.L, and returns False."""
    if all(device_kind(t) == "cpu" for t in ts):
        return True
    if len({t.device for t in ts}) > 1:
        raise ValueError(f"{name} takes tensors on one CUDA device, got {[str(t.device) for t in ts]}")
    if field.L not in KERNEL_L:
        raise ValueError(f"the CUDA kernel is built for L in {KERNEL_L}, not {field.L}")
    return False


def lane_geometry(name: str, batch: Tuple[int, ...], *ts: torch.Tensor):
    """(the operands, their lane maps as the host [ls, n0, s1, s0] words of
    each, n) for a launch over the n lanes of `batch`; an operand whose lanes
    need three or more levels is copied once."""
    n = math.prod(batch)
    if n >= 1 << 31:
        raise ValueError(f"{name} takes fewer than 2^31 lanes, got {n}")
    out, geo = [], []
    for t in ts:
        shape = (t.shape[0],) + batch
        g = lane_map(t, shape)
        if g is None:
            t = t.expand(shape).contiguous()
            g = lane_map(t, shape)
        out.append(t)
        geo.extend(g)
    return out, (ctypes.c_longlong * len(geo))(*geo), n


def mont_mul(field: "LimbField", a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: Montgomery product of two broadcastable (L, *batch) int32 limb
    tensors, lazy (< 2p) with canonical digits; `LimbField.mul` is this."""
    L = field.L
    batch = check_limbs("mont_mul", L, a, b)
    if on_cpu("mont_mul", field, a, b):
        return field.mul_plain(a, b)
    out = torch.empty((L,) + batch, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    (a, b), geo, n = lane_geometry("mont_mul", batch, a, b)
    err = load().bmt_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), word_consts(field.p, L), geo, L, n,
                              stream(out.device))
    raise_on(err, "bmt_mont_mul")
    launch_counts["mont_mul"] += 1
    return out


def lazy_cols(field: "LimbField", a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5: schoolbook product columns of two broadcastable (L, *batch) int32
    digit tensors -> (2L, *batch), column 2L - 1 zero."""
    L = field.L
    batch = check_limbs("lazy_cols", L, a, b)
    if on_cpu("lazy_cols", field, a, b):
        return field.lazy_cols_plain(a, b)
    out = torch.empty((2 * L,) + batch, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    (a, b), geo, n = lane_geometry("lazy_cols", batch, a, b)
    err = load().bmt_lazy_cols(a.data_ptr(), b.data_ptr(), out.data_ptr(), geo, L, n, stream(out.device))
    raise_on(err, "bmt_lazy_cols")
    launch_counts["lazy_cols"] += 1
    return out


def lazy_redc(field: "LimbField", cols: torch.Tensor, plan: Tuple[int, int]) -> torch.Tensor:
    """K6: one Montgomery reduction of (2L, *batch) non-negative int32
    columns -> (L, *batch) canonical digits.  `plan` is `_reduce_plan`'s
    (folds before, fold steps after), which only the plain version needs."""
    L = field.L
    batch = check_limbs("lazy_redc", 2 * L, cols)
    if on_cpu("lazy_redc", field, cols):
        return field.lazy_redc_plain(cols, plan)
    out = torch.empty((L,) + batch, dtype=torch.int32, device=cols.device)
    if out.numel() == 0:
        return out
    (cols,), geo, n = lane_geometry("lazy_redc", batch, cols)
    err = load().bmt_lazy_redc(cols.data_ptr(), out.data_ptr(), word_consts(field.p, L), geo, L, n,
                               stream(out.device))
    raise_on(err, "bmt_lazy_redc")
    launch_counts["lazy_redc"] += 1
    return out


def wave_lanes(L: int, kernel: str = "mont_mul") -> int:
    """Lanes that one full wave of a kernel's blocks covers on the current
    CUDA device (SMs x resident blocks per SM x 64 threads, one lane each):
    K4's ("mont_mul"), K5's ("lazy_cols") or K6's ("lazy_redc")."""
    return int(getattr(load(), f"bmt_{kernel}_wave_lanes")(L))
