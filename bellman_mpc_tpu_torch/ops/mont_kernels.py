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
"""

from __future__ import annotations

import ctypes
import functools
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


def mont_mul(field: "LimbField", a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: Montgomery product of two broadcastable (L, *batch) int32 limb
    tensors, lazy (< 2p) with canonical digits; `LimbField.mul` is this."""
    L = field.L
    if (a.dim() != b.dim() or a.dim() == 0 or a.shape[0] != L or b.shape[0] != L
            or any(x != y and x != 1 and y != 1 for x, y in zip(a.shape, b.shape))):
        raise ValueError(f"expected two broadcastable ({L}, *batch) limb tensors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"mont_mul takes int32 limbs, got {a.dtype} and {b.dtype}")
    if device_kind(a) == "cpu" and device_kind(b) == "cpu":
        return field.mul_plain(a, b)
    if a.device != b.device:
        raise ValueError(f"mont_mul takes tensors on one CUDA device, got {a.device} and {b.device}")
    if L not in KERNEL_L:
        raise ValueError(f"the CUDA kernel is built for L in {KERNEL_L}, not {L}")
    shape = tuple(y if x == 1 else x for x, y in zip(a.shape, b.shape))
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n == 0:
        return out
    if n >= 1 << 31:
        raise ValueError(f"mont_mul takes fewer than 2^31 lanes, got {n}")
    ga, gb = lane_map(a, shape), lane_map(b, shape)
    if ga is None:  # three or more lane levels: one copy
        a = a.expand(shape).contiguous()
        ga = lane_map(a, shape)
    if gb is None:
        b = b.expand(shape).contiguous()
        gb = lane_map(b, shape)
    err = load().bmt_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), word_consts(field.p, L),
                              (ctypes.c_longlong * 8)(*ga, *gb), L, n, stream(out.device))
    raise_on(err, "bmt_mont_mul")
    launch_counts["mont_mul"] += 1
    return out


def wave_lanes(L: int) -> int:
    """Lanes that one full wave of K4's blocks covers on the current CUDA
    device (SMs x resident blocks per SM x 64 threads, one lane each)."""
    return int(load().bmt_mont_mul_wave_lanes(L))
