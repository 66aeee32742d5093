"""The limb Montgomery multiply kernel: plain PyTorch version and CUDA wrapper.

Counterpart of the TPU kernel K4 of bellman_mpc_tpu/ops/pallas_kernels.py,
`_jit_mont_mul_pallas` (body `_mont_mul_block`, entry `mont_mul_pallas`):
the Montgomery product a*b*R^-1 of (L, N) int32 tensors of 11-bit limbs.
The h(x) pipeline routes its coset pointwise product through it
(groth16/prover.py).

The plain version is `LimbField.mul` (product columns, then `redc_cols`):
the reference asserts the same of its kernel and its `LimbField.mul`.
`mont_mul` takes it ONLY for tensors on the CPU; a CUDA tensor goes to the
hand-written kernel (csrc/mont_mul.cu `bmt_mont_mul`) or the wrapper
raises.  Raw output limbs of the kernel, of the reference kernel and of
`LimbField.mul` are equal.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.limb import LimbField
from .kernel_lib import device_kind, launch_counts, load, raise_on, stream

# limb counts the CUDA kernel is instantiated for: mock (2), Fr (24), Fp (36)
KERNEL_L = (2, 24, 36)


def mont_mul(field: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: Montgomery product of two (L, N) int32 limb tensors (the
    reference's `mont_mul_pallas`)."""
    L = field.L
    if a.dim() != 2 or a.shape[0] != L or a.shape != b.shape:
        raise ValueError(f"expected two ({L}, N) limb tensors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if device_kind(a) == "cpu" and device_kind(b) == "cpu":
        return field.mul(a, b)
    for t in (a, b):
        if t.device != a.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("mont_mul takes contiguous int32 tensors on one CUDA device")
    if L not in KERNEL_L:
        raise ValueError(f"the CUDA kernel is built for L in {KERNEL_L}, not {L}")
    n = a.shape[1]
    out = torch.empty_like(a)
    p_limbs = (ctypes.c_int * L)(*field._p_list)
    err = load().bmt_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), p_limbs, L,
                              field.n0inv, n, stream(a.device))
    raise_on(err, "bmt_mont_mul")
    launch_counts["mont_mul"] += 1
    return out
