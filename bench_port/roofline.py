"""The card's peaks and the least time each hand-written kernel needs.

Frozen copies of chip_smoke.py's `int32_ops_per_s`, `rns_mul_ops`,
`mont_mul_ops`, `bound`, `mont_mul_bound` and `fold_bound`, so that later
changes to the program cannot move the yardstick.  Two widenings, each
equal to the original at the shapes chip_smoke.py timed: `mont_mul_bound`
takes the bytes that the launch's operands really hold (a broadcast
constant is read once, not once per lane), and `fold_bound` counts the
gathered table points once each (a window table holds 2^(c-1) + 1 points
per base, so at B above that several lanes read one point).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W): 3.35 TB/s of
HBM3 and 1,979 TOP/s of dense int8 tensor-core work.  The 32-bit integer
rate is DERIVED, not published: SMs x 64 instructions per clock per SM
(CUDA C++ Programming Guide, arithmetic instruction throughput at compute
capability 9.0) x the maximum SM clock that nvidia-smi reports, which is
132 x 64 x 1980 MHz = 16.73 T/s on the H100 SXM.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

MEM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
INT32_PER_CLOCK_PER_SM = 64
INT32_RATE_IS_DERIVED = True
H100_SXM_INT32_OPS_PER_S = 132 * INT32_PER_CLOCK_PER_SM * 1980e6

RNS_CHANNELS = 71  # the real channels of the 80-row padded RNS tiles
FR_P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FR_L = 24  # 11-bit limbs of an Fr element


def int32_ops_per_s(device_index: int = 0) -> float:
    """The card's 32-bit integer instruction rate: SMs x 64 per clock x the
    maximum SM clock from nvidia-smi (a derived peak)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", str(device_index)],
        capture_output=True, text=True, check=True).stdout.strip())
    return torch.cuda.get_device_properties(device_index).multi_processor_count * INT32_PER_CLOCK_PER_SM * mhz * 1e6


def rns_mul_ops(k: int = 35) -> Tuple[int, int]:
    """(tensor-core ops, int32 instructions) of one RNS Montgomery multiply
    per lane: the two base extensions' k (k + 1) multiply-adds on the int8
    tensor cores (12-bit operands in 6-bit halves: 4 int8 products, each a
    multiply and an add), and three int32 instructions for each of the
    2k+1 channel products, the k kappa, k+1 M^-1, k (M'/m')^-1 and k
    correction products and the 2(k+1) extension reductions."""
    tensor = 2 * k * (k + 1) * 4 * 2
    int32 = 3 * ((2 * k + 1) + k + (k + 1) + k + 2 * (k + 1) + k)
    return tensor, int32


def mont_mul_ops(p: int, L: int) -> int:
    """Integer instructions per lane of the least Montgomery product of two
    L-limb inputs: pack into s 32-bit words and unpack (3 per limb each),
    then CIOS over s words (2 s^2 word products of 4 instructions, plus s)."""
    s = -(-(2 * p).bit_length() // 32)
    return 9 * L + 8 * s * s + s


def bound(nbytes: float, int_ops: float, int_rate: float, tensor_ops: float = 0.0) -> Tuple[float, str]:
    """(bound_ms, bound_by): the largest of the bytes over the memory rate,
    the int32 instructions over the integer rate and the tensor-core ops
    over the int8 tensor-core rate (the two units run side by side)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / int_rate, tensor_ops / INT8_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mont_mul_bound(int_rate: float, lanes: int, nbytes: Optional[float] = None,
                   p: int = FR_P, L: int = FR_L) -> Tuple[float, str]:
    """K4's (bound_ms, bound_by) at (L, lanes): by default a, b read and the
    output written once (int32 limbs), else the `nbytes` the launch's
    operands and output hold; or the Montgomery product's operations."""
    if nbytes is None:
        nbytes = 3 * L * lanes * 4
    return bound(nbytes, mont_mul_ops(p, L) * lanes, int_rate)


def fold_bound(int_rate: float, name: str, lanes: int, table_points: Optional[int] = None) -> Tuple[float, str]:
    """A fold window's (bound_ms, bound_by) at `lanes`: the accumulator read
    and written, the gathered point read and the sign read once (int32
    words over the 71 real RNS channels), or its RNS multiplies' operations
    (K1 11, K2 33).  With `table_points`, the distinct table points the
    launch can gather, the gathered rows count min(lanes, table_points)
    times."""
    row = RNS_CHANNELS * 4
    tc, i32 = rns_mul_ops()
    muls, acc_rows, q_rows = (11, 6, 2) if name == "rns_fold_window" else (33, 12, 4)
    gathered = lanes if table_points is None else min(lanes, table_points)
    nbytes = (acc_rows * row + 4) * lanes + q_rows * row * gathered
    return bound(nbytes, muls * i32 * lanes, int_rate, muls * tc * lanes)
