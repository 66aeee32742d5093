"""(Frozen copy of the program's gadgets/lookup.py.)

3-bit window table lookups for fixed-base point tables.

Port of bellman/src/gadgets/lookup.rs: the polynomial-interpolation constant
synthesis `synth` (:11-27), `lookup3_xy` (:31-118, two constraints) and
`lookup3_xy_with_conditional_negation` (:121-186, one constraint + one AND).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .boolean import Boolean, _consume, need
from .num import AllocatedNum, Num


def synth(field, window_size: int, constants: List[int]) -> List[int]:
    """Multilinear-basis coefficients for a window table (lookup.rs:11-27)."""
    p = field.p
    assignment = [0] * (1 << window_size)
    for i, constant in enumerate(constants):
        cur = (constant - assignment[i]) % p
        assignment[i] = cur
        for j in range(i + 1, len(assignment)):
            if j & i == i:
                assignment[j] = (assignment[j] + cur) % p
    return assignment


@_consume
def lookup3_xy(
    cs, bits: List[Boolean], coords: List[Tuple[int, int]]
) -> Tuple[AllocatedNum, AllocatedNum]:
    """3-bit window lookup of (x, y) coordinates (lookup.rs:31-118)."""
    assert len(bits) == 3
    assert len(coords) == 8
    f = cs.field

    vals = [b.get_value() for b in bits]
    i = (
        int(vals[0]) + 2 * int(vals[1]) + 4 * int(vals[2])
        if None not in vals
        else None
    )

    res_x = AllocatedNum.alloc(cs.namespace("x"), lambda: coords[need(i)][0])
    res_y = AllocatedNum.alloc(cs.namespace("y"), lambda: coords[need(i)][1])

    x_coeffs = synth(f, 3, [c[0] for c in coords])
    y_coeffs = synth(f, 3, [c[1] for c in coords])

    precomp = Boolean.and_(cs.namespace("precomp"), bits[1], bits[2])
    one = cs.one()

    def build(res, coeffs, label):
        cs.enforce(
            label,
            lambda lc: lc
            + (coeffs[0b001], one)
            + bits[1].lc(f, coeffs[0b011])
            + bits[2].lc(f, coeffs[0b101])
            + precomp.lc(f, coeffs[0b111]),
            lambda lc: lc + bits[0].lc(f, 1),
            lambda lc: (lc + res.get_variable())
            - (coeffs[0b000], one)
            - bits[1].lc(f, coeffs[0b010])
            - bits[2].lc(f, coeffs[0b100])
            - precomp.lc(f, coeffs[0b110]),
        )

    build(res_x, x_coeffs, "x-coordinate lookup")
    build(res_y, y_coeffs, "y-coordinate lookup")
    return res_x, res_y


@_consume
def lookup3_xy_with_conditional_negation(
    cs, bits: List[Boolean], coords: List[Tuple[int, int]]
) -> Tuple[Num, Num]:
    """2-bit lookup + sign bit (lookup.rs:121-186)."""
    assert len(bits) == 3
    assert len(coords) == 4
    f = cs.field

    v0, v1 = bits[0].get_value(), bits[1].get_value()
    i = int(v0) + 2 * int(v1) if None not in (v0, v1) else None

    def y_fn():
        tmp = coords[need(i)][1]
        if need(bits[2].get_value()):
            tmp = (-tmp) % f.p
        return tmp

    y = AllocatedNum.alloc(cs.namespace("y"), y_fn)
    one = cs.one()

    x_coeffs = synth(f, 2, [c[0] for c in coords])
    y_coeffs = synth(f, 2, [c[1] for c in coords])

    precomp = Boolean.and_(cs.namespace("precomp"), bits[0], bits[1])

    x = (
        Num.zero(f)
        .add_bool_with_coeff(one, Boolean.constant(True), x_coeffs[0b00])
        .add_bool_with_coeff(one, bits[0], x_coeffs[0b01])
        .add_bool_with_coeff(one, bits[1], x_coeffs[0b10])
        .add_bool_with_coeff(one, precomp, x_coeffs[0b11])
    )

    y_lc = (
        precomp.lc(f, y_coeffs[0b11])
        + bits[1].lc(f, y_coeffs[0b10])
        + bits[0].lc(f, y_coeffs[0b01])
        + (y_coeffs[0b00], one)
    )

    cs.enforce(
        "y-coordinate lookup",
        lambda lc: lc + y_lc + y_lc,
        lambda lc: lc + bits[2].lc(f, 1),
        lambda lc: (lc + y_lc) - y.get_variable(),
    )

    return x, Num.from_allocated(y, f)
