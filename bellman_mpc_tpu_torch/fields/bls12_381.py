"""BLS12-381 curve constants and host/device field instances.

All constants are standard public parameters of the BLS12-381 pairing curve
(the reference consumes them through its `bls12_381` crate dependency,
bellman/Cargo.toml:22).  Same constants as bellman_mpc_tpu/fields/bls12_381.py;
the device field engines below are the PyTorch LimbFields.  Derived
constants (roots of unity, Frobenius coefficients, cofactors) are computed
here at import time with exact Python bigint arithmetic.
"""

from __future__ import annotations

from .host import PrimeField
from .limb import LimbField

# Base field modulus p and scalar field modulus r (group order).
P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
R = int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001",
    16,
)

# BLS parameter x (negative, low hamming weight): p, r are polynomials in x.
X = -0xD201000000010000

assert (X ** 4 - X ** 2 + 1) == R, "r(x) sanity"
assert ((X - 1) ** 2 * R) % 3 == 0 and ((X - 1) ** 2 // 3) * R + X == P, "p(x) sanity"

# Curve equations: E/Fp: y^2 = x^3 + 4 ; twist E'/Fp2: y^2 = x^3 + 4(u+1).
B_G1 = 4

# Standard generators (subgroup generators used by all implementations).
G1_X = int(
    "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb",
    16,
)
G1_Y = int(
    "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
    "d03cc744a2888ae40caa232946c5e7e1",
    16,
)
G2_X_C0 = int(
    "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
    "0bac0326a805bbefd48056c8c121bdb8",
    16,
)
G2_X_C1 = int(
    "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
    "334cf11213945d57e5ac7d055d042b7e",
    16,
)
G2_Y_C0 = int(
    "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
    "923ac9cc3baca289e193548608b82801",
    16,
)
G2_Y_C1 = int(
    "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
    "3f370d275cec1da1aaa9075ff05f79be",
    16,
)

# On-curve sanity checks (catch any transcription error at import time).
assert (G1_Y * G1_Y - (G1_X ** 3 + 4)) % P == 0, "G1 generator not on curve"


def _fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def _fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


_g2x = (G2_X_C0, G2_X_C1)
_g2y = (G2_Y_C0, G2_Y_C1)
_lhs = _fp2_mul(_g2y, _g2y)
_rhs = _fp2_add(_fp2_mul(_fp2_mul(_g2x, _g2x), _g2x), (4, 4))
assert _lhs == _rhs, "G2 generator not on curve"

# Host field objects.  Multiplicative generators: Fr uses 7, Fp uses 2
# (standard smallest generators for these moduli).
fr_host = PrimeField(R, generator=7, name="Fr")
fp_host = PrimeField(P, generator=2, name="Fp")
assert fr_host.S == 32, "Fr two-adicity"

# Device (limb) field engines — shared singletons (constants on the CPU,
# copied to a tensor's device on first use there).
fr = LimbField(R, name="Fr")
fp = LimbField(P, name="Fp")
