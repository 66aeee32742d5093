"""RNS (residue number system) field engine on PyTorch tensors.

Port of bellman_mpc_tpu/fields/rns.py.  A value is held as residues modulo
71 coprime 12-bit primes: base B (35), base B' (35) and one redundant channel
m_r (Shenoy–Kumaresan), on a leading channel axis [B | B' | m_r].  RNS
Montgomery multiplication (Bajard et al.) reduces by CONSTANT matrices, which
is why the reference adopted it for the TPU's matrix unit.

The constants and the host-side `Fraction` bound bookkeeping are the
reference's, verbatim: every value carries a bound `a` (value < a*p), and
subtraction/negation add K*p with K = ceil(bound).  Those K values fix the
residues, so the port keeps them exactly and its residues equal the
reference's channel by channel.

What differs is only the exact integer route: channelwise products are
reduced with `%` on int64, and the base extensions and digit conversions are
float64 matrix products (every sum < 2^31 < 2^53, so exact) — PyTorch has no
integer matmul on CUDA, and the TPU's 6-bit lo/hi int8 split is not needed.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _primes_desc(below: int, count: int) -> List[int]:
    """The `count` largest primes < below (host sieve)."""
    sieve = np.ones(below, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(below ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = False
    primes = np.nonzero(sieve)[0][::-1]
    assert len(primes) >= count, "not enough primes below bound"
    return [int(x) for x in primes[:count]]


def _ceil(a: Fraction) -> int:
    return int(-(-a.numerator // a.denominator))


def int_matmul(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact (T, S) x (S, n) product of small non-negative integers through
    a float64 matmul (callers keep every sum below 2^53); int64 result."""
    return torch.matmul(W.to(torch.float64), x.to(torch.float64)).to(torch.int64)


class RnsVal:
    """(C, *batch) int32 canonical channel residues plus the host bound `a`
    (value < a * p, tracked exactly)."""

    __slots__ = ("f", "res", "a")

    def __init__(self, f, res: torch.Tensor, a: Fraction):
        self.f = f
        self.res = res
        self.a = Fraction(a)
        # value < min(M, M'): base-B CRT determines it AND the exact second
        # extension (which needs r < M') stays valid.
        assert self.a * f.p < f.Mmin, "RNS value bound exceeds base range"

    def __add__(self, o: "RnsVal") -> "RnsVal":
        f = self.f
        s = self.res + o.res
        m = f.m_bc(s)
        s = torch.where(s >= m, s - m, s)
        return RnsVal(f, s, self.a + o.a)

    def __sub__(self, o: "RnsVal") -> "RnsVal":
        """self - o + K*p for the smallest integer K with K >= o.a."""
        f = self.f
        K = _ceil(o.a)
        kp = f.kp_table(K, self.res)
        s = self.res - o.res + kp
        m = f.m_bc(s)
        s = torch.where(s >= m, s - m, s)
        s = torch.where(s < 0, s + m, s)
        return RnsVal(f, s, self.a + K)

    def neg(self) -> "RnsVal":
        f = self.f
        K = _ceil(self.a)
        kp = f.kp_table(K, self.res)
        s = kp - self.res
        m = f.m_bc(s)
        s = torch.where(s >= m, s - m, s)
        # keep residues CANONICAL (the reference's fixup): kp < m and res < m
        # make s > -m possible.
        s = torch.where(s < 0, s + m, s)
        return RnsVal(f, s, Fraction(K))

    def scale(self, k: int) -> "RnsVal":
        """Multiply by a small non-negative host integer (e.g. curve b3)."""
        f = self.f
        assert 0 <= k < (1 << 12)
        return RnsVal(f, f.reduce(self.res * k), self.a * k)

    def double(self) -> "RnsVal":
        return self + self


class RnsField:
    """RNS context for GF(p): channel layout [B (k) | B' (k) | m_r]."""

    def __init__(self, p: int, k: int = 35, name: str = "Fp"):
        self.p = p
        self.name = name
        self.k = k
        primes = _primes_desc(1 << 12, 2 * k + 1)
        self.mB = primes[0::2][:k]
        self.mBp = primes[1::2][:k]
        self.mr = primes[2 * k]
        self.C = 2 * k + 1
        self.moduli = self.mB + self.mBp + [self.mr]
        M = 1
        for m in self.mB:
            M *= m
        Mp = 1
        for m in self.mBp:
            Mp *= m
        self.M, self.Mp = M, Mp
        self.Mmin = min(M, Mp)
        assert M > (4 * k) * p and Mp > (4 * k) * p
        assert self.mr > k + 1

        self.m_np = np.asarray(self.moduli, np.int64)
        kappa = [0] * self.C
        for i, m in enumerate(self.mB):
            kappa[i] = (-pow(p, -1, m) * pow(M // m, -1, m)) % m
        self.kappa_np = np.asarray(kappa, np.int64)
        minv = [0] * self.C
        for j, m in enumerate(self.mBp):
            minv[k + j] = pow(M, -1, m)
        minv[2 * k] = pow(M, -1, self.mr)
        self.minv_np = np.asarray(minv, np.int64)
        ifac2 = [0] * self.C
        for j, m in enumerate(self.mBp):
            ifac2[k + j] = pow(Mp // m, -1, m)
        self.ifac2_np = np.asarray(ifac2, np.int64)
        self.mpinv_mr = int(pow(Mp, -1, self.mr))
        mp_mod = [0] * self.C
        for i, m in enumerate(self.mB):
            mp_mod[i] = Mp % m
        self.mp_mod_np = np.asarray(mp_mod, np.int64)

        # ext1: targets B' ∪ {m_r}, entries ((M/m_i) * p) mod target
        tg1 = self.mBp + [self.mr]
        W1 = np.zeros((k + 1, k), np.int64)
        for i, mi in enumerate(self.mB):
            v = (M // mi) * p
            for jt, mt in enumerate(tg1):
                W1[jt, i] = v % mt
        self.W1_np = W1
        # ext2: targets B ∪ {m_r}, entries (M'/m'_j) mod target
        tg2 = self.mB + [self.mr]
        W2 = np.zeros((k + 1, k), np.int64)
        for j, mj in enumerate(self.mBp):
            v = Mp // mj
            for it, mt in enumerate(tg2):
                W2[it, j] = v % mt
        self.W2_np = W2

        # CRT constants for RNS -> limb extraction
        ifac1 = [0] * self.C
        for i, m in enumerate(self.mB):
            ifac1[i] = pow(M // m, -1, m)
        self.ifac1_np = np.asarray(ifac1, np.int64)
        self.mfac_mod_mr_np = np.asarray([(M // m) % self.mr for m in self.mB], np.int64)
        self.m_mod_mr_inv = int(pow(M % self.mr, -1, self.mr))

        self._cache: Dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------ utilities
    def _t(self, key: str, build, device) -> torch.Tensor:
        """Cached device copy of a host constant (numpy int64 array)."""
        ck = (key, str(torch.device(device)))
        t = self._cache.get(ck)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(build())).to(device)
            self._cache[ck] = t
        return t

    @staticmethod
    def _bc(const_1d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return const_1d.reshape((const_1d.shape[0],) + (1,) * (like.dim() - 1))

    def m_bc(self, like: torch.Tensor) -> torch.Tensor:
        m = self._t("m32", lambda: self.m_np.astype(np.int32), like.device)
        return self._bc(m, like)

    def kp_table(self, K: int, like: torch.Tensor) -> torch.Tensor:
        """(C, 1, ...) residues of K*p, broadcastable against `like`."""
        v = K * self.p
        kp = self._t(("kp", K), lambda: np.asarray([v % m for m in self.moduli], np.int32),
                     like.device)
        return self._bc(kp, like)

    def reduce(self, t: torch.Tensor, lo: int = 0, hi: int = None) -> torch.Tensor:
        """Channelwise t mod m over channels [lo, hi) (exact, any size)."""
        hi = self.C if hi is None else hi
        m = self._t("m64", lambda: self.m_np, t.device)[lo:hi]
        return (t.to(torch.int64) % self._bc(m, t)).to(torch.int32)

    def _const_bc(self, key: str, arr_np, lo: int, hi: int, like: torch.Tensor) -> torch.Tensor:
        c = self._t(key, lambda: arr_np, like.device)[lo:hi]
        return self._bc(c, like)

    def _ext(self, xi: torch.Tensor, key: str, W_np: np.ndarray, mods) -> torch.Tensor:
        """Base extension: (k, *batch) canonical residues -> (k+1, *batch)
        values of sum_i xi_i * W[t, i] mod m_t (exact float64 product)."""
        k = self.k
        batch = xi.shape[1:]
        W = self._t(key, lambda: W_np, xi.device)
        out = int_matmul(W, xi.reshape(k, -1)).reshape((k + 1,) + tuple(batch))
        m = self._t(key + "_m", lambda: np.asarray(mods, np.int64), xi.device)
        return (out % self._bc(m, out)).to(torch.int32)

    # ------------------------------------------------------------- multiply
    def mul_many(self, pairs: Sequence[Tuple[RnsVal, RnsVal]]) -> List[RnsVal]:
        """Stacked RNS Montgomery multiply: k pairs through ONE pipeline.
        Output value bound: Ax*Ay*p/M + k + 1 (ceiled, as the reference)."""
        k = self.k
        C = self.C
        xs = torch.stack([a.res for a, _ in pairs], dim=1).to(torch.int64)
        ys = torch.stack([b.res for _, b in pairs], dim=1).to(torch.int64)
        t = self.reduce(xs * ys)
        xi = self.reduce(t[:k].to(torch.int64) * self._const_bc("kappa", self.kappa_np, 0, k, t), 0, k)
        qp = self._ext(xi, "W1", self.W1_np, self.mBp + [self.mr])  # B' ∪ m_r
        s = t[k:] + qp
        m_hi = self.m_bc(t)[k:]
        s = torch.where(s >= m_hi, s - m_hi, s)
        rp = self.reduce(s.to(torch.int64) * self._const_bc("minv", self.minv_np, k, C, s), k, C)
        xi2 = self.reduce(
            rp[:-1].to(torch.int64) * self._const_bc("ifac2", self.ifac2_np, k, 2 * k, rp[:-1]),
            k, 2 * k,
        )
        ext2 = self._ext(xi2, "W2", self.W2_np, self.mB + [self.mr])  # B ∪ m_r
        # alpha' = (ext2[m_r] - r'_mr) * M'^{-1} mod m_r  (exact SK count)
        d = ext2[-1] - rp[-1]
        d = torch.where(d < 0, d + self.mr, d)
        alpha = (d.to(torch.int64) * self.mpinv_mr) % self.mr
        corr = self.reduce(alpha[None] * self._const_bc("mp_mod", self.mp_mod_np, 0, k, ext2[:k]), 0, k)
        rB = ext2[:k] - corr
        mB = self.m_bc(t)[:k]
        rB = torch.where(rB < 0, rB + mB, rB)
        res = torch.cat([rB, rp], dim=0)
        outs = []
        for i, (a, b) in enumerate(pairs):
            bound = a.a * b.a * Fraction(self.p, self.M) + (self.k + 1)
            if bound.denominator != 1:
                bound = Fraction(bound.numerator // bound.denominator + 1)
            outs.append(RnsVal(self, res[:, i], bound))
        return outs

    def mul(self, a: RnsVal, b: RnsVal) -> RnsVal:
        return self.mul_many([(a, b)])[0]

    def mul_const(self, a: RnsVal, c: int) -> RnsVal:
        """Multiply by a host constant (weight M^{-1} like any RNS mul —
        pass c pre-multiplied by M mod p to preserve M-residue form)."""
        cv = self.encode_raw(c % self.p, like=a.res)
        return self.mul(a, RnsVal(self, cv, Fraction(1)))

    # ------------------------------------------------------- select / tests
    def select(self, cond: torch.Tensor, a: RnsVal, b: RnsVal) -> RnsVal:
        return RnsVal(self, torch.where(cond, a.res, b.res), max(a.a, b.a))

    def is_zero_exact(self, a: RnsVal) -> torch.Tensor:
        """True iff the represented INTEGER is exactly 0 (value < M makes
        all-B-channels-zero equivalent to zero)."""
        return torch.all(a.res[: self.k] == 0, dim=0)

    # --------------------------------------------------------- encode/decode
    def encode_raw(self, v: int, like: torch.Tensor = None, device="cpu") -> torch.Tensor:
        """Residues of the host integer v, broadcast to `like`'s batch."""
        dev = like.device if like is not None else device
        r = torch.tensor([v % m for m in self.moduli], dtype=torch.int32, device=dev)
        if like is None:
            return r
        return r.reshape((self.C,) + (1,) * (like.dim() - 1)).expand((self.C,) + tuple(like.shape[1:]))

    def encode(self, values: Sequence[int], mont: bool = True, device="cpu") -> RnsVal:
        """Host ints -> (C, N) residues in RNS M-residue form."""
        out = np.zeros((self.C, len(values)), np.int32)
        for j, v in enumerate(values):
            v = (v * self.M % self.p) if mont else (v % self.p)
            for i, m in enumerate(self.moduli):
                out[i, j] = v % m
        return RnsVal(self, torch.from_numpy(out).to(device), Fraction(1))

    def decode(self, a: RnsVal, mont: bool = True) -> List[int]:
        """Residues -> host ints (CRT over base B; value < M)."""
        flat = a.res.reshape(self.C, -1).cpu().numpy()
        out = []
        minv = pow(self.M, -1, self.p) if mont else 1
        for j in range(flat.shape[1]):
            v = 0
            for i, m in enumerate(self.mB):
                Mi = self.M // m
                v += int(flat[i, j]) * pow(Mi, -1, m) % m * Mi
            v %= self.M
            out.append(v * minv % self.p)
        return out

    # ------------------------------------------------- limb-form conversion
    def digit_matrix(self, n_dig: int, limb_bits: int = 11) -> np.ndarray:
        W = np.zeros((self.C, n_dig), np.int64)
        for c, m in enumerate(self.moduli):
            for d in range(n_dig):
                W[c, d] = pow(2, limb_bits * d, m)
        return W

    def from_digits(self, digits: torch.Tensor, bound: int, limb_bits: int = 11) -> RnsVal:
        """(D, *batch) canonical limb digits of a value < bound*p -> RNS
        residues of the SAME integer: res_c = sum_d digits_d * (2^(11d) mod m_c)
        (sums < 72 * 2^11 * 2^12 < 2^30, exact in float64)."""
        D = digits.shape[0]
        W = self._t(("digits", D, limb_bits), lambda: self.digit_matrix(D, limb_bits), digits.device)
        out = int_matmul(W, digits.reshape(D, -1)).reshape((self.C,) + tuple(digits.shape[1:]))
        return RnsVal(self, self.reduce(out), Fraction(bound))

    def crt_digit_matrix(self, limb_bits: int = 11):
        """(n_cols, k) digits of M/m_i and (n_cols,) digits of M."""
        k = self.k
        mask = (1 << limb_bits) - 1
        top = (k + 1) * self.M
        n_cols = -(-top.bit_length() // limb_bits)
        W = np.zeros((n_cols, k), np.int64)
        for i, m in enumerate(self.mB):
            v = self.M // m
            for d in range(n_cols):
                W[d, i] = (v >> (limb_bits * d)) & mask
        mdig = np.asarray([(self.M >> (limb_bits * d)) & mask for d in range(n_cols)], np.int64)
        return W, mdig

    def to_digit_cols(self, a: RnsVal, limb_bits: int = 11):
        """EXACT CRT extraction: residues of V (< a.a * p) -> ((n_cols, *batch)
        int32 digit columns of V + k*M, per-column bounds)."""
        k = self.k
        res = a.res
        xi = self.reduce(res[:k].to(torch.int64) * self._const_bc("ifac1", self.ifac1_np, 0, k, res[:k]), 0, k)
        w = self._t("mfac_mr", lambda: self.mfac_mod_mr_np, res.device)
        s_r = torch.sum(xi.to(torch.int64) * self._bc(w, xi), dim=0) % self.mr
        d = s_r - res[2 * k].to(torch.int64)
        d = torch.where(d < 0, d + self.mr, d)
        alpha = (d * self.m_mod_mr_inv) % self.mr
        W, mdig = self.crt_digit_matrix(limb_bits)
        n_cols = W.shape[0]
        Wt = self._t(("crtW", limb_bits), lambda: W, res.device)
        mdt = self._t(("crtM", limb_bits), lambda: mdig, res.device)
        batch = tuple(xi.shape[1:])
        cols = int_matmul(Wt, xi.reshape(k, -1)).reshape((n_cols,) + batch)
        delta = (k - alpha)[None]  # 0 < delta <= k
        cols = (cols + delta * self._bc(mdt, cols)).to(torch.int32)
        # the reference's column bound (its int8 split sums ll + 64 mid + 4096 hh)
        blk = k * 63 * 63
        bound = blk + (blk << 6) + (blk << 12) + k * ((1 << limb_bits) - 1)
        assert bound < (1 << 31)
        return cols, (bound,) * n_cols

    def to_limb_mont(self, a: RnsVal, lf) -> torch.Tensor:
        """RNS M-residue of x -> limb Montgomery form (x * Rlimb mod p),
        canonical-digit lazy (< 2p): the bridge back to the limb pipeline."""
        from .limb import LazyCols

        c = RnsVal(self, self.encode_raw(lf.R * lf.R % self.p, like=a.res), Fraction(1))
        u = self.mul(a, c)
        cols, colhi = self.to_digit_cols(u)
        pad = 2 * lf.L - cols.shape[0]
        assert pad >= 0, "CRT columns exceed the limb REDC width"
        cols = torch.cat([cols, torch.zeros((pad,) + tuple(cols.shape[1:]), dtype=torch.int32,
                                            device=cols.device)], dim=0)
        r = LazyCols(lf, cols, colhi + (0,) * pad).reduce()
        corr = (self.k * self.M * pow(lf.R, -1, self.p)) % self.p
        return lf.sub(r, lf.const(corr, tuple(r.shape[1:]), mont=False, device=r.device))

    def __repr__(self) -> str:
        return f"RnsField({self.name}, k={self.k}, C={self.C})"
