"""Limb-decomposed Montgomery field arithmetic on PyTorch tensors.

Port of bellman_mpc_tpu/fields/limb.py.  A field element is a vector of
``L`` 11-bit limbs held in int32, and a batch of elements is a tensor of
shape ``(L, *batch)`` — limbs first, the same layout as the JAX package, so
raw limb tensors compare bit for bit with the reference.

Representation invariants (unchanged):
  * limbs are canonical:   0 <= limb < 2^11   (int32 storage)
  * values are "lazy":     0 <= value < 2*p
  * unless stated otherwise values are in Montgomery form  x*R mod p.

Two carry strategies, as in the reference.  "flat" (the default on every
device): static carry folding plus a Hillis-Steele carry lookahead, a
handful of tensor ops per carry chain.  "scan" (BMT_CARRIES=scan): one
sequential pass over the limbs, a few tensor ops per limb (the reference's
lax.scan chains, its default on the XLA CPU backend).  BMT_CARRIES is read
at every call (`_flat_carries`), so it can be switched inside a process.
Every result is the unique canonical-digit representation of the same
value, so both strategies, here and in the reference, agree limb for limb.
`LimbField.mul` is the limb Montgomery kernel on a CUDA tensor under either
strategy; only the carry paths outside the multiply change.  Likewise the
lazy columns' product (`lazy_mul_many`) and reduction (`LazyCols.reduce`)
are one kernel launch each on a CUDA tensor (ops/mont_kernels.py).

Constants live on the CPU and are copied to a tensor's device on first use
there (no module-level device state).  The lazy columns' bound proofs are
pure functions of host tuples; each is worked out once per distinct bound
vector (`_product_hi`, `_fold_hi`, `_add_hi`, `_sub_plan`, `_reduce_plan`)
and its asserts hold for every call that reuses it.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernel_lib import plain_counts
from ..ops.mont_kernels import lazy_cols, lazy_redc, mont_mul

LIMB_BITS = 11
LIMB_MASK = (1 << LIMB_BITS) - 1


def _flat_carries() -> bool:
    """True for the loop-free carry strategy (the port's default on every
    device); BMT_CARRIES=scan selects the sequential one, =flat the flat
    one.  Read at call time."""
    return os.environ.get("BMT_CARRIES") != "scan"


def _shift_down(t: torch.Tensor, fill) -> torch.Tensor:
    """out[0] = fill, out[i] = t[i-1] along the limb axis."""
    head = torch.full_like(t[:1], fill)
    return torch.cat([head, t[:-1]], dim=0)


class LimbField:
    """Montgomery arithmetic over GF(p) on ``(L, *batch)`` int32 limb tensors."""

    def __init__(self, modulus: int, name: str = "F"):
        self.p = modulus
        self.name = name
        b = LIMB_BITS
        L = -(-(modulus.bit_length() + 6) // b)
        self.L = L
        self.nbytes = (b * L + 7) // 8
        self.R = 1 << (b * L)
        assert 64 * modulus <= self.R
        self.n0inv = (-pow(modulus, -1, 1 << b)) % (1 << b)
        self.r2 = (self.R * self.R) % modulus
        self._byte_idx = np.asarray([(b * i) // 8 for i in range(L)])
        self._bit_shift = np.asarray([(b * i) % 8 for i in range(L)])
        self._dmax_lazy = tuple(
            min(LIMB_MASK, (2 * modulus - 1) >> (b * i)) for i in range(L)
        )
        self._p_list = self._int_to_limbs(modulus)
        self._2p_list = self._int_to_limbs(2 * modulus)
        self.p0 = int(self._p_list[0])
        self._cache: Dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------------ utils
    def _int_to_limbs(self, v: int) -> List[int]:
        return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.L)]

    def _vec(self, values: Sequence[int], device) -> torch.Tensor:
        """Cached 1-D int32 constant on `device`."""
        key = (tuple(values), str(device))
        t = self._cache.get(key)
        if t is None:
            t = torch.tensor(key[0], dtype=torch.int32, device=device)
            self._cache[key] = t
        return t

    def _bc(self, const_1d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Broadcast an (n,)-shaped constant against an (n, *batch) tensor."""
        return const_1d.reshape((const_1d.shape[0],) + (1,) * (like.dim() - 1))

    def limbs_const(self, v: int, like: torch.Tensor) -> torch.Tensor:
        """(L, 1, ...) limbs of the host int v, broadcastable against `like`."""
        return self._bc(self._vec(self._int_to_limbs(v), like.device), like)

    def zeros(self, batch_shape: Tuple[int, ...] = (), device="cpu") -> torch.Tensor:
        return torch.zeros((self.L,) + tuple(batch_shape), dtype=torch.int32, device=device)

    def const(self, value: int, batch_shape: Tuple[int, ...] = (), mont: bool = True,
              device="cpu") -> torch.Tensor:
        """Broadcast a host integer constant to an (L, *batch) tensor."""
        v = value % self.p
        if mont:
            v = v * self.R % self.p
        c = self._vec(self._int_to_limbs(v), device)
        shape = (self.L,) + tuple(batch_shape)
        return c.reshape((self.L,) + (1,) * len(batch_shape)).expand(shape)

    def mont_one(self, batch_shape: Tuple[int, ...] = (), device="cpu") -> torch.Tensor:
        return self.const(1, batch_shape, mont=True, device=device)

    # ------------------------------------------------------- carry management
    def _fold(self, t: torch.Tensor, steps: int = 4) -> torch.Tensor:
        """Static carry folding: non-negative column sums < 2^30 become
        digits <= 4096 in `steps` rounds.  The top carry is provably zero."""
        for _ in range(steps):
            t = (t & LIMB_MASK) + _shift_down(t >> LIMB_BITS, 0)
        return t

    @staticmethod
    def _carry_scan(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix of the carry/borrow monoid along the limb axis
        (log2(L) shift-combine steps)."""
        n = g.shape[0]
        shift = 1
        while shift < n:
            g_lo = torch.cat([torch.zeros_like(g[:shift]), g[:-shift]], dim=0)
            p_lo = torch.cat([torch.ones_like(p[:shift]), p[:-shift]], dim=0)
            g = g | (p & g_lo)
            p = p & p_lo
            shift *= 2
        return g

    def _normalize(self, t: torch.Tensor) -> torch.Tensor:
        """Digits <= 4096 -> canonical digits < 2^11 (same value)."""
        carry_out = self._carry_scan(t >= (1 << LIMB_BITS), t == LIMB_MASK)
        carry_in = _shift_down(carry_out, False).to(torch.int32)
        return (t + carry_in) & LIMB_MASK

    def _sub_flat(self, x: torch.Tensor, m: torch.Tensor):
        """x - m with borrow lookahead; returns (diff digits, total_borrow)."""
        if m.dim() == 1:
            m = self._bc(m, x)
        d = x - m
        borrow_out = self._carry_scan(d < 0, d == 0)
        borrow_in = _shift_down(borrow_out, False).to(torch.int32)
        return (d - borrow_in) & LIMB_MASK, borrow_out[-1]

    def propagate(self, t: torch.Tensor) -> torch.Tensor:
        """Sequential carry propagation along the limb axis.  Accepts limbs
        in (-2^31, 2^31) (arithmetic >> floors, so negative ones borrow);
        the represented value must fit the limb count."""
        carry = torch.zeros_like(t[0])
        out = torch.empty_like(t)
        for i in range(t.shape[0]):
            v = t[i] + carry
            carry = v >> LIMB_BITS
            out[i] = v & LIMB_MASK
        return out

    def _sub_scan(self, x: torch.Tensor, m: torch.Tensor):
        """x - m with a sequential borrow chain (the scan strategy); returns
        (diff digits, total_borrow)."""
        if m.dim() == 1:
            m = self._bc(m, x)
        carry = torch.zeros(torch.broadcast_shapes(x.shape[1:], m.shape[1:]), dtype=torch.int32,
                            device=x.device)
        d = torch.empty((x.shape[0],) + tuple(carry.shape), dtype=torch.int32, device=x.device)
        for i in range(x.shape[0]):
            v = x[i] - m[i] + carry
            carry = v >> LIMB_BITS
            d[i] = v & LIMB_MASK
        return d, carry != 0

    def _cond_sub(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """Subtract the (L,) constant m when x >= m (branch-free)."""
        sub = self._sub_flat if _flat_carries() else self._sub_scan
        d, borrow = sub(x, m)
        return torch.where(borrow, x, d)

    def _scan_reduce2(self, t: torch.Tensor) -> torch.Tensor:
        """One sequential pass computing the digits of t and of t - 2p;
        t - 2p where it is non-negative (the scan strategy's add/sub/neg)."""
        m = self._bc(self._2p(t.device), t)
        c1 = torch.zeros_like(t[0])
        c2 = torch.zeros_like(t[0])
        d1 = torch.empty_like(t)
        d2 = torch.empty_like(t)
        for i in range(t.shape[0]):
            v1 = t[i] + c1
            v2 = t[i] - m[i] + c2
            c1, c2 = v1 >> LIMB_BITS, v2 >> LIMB_BITS
            d1[i] = v1 & LIMB_MASK
            d2[i] = v2 & LIMB_MASK
        return torch.where(c2 == 0, d2, d1)

    def _p(self, device) -> torch.Tensor:
        return self._vec(self._p_list, device)

    def _2p(self, device) -> torch.Tensor:
        return self._vec(self._2p_list, device)

    # ------------------------------------------------------------- arithmetic
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not _flat_carries():
            return self._scan_reduce2(a + b)
        t = self._normalize(self._fold(a + b, steps=1))
        return self._cond_sub(t, self._2p(t.device))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not _flat_carries():
            return self._scan_reduce2(a - b + self._bc(self._2p(a.device), a))
        # a + (2p - b); b < 2p so the inner subtraction never borrows.
        twop = self._bc(self._2p(b.device), b).expand(b.shape)
        nb, _ = self._sub_flat(twop, b)
        return self.add(a, nb)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        if not _flat_carries():
            return self._scan_reduce2(self._bc(self._2p(a.device), a) - a)
        twop = self._bc(self._2p(a.device), a).expand(a.shape)
        t, _ = self._sub_flat(twop, a)
        return self._cond_sub(t, self._2p(a.device))

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul_cols(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Schoolbook product columns of a*b: (L, *B) x2 -> (2L, *B) int32.

        cols[c] = sum_{i+j=c} a_i * b_j <= L * (2^11-1)^2 < 2^27.2."""
        L = self.L
        a, b = torch.broadcast_tensors(a, b)
        t = torch.zeros((2 * L,) + tuple(a.shape[1:]), dtype=torch.int32, device=a.device)
        for i in range(L):
            t[i : i + L] += a[i] * b
        return t

    def redc_cols(self, t: torch.Tensor, fold_steps: int = 4) -> torch.Tensor:
        """Word-by-word Montgomery reduction of (2L, *B) non-negative columns.

        Returns canonical-digit limbs of (T + m*p)/R; callers guarantee
        T < p*R so the output is lazy (< 2p)."""
        L = self.L
        t = t.clone()
        p_rest = self._bc(self._vec(self._p_list[1:], t.device), t[: L - 1])
        carry = torch.zeros_like(t[0])
        for i in range(L):
            ti = t[i] + carry
            m = ((ti & LIMB_MASK) * self.n0inv) & LIMB_MASK
            carry = (ti + m * self.p0) >> LIMB_BITS
            t[i + 1 : i + L] += m * p_rest
        r = t[L:].clone()
        r[0] += carry
        if not _flat_carries():
            return self.propagate(r)
        return self._normalize(self._fold(r, steps=fold_steps))

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b*R^{-1} mod p (lazy in, lazy out): the K4
        kernel on CUDA tensors, `mul_plain` on CPU tensors (equal limbs)."""
        return mont_mul(self, a, b)

    def mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """K4's plain version: product columns, then `redc_cols`."""
        if a.is_cuda or b.is_cuda:
            plain_counts["mont_mul"] += 1
        return self.redc_cols(self.mul_cols(a, b))

    def lazy_cols_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """K5's plain version: `mul_cols`."""
        if a.is_cuda or b.is_cuda:
            plain_counts["lazy_cols"] += 1
        return self.mul_cols(a, b)

    def lazy_redc_plain(self, cols: torch.Tensor, plan: Tuple[int, int]) -> torch.Tensor:
        """K6's plain version: `_reduce_plan`'s carry folds, then `redc_cols`
        with its fold steps after."""
        if cols.is_cuda:
            plain_counts["lazy_redc"] += 1
        folds, steps = plan
        return self.redc_cols(self._fold(cols, folds), fold_steps=steps)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_const(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """Multiply by a host integer constant (Montgomery-encoded on the fly)."""
        return self.mul(a, self.limbs_const(c % self.p * self.R % self.p, a))

    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a host integer exponent (left-to-right binary ladder; the
        reference's multiply sequence, minus the products it discards)."""
        r = self.mont_one(tuple(a.shape[1:]), a.device)
        if e == 0:
            return r
        for bit in bin(e)[2:]:
            r = self.mul(r, r)
            if bit == "1":
                r = self.mul(r, a)
        return r

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Batched Fermat inversion a^(p-2); maps 0 -> 0 (caller checks)."""
        return self.pow_const(a, self.p - 2)

    # ------------------------------------------------------------ comparisons
    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """Reduce from lazy [0,2p) to canonical [0,p)."""
        return self._cond_sub(a, self._p(a.device))

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.all(self.canon(a) == self.canon(b), dim=0)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return torch.all(self.canon(a) == 0, dim=0)

    def select(self, cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """cond ? a : b with cond shaped like the batch."""
        return torch.where(cond[None], a, b)

    # ------------------------------------------------- Montgomery conversions
    def to_mont(self, a_std: torch.Tensor) -> torch.Tensor:
        return self.mul(a_std, self.limbs_const(self.r2, a_std))

    def from_mont(self, a_mont: torch.Tensor) -> torch.Tensor:
        return self.canon(self.mul(a_mont, self.limbs_const(1, a_mont)))

    # ----------------------------------------------------------- host codecs
    def encode(self, values: Sequence[int], mont: bool = True, device="cpu") -> torch.Tensor:
        """Host ints -> (L, N) int32 tensor (vectorized bit extraction)."""
        p = self.p
        if mont:
            R = self.R
            values = [v % p * R % p for v in values]
        else:
            values = [v % p for v in values]
        n = len(values)
        raw = b"".join(v.to_bytes(self.nbytes, "little") for v in values)
        u = np.frombuffer(raw, np.uint8).reshape(n, self.nbytes)
        u = np.concatenate([u, np.zeros((n, 2), np.uint8)], axis=1)
        j = self._byte_idx
        chunk = (
            u[:, j].astype(np.int32)
            + (u[:, j + 1].astype(np.int32) << 8)
            + (u[:, j + 2].astype(np.int32) << 16)
        )
        limbs = (chunk >> self._bit_shift) & LIMB_MASK
        return torch.from_numpy(np.ascontiguousarray(limbs.T.astype(np.int32))).to(device)

    def decode(self, arr: torch.Tensor, mont: bool = True) -> List[int]:
        """(L, *batch) tensor -> list of host ints (canonical, std form)."""
        a = self.from_mont(arr) if mont else self.canon(arr)
        flat = a.reshape(self.L, -1).T.cpu().numpy().astype(np.int64)
        n = flat.shape[0]
        buf = np.zeros((n, self.nbytes + 2), np.int64)
        for i in range(self.L):
            v = flat[:, i] << int(self._bit_shift[i])
            j = int(self._byte_idx[i])
            buf[:, j] += v & 0xFF
            buf[:, j + 1] += (v >> 8) & 0xFF
            buf[:, j + 2] += v >> 16
        raw = buf[:, : self.nbytes].astype(np.uint8).tobytes()
        nb = self.nbytes
        return [int.from_bytes(raw[i * nb : (i + 1) * nb], "little") for i in range(n)]

    def decode_one(self, arr: torch.Tensor, mont: bool = True) -> int:
        return self.decode(arr.reshape(self.L, 1), mont=mont)[0]

    def pack_std(self, values: Sequence[int]) -> np.ndarray:
        """Host ints -> (N, nbytes) uint8 (standard form, minimal wire size)."""
        p = self.p
        raw = b"".join((v % p).to_bytes(self.nbytes, "little") for v in values)
        return np.frombuffer(raw, np.uint8).reshape(len(values), self.nbytes)

    def unpack_device(self, u8: torch.Tensor) -> torch.Tensor:
        """(N, nbytes) uint8 tensor -> (L, N) canonical std-form limbs."""
        u = torch.nn.functional.pad(u8, (0, 2)).to(torch.int32)
        j = torch.as_tensor(self._byte_idx, dtype=torch.long, device=u8.device)
        chunk = u[:, j] | (u[:, j + 1] << 8) | (u[:, j + 2] << 16)
        shifts = torch.as_tensor(self._bit_shift, dtype=torch.int32, device=u8.device)
        return ((chunk >> shifts) & LIMB_MASK).T.contiguous()

    def __repr__(self) -> str:
        return f"LimbField({self.name}, L={self.L}, bits={self.p.bit_length()})"

    # -------------------------------------------------- lazy column reduction
    def lazy_mul_many(
        self,
        pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        dmax_pairs: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None,
    ) -> List["LazyCols"]:
        """k unreduced products through ONE stacked product loop (operands
        may be raw digit-wise sums, as long as their bounds say so)."""
        k = len(pairs)
        if dmax_pairs is None:
            dmax_pairs = [(self._dmax_lazy, self._dmax_lazy)] * k
        lhs = torch.stack([a for a, _ in pairs], dim=1)
        rhs = torch.stack([b for _, b in pairs], dim=1)
        cols = lazy_cols(self, lhs, rhs)  # (2L, k, *B): K5 on a CUDA tensor
        return [LazyCols(self, cols[:, i], _product_hi(tuple(da), tuple(db)))
                for i, (da, db) in enumerate(dmax_pairs)]

    def lazy_mul(self, a, b, da=None, db=None) -> "LazyCols":
        d = self._dmax_lazy
        return self.lazy_mul_many([(a, b)], [(da or d, db or d)])[0]

    def lazy_reduce_many(self, lcs: Sequence["LazyCols"], wide: bool = False) -> List[torch.Tensor]:
        """Reduce k LazyCols through ONE stacked Montgomery reduction."""
        cols = torch.stack([lc.cols for lc in lcs], dim=1)
        hi = _max_hi(tuple(lc.hi for lc in lcs))
        r = LazyCols(self, cols, hi).reduce(wide=wide)
        return [r[:, i] for i in range(len(lcs))]

    def fold_digits(self, arr: torch.Tensor, dvec: Tuple[int, ...]):
        """One value-preserving carry fold of an (L, *B) digit tensor (the
        value must fit L limbs, so the top carry is zero)."""
        assert len(dvec) == self.L
        arr = (arr & LIMB_MASK) + _shift_down(arr >> LIMB_BITS, 0)
        return arr, _fold_hi(tuple(dvec), 1)


class LazyFp2:
    """Unreduced Fp2 value: a pair of LazyCols (Karatsuba re/im columns)."""

    __slots__ = ("re", "im")

    def __init__(self, re: "LazyCols", im: "LazyCols"):
        self.re = re
        self.im = im

    def __add__(self, o: "LazyFp2") -> "LazyFp2":
        return LazyFp2(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "LazyFp2") -> "LazyFp2":
        return LazyFp2(self.re - o.re, self.im - o.im)

    def scale(self, k: int) -> "LazyFp2":
        return LazyFp2(self.re.scale(k), self.im.scale(k))

    def __rmul__(self, k: int) -> "LazyFp2":
        return self.scale(k)

    def mul_by_xi(self) -> "LazyFp2":
        """Times xi = 1 + u: the integer column combine (re - im, re + im)."""
        return LazyFp2(self.re - self.im, self.re + self.im)


class LazyCols:
    """Unreduced Montgomery product columns with host-side bound proofs.

    Represents T = sum_i cols[i] * 2^(11 i) with 0 <= cols[i] <= hi[i]
    (hi tracked exactly on the host, as in the reference)."""

    __slots__ = ("f", "cols", "hi")

    def __init__(self, f: LimbField, cols: torch.Tensor, hi: Tuple[int, ...]):
        self.f = f
        self.cols = cols
        self.hi = hi

    def fold(self, steps: int = 1) -> "LazyCols":
        cols = self.cols
        for _ in range(steps):
            cols = (cols & LIMB_MASK) + _shift_down(cols >> LIMB_BITS, 0)
        return LazyCols(self.f, cols, _fold_hi(self.hi, steps))

    def _folded_to(self, limit: int) -> "LazyCols":
        out = self
        while max(out.hi) > limit:
            out = out.fold()
        return out

    def __add__(self, other: "LazyCols") -> "LazyCols":
        a, b = self, other
        hi = _add_hi(a.hi, b.hi)
        if hi is None:
            a = a._folded_to(1 << 29)
            b = b._folded_to(1 << 29)
            hi = _add_hi(a.hi, b.hi)
        return LazyCols(a.f, a.cols + b.cols, hi)

    def __sub__(self, other: "LazyCols") -> "LazyCols":
        f = self.f
        me, oth = self, other
        plan = _sub_plan(f, me.hi, oth.hi)
        if plan is None:
            me = me._folded_to(1 << 28)
            oth = oth._folded_to(1 << 28)
            plan = _sub_plan(f, me.hi, oth.hi)
        q, hi = plan
        qa = f._bc(f._vec(q, me.cols.device), me.cols)
        return LazyCols(f, me.cols - oth.cols + qa, hi)

    def scale(self, k: int) -> "LazyCols":
        assert k >= 0
        out = self if k == 0 else self._folded_to(((1 << 31) - 1) // k)
        return LazyCols(out.f, out.cols * k, _scale_hi(out.hi, k))

    def __rmul__(self, k: int) -> "LazyCols":
        return self.scale(k)

    def reduce(self, wide: bool = False) -> torch.Tensor:
        """ONE Montgomery reduction -> lazy element (<2p, canonical digits),
        with the reference's host-side proof obligations (value bound, int32
        REDC growth, fold schedule)."""
        plan = _reduce_plan(self.f, self.hi, wide)
        # wide=True admits T < 3pR (REDC output < 4p); like the reference,
        # no conditional subtraction follows, so raw limbs stay identical.
        return lazy_redc(self.f, self.cols, plan)  # K6 on a CUDA tensor


# ------------------------------------------------ host-side bound proofs
# Pure functions of the tracked bound tuples: one evaluation (asserts
# included) per distinct bound vector, shared by every later call.
_BOUND_CACHE = 1 << 14


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _product_hi(da: Tuple[int, ...], db: Tuple[int, ...]) -> Tuple[int, ...]:
    """Column bounds of the product of two digit vectors (2L columns)."""
    hi = tuple(int(x) for x in np.convolve(
        np.asarray(da, object), np.asarray(db, object)
    )) + (0,)
    assert max(hi) < (1 << 31), "product columns overflow int32"
    return hi


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _fold_hi(hi: Tuple[int, ...], steps: int) -> Tuple[int, ...]:
    """Column bounds after `steps` carry folds (the value must fit the
    columns, so the top carry is zero)."""
    b = LIMB_BITS
    n = len(hi)
    assert sum(h << (b * i) for i, h in enumerate(hi)) < 1 << (b * n)
    out = list(hi)
    for _ in range(steps):
        out = [min(out[i], LIMB_MASK) + (out[i - 1] >> b if i else 0) for i in range(n)]
    return tuple(out)


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _max_hi(his: Tuple[Tuple[int, ...], ...]) -> Tuple[int, ...]:
    """Column-wise maximum of several bound vectors (a stacked reduction)."""
    return tuple(max(col) for col in zip(*his))


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _scale_hi(hi: Tuple[int, ...], k: int) -> Tuple[int, ...]:
    """Bounds of the columns times k."""
    return tuple(h * k for h in hi)


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _add_hi(a: Tuple[int, ...], b: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
    """Bounds of a column sum, or None when it could overflow int32."""
    hi = tuple(x + y for x, y in zip(a, b))
    return None if max(hi) >= (1 << 31) else hi


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _sub_plan(f: LimbField, me: Tuple[int, ...], oth: Tuple[int, ...]):
    """(offset Q, result bounds) of a column difference, or None when the
    operands must be folded first.  Q = 0 (mod p) and its columns dominate
    oth, so the difference stays non-negative."""
    b = LIMB_BITS
    if max(x + 2 * y for x, y in zip(me, oth)) >= (1 << 31) - (1 << 12):
        return None
    v = sum(h << (b * i) for i, h in enumerate(oth))
    corr = (-v) % f.p
    q = list(oth)
    for i in range(f.L):
        q[i] += (corr >> (b * i)) & LIMB_MASK
    return tuple(q), tuple(a + qi for a, qi in zip(me, q))


@functools.lru_cache(maxsize=_BOUND_CACHE)
def _reduce_plan(f: LimbField, hi: Tuple[int, ...], wide: bool) -> Tuple[int, int]:
    """(carry folds before the REDC, fold steps after it) for columns with
    bounds hi: checks the value bound T < pR (3pR when wide), folds until
    every intermediate of the REDC recurrence provably fits int32, then
    counts the folds that bring its output digits to <= 4094."""
    b = LIMB_BITS
    L = f.L
    T = sum(h << (b * i) for i, h in enumerate(hi))
    limit = 3 * f.p * f.R if wide else f.p * f.R
    assert T < limit, "lazy accumulation exceeds the REDC value bound"

    def _simulate(hi):
        w = list(hi)
        carry = 0
        for i in range(L):
            ti = w[i] + carry
            peak = ti + LIMB_MASK * f.p0
            if peak >= (1 << 31):
                return None
            carry = peak >> b
            for j in range(1, L):
                w[i + j] += LIMB_MASK * f._p_list[j]
                if w[i + j] >= (1 << 31):
                    return None
        r_hi = w[L:] + [0]
        r_hi[0] += carry
        return r_hi

    folds = 0
    r_hi = _simulate(hi)
    while r_hi is None:
        hi = _fold_hi(hi, 1)
        folds += 1
        r_hi = _simulate(hi)
    h = max(r_hi)
    steps = 0
    while h > 4094:
        h = LIMB_MASK + (h >> b)
        steps += 1
    return folds, max(steps, 1)
