"""Pairing engines of the port: the protocol's group and pairing surface.

Copy of bellman_mpc_tpu/groth16/engine.py and groth16/bls12.py on PyTorch.
`GroupAPI` and `Engine` are the surface the protocol code (setup, prover,
verifiers, the ceremony) is written against, as the reference's
`pairing::Engine` traits are in bellman.  Two engines:

  * `DummyEngine` - the mock engine over GF(64513), with G1 = G2 = Gt = Fr
    and the pairing a field product (bellman/src/groth16/tests/
    dummy_engine.rs:331-374).  Its groups are host ints; its field's iFFT
    and h(x) pipeline run on the engine's `device` (limbs of L = 2).
  * `Bls12Engine` - BLS12-381.  Protocol-level group elements are host
    affine points (tuples / None); the bulk fixed-base batches of setup and
    the ceremony (`batch_mul`), the sequential prover's MSMs (`msm`) and
    the ceremony's Lagrange transform (`intt`, above 4 points) run as device
    ladders (ops/msm.py, ops/group_ntt.py) on the engine's `device`.
    Pairings take the reference's routes (bls12.py:110-158): a multi-Miller
    loop of 4 or more terms is one device batch (ops/pairing.py) whose
    values are multiplied on the host, fewer terms run on the host oracle
    (curves/pairing_host.py); `pairing_product_is_one` is one device
    program on a CUDA engine and the host loop on a CPU engine, as the
    reference's CPU backend does.

The route depends on `device` alone: a CUDA engine without a card raises.
Both engines run on the first CUDA card unless they are given another
device; constructing one does not touch the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..curves import pairing_host as ph
from ..curves.device import DeviceGroup, g1_device, g2_device
from ..fields import bls12_381 as bc
from ..fields.host import PrimeField
from ..fields.limb import LimbField
from ..fields.mock import mock, mock_host
from ..fields.tower import FP12_ONE, fp12_eq, fp12_is_one, fp12_mul
from ..ops import pairing as dp
from ..ops import tower as dtw
from ..ops.domain import _bitrev_indices
from ..ops.group_ntt import group_ntt
from ..ops.msm import batch_mul_host, msm_host


class GroupAPI:
    """Group operation surface the protocol code is written against."""

    name: str

    def identity(self):
        raise NotImplementedError

    def generator(self):
        raise NotImplementedError

    def is_identity(self, p) -> bool:
        raise NotImplementedError

    def add(self, p, q):
        raise NotImplementedError

    def neg(self, p):
        raise NotImplementedError

    def mul(self, p, k: int):
        raise NotImplementedError

    def eq(self, p, q) -> bool:
        raise NotImplementedError

    def batch_mul(self, base, exps: Sequence[int]) -> List:
        """[base * e for e in exps] (replaces generator.rs:311-328's wNAF)."""
        return [self.mul(base, e) for e in exps]

    def msm(self, bases: Sequence, scalars: Sequence[int],
            density: Optional[Sequence[bool]] = None):
        """sum_i scalars[i] * bases[j(i)] under the density contract of
        multiexp.rs:88-157: with a density, scalar i consumes the next base
        only where density[i] is set.  Zero scalars are skipped."""
        acc = self.identity()
        j = 0
        for i, s in enumerate(scalars):
            if density is not None and not density[i]:
                continue
            base = bases[j]
            j += 1
            if s == 0:
                continue
            acc = self.add(acc, self.mul(base, s))
        return acc

    def intt(self, points: Sequence, host: PrimeField) -> List:
        """Inverse NTT over group elements (radix-2, a power-of-two length):
        intt([tau^i G]) == [L_j(tau) G] without anyone knowing tau, the
        Lagrange transform of a powers-of-tau ceremony (the group instance
        of bellman/src/domain.rs:192-259).  Host Cooley-Tukey here; the
        BLS12-381 groups run it on the device above 4 points."""
        n = len(points)
        exp = n.bit_length() - 1
        assert 1 << exp == n, "group iNTT length must be a power of two"
        if n == 1:
            return list(points)
        omega = host.inv(host.nth_root_of_unity(exp))
        x = [points[r] for r in _bitrev_indices(n)]
        for s in range(1, exp + 1):
            m = 1 << s
            half = m >> 1
            step = n >> s
            for base in range(0, n, m):
                for j in range(half):
                    w = pow(omega, step * j, host.p)
                    u = x[base + j]
                    v = self.mul(x[base + j + half], w)
                    x[base + j] = self.add(u, v)
                    x[base + j + half] = self.add(u, self.neg(v))
        n_inv = host.inv(n)
        return [self.mul(p, n_inv) for p in x]


class Engine:
    """A pairing engine: scalar field, two source groups, the pairing."""

    name: str
    device: torch.device
    fr_host: PrimeField
    fr: LimbField
    g1: GroupAPI
    g2: GroupAPI

    def pairing(self, p, q):
        return self.final_exponentiation(self.multi_miller_loop([(p, q)]))

    def multi_miller_loop(self, terms: Sequence[Tuple[object, object]]):
        raise NotImplementedError

    def final_exponentiation(self, ml):
        raise NotImplementedError

    def gt_eq(self, a, b) -> bool:
        raise NotImplementedError

    def gt_is_one(self, a) -> bool:
        """Is `a` the identity of Gt (E::Gt::identity())."""
        raise NotImplementedError

    def pairing_product_is_one(self, terms: Sequence[Tuple[object, object]]) -> bool:
        """prod_i e(p_i, q_i) == 1, the shape both verifiers reduce to
        (verifier.rs:49-56, verifier/batch.rs:164-168)."""
        return self.gt_is_one(self.final_exponentiation(self.multi_miller_loop(terms)))

    def prepare_g2(self, q):
        """Hook mirroring G2Prepared (the identity transform)."""
        return q


# ----------------------------------------------------------------- DummyEngine
class _DummyGroup(GroupAPI):
    """G = (Fr, +) with 'scalar mul' = field mul (dummy_engine.rs:376-418)."""

    def __init__(self, host: PrimeField, name: str):
        self.host = host
        self.name = name

    def identity(self):
        return 0

    def generator(self):
        return 1

    def is_identity(self, p) -> bool:
        return p % self.host.p == 0

    def add(self, p, q):
        return (p + q) % self.host.p

    def neg(self, p):
        return (-p) % self.host.p

    def mul(self, p, k: int):
        return p * (k % self.host.p) % self.host.p

    def eq(self, p, q) -> bool:
        return (p - q) % self.host.p == 0


class DummyEngine(Engine):
    """Mock engine over GF(64513); pairing(a, b) = a*b (dummy_engine.rs:344-365).
    The mock field's iFFT and h(x) pipeline run on `device`."""

    name = "dummy"

    def __init__(self, device="cuda:0"):
        self.device = torch.device(device)
        self.fr_host = mock_host
        self.fr = mock
        self.g1 = _DummyGroup(mock_host, "G1")
        self.g2 = _DummyGroup(mock_host, "G2")

    def multi_miller_loop(self, terms):
        return sum(a * b for a, b in terms) % self.fr_host.p

    def final_exponentiation(self, ml):
        return ml

    def gt_eq(self, a, b) -> bool:
        return (a - b) % self.fr_host.p == 0

    def gt_is_one(self, a) -> bool:
        # Dummy Gt is (Fr, +): its identity is 0 (dummy_engine.rs Group impl).
        return a % self.fr_host.p == 0


DUMMY = DummyEngine()


# ----------------------------------------------------------------- BLS12-381
_MSM_DEVICE_THRESHOLD = 4  # below this a host loop beats kernel dispatch


class _BlsGroup(GroupAPI):
    """A BLS12-381 source group: host points, device batches."""

    def __init__(self, device_group: DeviceGroup, name: str, device):
        self.device_group = device_group
        self.hostg = device_group.host
        self.name = name
        self.device = torch.device(device)

    def identity(self):
        return None

    def generator(self):
        return self.hostg.generator

    def is_identity(self, p) -> bool:
        return p is None

    def add(self, p, q):
        return self.hostg.add(p, q)

    def neg(self, p):
        return self.hostg.neg(p)

    def mul(self, p, k: int):
        return self.hostg.mul(p, k)

    def eq(self, p, q) -> bool:
        return self.hostg.eq(p, q)

    def batch_mul(self, base, exps: Sequence[int]) -> List:
        """[base * e for e in exps] (replaces generator.rs:311-328's wNAF)."""
        if base is None:
            return [None] * len(exps)
        if len(exps) < _MSM_DEVICE_THRESHOLD:
            return [self.mul(base, e) for e in exps]
        return batch_mul_host(self.device_group, base, [e % bc.R for e in exps], self.device)

    def intt(self, points, host):
        """Group iNTT (GroupAPI.intt): the host butterflies at 4 points or
        fewer, above that one device ladder per stage (ops/group_ntt.py)."""
        if len(points) <= 4:  # host butterflies beat a device dispatch
            return super().intt(points, host)
        dg = self.device_group
        enc = dg.encode_points(list(points), self.device)
        return dg.decode_points(group_ntt(dg.ops, host, enc, inverse=True))

    def msm(self, bases, scalars, density: Optional[Sequence[bool]] = None):
        """sum_i scalars[i] * bases[j(i)] under the density contract of
        multiexp.rs:88-157: with a density, scalar i consumes the next base
        only where density[i] is set.  Zero scalars are skipped."""
        dense_bases, dense_scalars = [], []
        j = 0
        for i, s in enumerate(scalars):
            if density is not None and not density[i]:
                continue
            b = bases[j]
            j += 1
            s = s % bc.R
            if s == 0:
                continue
            dense_bases.append(b)
            dense_scalars.append(s)
        if not dense_bases:
            return None
        if len(dense_bases) < _MSM_DEVICE_THRESHOLD:
            acc = None
            for b, s in zip(dense_bases, dense_scalars):
                acc = self.add(acc, self.mul(b, s))
            return acc
        return msm_host(self.device_group, dense_bases, dense_scalars, self.device)


class Bls12Engine(Engine):
    """BLS12-381: scalar field, the two source groups, the pairing."""

    name = "bls12_381"

    def __init__(self, device="cuda:0"):
        self.device = torch.device(device)
        self.fr_host = bc.fr_host
        self.fr = bc.fr
        self.g1 = _BlsGroup(g1_device, "G1", device)
        self.g2 = _BlsGroup(g2_device, "G2", device)

    def multi_miller_loop(self, terms: Sequence[Tuple[object, object]]):
        """prod_i f_{Q_i}(P_i): at 4 or more terms all Miller loops run as
        one device batch and their values are multiplied on the host."""
        terms = [(p, q) for p, q in terms if p is not None and q is not None]
        if len(terms) < _MSM_DEVICE_THRESHOLD:
            return ph.multi_miller_loop(terms)
        m = dp._bucket(len(terms))
        enc = dp.encode_pairs([t[0] for t in terms], [t[1] for t in terms], m, self.device)
        acc = FP12_ONE
        for v in dtw.fp12_decode(dp.miller_loop_batch(*enc))[: len(terms)]:
            acc = fp12_mul(acc, v)
        return acc

    def final_exponentiation(self, ml):
        return ph.final_exponentiation(ml)

    def pairing_product_is_one(self, terms) -> bool:
        """prod_i e(p_i, q_i) == 1 (verifier.rs:49-56 shape): one device
        program (ops/pairing.pairing_product_is_one) on a CUDA engine, the
        host loop on a CPU engine."""
        terms = [(p, q) for p, q in terms if p is not None and q is not None]
        if not terms:
            return True
        if self.device.type != "cuda":
            return self.gt_is_one(ph.final_exponentiation(ph.multi_miller_loop(terms)))
        return dp.pairing_product_is_one(
            [t[0] for t in terms], [t[1] for t in terms], self.device)

    def gt_eq(self, a, b) -> bool:
        return fp12_eq(a, b)

    def gt_is_one(self, a) -> bool:
        return fp12_is_one(a)
