"""The BLS12-381 pairing engine of the port.

Counterpart of bellman_mpc_tpu/groth16/engine.py and groth16/bls12.py:
protocol-level group elements are host affine points (tuples / None); the
bulk fixed-base batches of setup (`batch_mul`) and the sequential prover's
MSMs (`msm`) run as device ladders (ops/msm.py) on the engine's `device`.
Pairings take the reference's routes (bls12.py:110-158): a multi-Miller
loop of 4 or more terms is one device batch (ops/pairing.py) whose values
are multiplied on the host, fewer terms run on the host oracle
(curves/pairing_host.py); `pairing_product_is_one` is one device program
on a CUDA engine and the host loop on a CPU engine, as the reference's CPU
backend does.  The route depends on `device` alone: a CUDA engine without a
card raises.  The engine runs on the first CUDA card unless it is given
another device; constructing it does not touch the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..curves import pairing_host as ph
from ..curves.device import DeviceGroup, g1_device, g2_device
from ..fields import bls12_381 as bc
from ..fields.tower import FP12_ONE, fp12_eq, fp12_is_one, fp12_mul
from ..ops import pairing as dp
from ..ops import tower as dtw
from ..ops.msm import batch_mul_host, msm_host

_MSM_DEVICE_THRESHOLD = 4  # below this a host loop beats kernel dispatch


class _BlsGroup:
    """Group operation surface the protocol code is written against."""

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


class Bls12Engine:
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

    def pairing(self, p, q):
        return self.final_exponentiation(self.multi_miller_loop([(p, q)]))

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

    def prepare_g2(self, q):
        return q
