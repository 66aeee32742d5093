"""Batched Groth16 proving on PyTorch tensors.

Port of bellman_mpc_tpu/parallel/batch_prover.py:

    (a, b, c) per-constraint evaluations   (L, B, m) Montgomery limbs
      -> h(x) coset pipeline               (7 NTT passes, groth16/prover.py)
      -> bit / window-digit decomposition of h and the witness scalars
      -> 5 MSMs against the CRS base sets (four on G1: h, l, a, b1; b2 on G2)
      -> proof assembly with limb point ops (curves/device.py), batched
         to-affine on decode.

The MSM strategy is fixed at construction (`msm_strategy`):
  * "rns": bucket tables in padded RNS form, every window of the four G1
    MSMs one K1 launch and every window of the G2 MSM one K2 launch
    (ops/fold_kernels.py), then the tree reduction and the RNS -> limb
    bridge;
  * "table": limb bucket tables, signed digits over affine tables
    (`msm_table_affine`), or under BMT_TABLE_SIGNED=0 unsigned digits over
    projective tables (`msm_table`);
  * "pippenger" and "flatpip": the bucket method per window, or in one flat
    pass over bases shifted once at build time (window width `pippenger_c`);
    base sets under 16 take the ladder;
  * "ladder": per-proof double-and-add over the bases, then a tree sum;
  * "auto" (the default): "rns" on a CUDA engine, "ladder" on the CPU, the
    reference's rule keyed on the engine's device.
The limb strategies return limb points straight to the proof assembly.
Density bookkeeping is resolved at build time from a template synthesis;
the input-wire queries ride the aux queries' power-of-two padding, as in the
reference (8 MSMs collapse to 5).  The table window width follows the
reference: BMT_TABLE_C, else `pick_table_c` under BMT_TABLE_MEM_MB for
signed tables on the card, else 4.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..curves.device import (
    g1_device,
    g2_device,
    point_add,
    scalar_mul_bits,
    scalar_mul_const,
    tree_reduce,
)
from ..curves.rns_point import default_rns_field, rns_g1_ops, rns_g2_ops
from ..fields import bls12_381 as bc
from ..fields.limb import LIMB_BITS, LimbField
from ..groth16.prover import DETERMINISTIC_R, DETERMINISTIC_S, _h_pipeline, synthesize_witness
from ..groth16.types import Parameters, Proof
from ..ops.domain import domain_size_for, warm_twiddles
from ..ops.fold_kernels import pad_rns_table
from ..ops.msm import (
    digits_from_bits,
    msm_flat_pippenger,
    msm_pippenger_batched,
    msm_table,
    msm_table_affine,
    msm_table_affine_rns,
    pick_table_c,
    shifted_bases,
    signed_digits,
    tables_to_rns,
    window_tables,
    window_tables_affine,
)
from ..r1cs.core import Circuit

NBITS = 255  # Fr scalar bits
STRATEGIES = ("rns", "table", "pippenger", "flatpip", "ladder")
# the reference's opt-ins that the port does not have yet (variable, value)
_UNPORTED = (("BMT_GLV", "1"), ("BMT_MERGE_G1", "1"), ("BMT_STACK_MSMS", "1"), ("BMT_CARRIES", "scan"))


def bits_from_std(field: LimbField, std: torch.Tensor) -> torch.Tensor:
    """(L, *S) canonical std-form limbs -> (NBITS, *S) bits, MSB first."""
    shifts = torch.arange(LIMB_BITS, dtype=torch.int32, device=std.device).reshape(
        (1, LIMB_BITS) + (1,) * (std.dim() - 1))
    bits = (std[:, None] >> shifts) & 1  # (L, b, *S) LSB-first per limb
    flat = bits.reshape((field.L * LIMB_BITS,) + tuple(std.shape[1:]))
    return torch.flip(flat[:NBITS], dims=[0])


def std_from_mont(field: LimbField, x: torch.Tensor) -> torch.Tensor:
    """(L, *S) Montgomery limbs -> canonical std-form digits."""
    return field.canon(field.mul(x, field.limbs_const(1, x)))


def bits_from_mont(field: LimbField, x: torch.Tensor) -> torch.Tensor:
    return bits_from_std(field, std_from_mont(field, x))


def _pad_pow2_int(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m *= 2
    return m


class BatchProver:
    """Per-(circuit, params) batched prover (MSM strategies: module doc)."""

    def __init__(self, engine, params: Parameters, circuit_template: Circuit,
                 msm_strategy: str = "auto", pippenger_c: int = 8, mesh=None):
        if mesh is not None:
            raise NotImplementedError("mesh= is not ported yet (ROADMAP.md A4b)")
        for var, val in _UNPORTED:
            if os.environ.get(var) == val:
                raise NotImplementedError(f"{var}={val} is not ported yet (ROADMAP.md A4b)")
        assert engine.name == "bls12_381"
        if msm_strategy == "auto":
            msm_strategy = "rns" if engine.device.type == "cuda" else "ladder"
        if msm_strategy not in STRATEGIES:
            raise ValueError(f"unknown msm_strategy {msm_strategy!r}")
        self.engine = engine
        self.device = engine.device
        self.fr = engine.fr
        self.params = params
        self.msm_strategy = msm_strategy
        self.pippenger_c = pippenger_c
        dev = self.device

        tpl = synthesize_witness(engine, circuit_template)
        self.num_inputs = len(tpl.input_assignment)
        self.num_aux = len(tpl.aux_assignment)
        self.num_constraints = len(tpl.a)
        self.m, self.exp = domain_size_for(self.num_constraints, engine.fr_host)
        self.a_aux_idx = [i for i, d in enumerate(tpl.a_aux_density.bv) if d]
        self.b_in_idx = [i for i, d in enumerate(tpl.b_input_density.bv) if d]
        self.b_aux_idx = [i for i, d in enumerate(tpl.b_aux_density.bv) if d]

        def bake(group, pts, n_logical):
            n = _pad_pow2_int(n_logical)
            return group.encode_points(list(pts) + [None] * (n - len(pts)), dev)

        self.h_n = _pad_pow2_int(self.m - 1)
        self.crs_h = bake(g1_device, params.h, self.m - 1)
        self.crs_l = bake(g1_device, params.l, self.num_aux)
        a_in, a_aux = params.get_a(self.num_inputs)
        b1_in, b1_aux = params.get_b_g1(len(self.b_in_idx))
        b2_in, b2_aux = params.get_b_g2(len(self.b_in_idx))
        a_all = list(a_in) + list(a_aux)
        b1_all = list(b1_in) + list(b1_aux)
        b2_all = list(b2_in) + list(b2_aux)
        self.crs_a = bake(g1_device, a_all, len(a_all))
        self.crs_b1 = bake(g1_device, b1_all, len(b1_all))
        self.crs_b2 = bake(g2_device, b2_all, len(b2_all))

        # vk points + deterministic-blinding precomputations (host points)
        vk = params.vk
        hostg1, hostg2 = g1_device.host, g2_device.host
        r, s = DETERMINISTIC_R, DETERMINISTIC_S
        self.r, self.s = r, s
        self.ga_const = g1_device.encode_points(
            [hostg1.add(hostg1.mul(vk.delta_g1, r), vk.alpha_g1)], dev)
        self.gb_const = g2_device.encode_points(
            [hostg2.add(hostg2.mul(vk.delta_g2, s), vk.beta_g2)], dev)
        gc = hostg1.add(
            hostg1.mul(vk.delta_g1, r * s % bc.R),
            hostg1.add(hostg1.mul(vk.alpha_g1, s), hostg1.mul(vk.beta_g1, r)),
        )
        self.gc_const = g1_device.encode_points([gc], dev)

        warm_twiddles(self.fr, engine.fr_host, self.exp)
        self._pipeline = _h_pipeline(self.fr, engine.fr_host, self.exp)
        from ..groth16.compiled import CompiledCircuit

        self.compiled = CompiledCircuit(engine, circuit_template)
        self._build_tables()

    # ---------------------------------------------------------------- tables
    def _base_sets(self):
        return (("h", self.crs_h, g1_device), ("l", self.crs_l, g1_device),
                ("a", self.crs_a, g1_device), ("b1", self.crs_b1, g1_device),
                ("b2", self.crs_b2, g2_device))

    def _build_tables(self) -> None:
        """Per CRS base set, the strategy's build-time device work, resident:
        "rns": affine bucket tables -> int16 RNS residues in the 80-row
        padded layout (the limb tables are freed); "table": the limb bucket
        tables; "flatpip": the shifted bases of sets of 16 or more."""
        strategy = self.msm_strategy
        self._tables = {}
        self._sbases = {}
        self._table_signed = strategy == "rns" or (
            strategy == "table" and os.environ.get("BMT_TABLE_SIGNED", "1") == "1")
        if strategy == "flatpip":
            for _, crs, grp in self._base_sets():
                if crs[0].shape[-1] >= 16:
                    self._sbases[id(crs)] = shifted_bases(grp.ops, crs, self.pippenger_c)
        if strategy not in ("rns", "table"):
            return
        c_env = int(os.environ.get("BMT_TABLE_C", "0"))
        budget = int(os.environ.get("BMT_TABLE_MEM_MB", "1536"))
        pick = self._table_signed and self.device.type == "cuda"
        f = default_rns_field()
        for _, crs, grp in self._base_sets():
            g2 = grp is g2_device
            c_tab = c_env or (pick_table_c(crs[0].shape[-1], g2, budget) if pick else 4)
            if not self._table_signed:
                self._tables[id(crs)] = (window_tables(grp.ops, crs, c_tab), None, c_tab)
                continue
            tab = window_tables_affine(grp.ops, crs, c_tab)
            if strategy == "table":
                self._tables[id(crs)] = (tab, None, c_tab)
                continue
            rtab, bound = tables_to_rns(rns_g2_ops() if g2 else rns_g1_ops(), bc.fp, tab)
            del tab
            self._tables[id(crs)] = (pad_rns_table(f, rtab), bound, c_tab)
            del rtab

    def table_info(self) -> List[Tuple[str, int, int, int]]:
        """(name, base count, window width c, table bytes) per MSM; empty for
        the strategies without tables."""
        return [(name, crs[0].shape[-1], self._tables[id(crs)][2],
                 sum(t.numel() * t.element_size() for t in self._tables[id(crs)][0]))
                for name, crs, _ in self._base_sets() if id(crs) in self._tables]

    # ------------------------------------------------------------------ step
    def _msm(self, grp, crs, bits):
        """One MSM of the step: bits (NBITS, B, N) -> limb point (L, [2,] B, 1)."""
        strategy = self.msm_strategy
        ops = grp.ops
        if strategy in ("rns", "table"):
            tab, bound, c_tab = self._tables[id(crs)]
            digits = digits_from_bits(bits, c_tab)
            if strategy == "rns":
                rops = rns_g2_ops() if grp is g2_device else rns_g1_ops()
                return msm_table_affine_rns(rops, bc.fp, tab, signed_digits(digits, c_tab), bound)
            if self._table_signed:
                return msm_table_affine(ops, tab, signed_digits(digits, c_tab))
            return msm_table(ops, tab, digits)
        c = self.pippenger_c
        if strategy == "flatpip" and id(crs) in self._sbases:
            return msm_flat_pippenger(ops, self._sbases[id(crs)], digits_from_bits(bits, c), c)
        if strategy == "pippenger" and crs[0].shape[-1] >= 16:
            return msm_pippenger_batched(ops, crs, digits_from_bits(bits, c), c)
        per_proof = tuple(x[..., None, :].expand(tuple(x.shape[:-1]) + tuple(bits.shape[1:]))
                          for x in crs)  # the bases broadcast over B
        return tree_reduce(ops, scalar_mul_bits(ops, per_proof, bits))

    def step(self, a8, b8, c8, wit_in8, wit_aux8):
        """Packed std-form bytes (B, k, nbytes) -> projective (g_a, g_b, g_c),
        each coordinate (L, [2,] B, 1)."""
        fr = self.fr
        B = a8.shape[0]

        def unpack(x8):
            B_, k, nb = x8.shape
            return fr.unpack_device(x8.reshape(B_ * k, nb)).reshape(fr.L, B_, k)

        abc = fr.to_mont(torch.stack([unpack(a8), unpack(b8), unpack(c8)], dim=1))
        h = self._pipeline(abc[:, 0], abc[:, 1], abc[:, 2])[..., : self.m - 1]
        wit_in = unpack(wit_in8)
        wit_aux = unpack(wit_aux8)

        def pad_scalars(bits, n):
            k = bits.shape[-1]
            return bits if k == n else torch.nn.functional.pad(bits, (0, n - k))

        def sel(bits, idx):
            return bits[:, :, torch.as_tensor(idx, dtype=torch.long, device=bits.device)]

        bits_h = pad_scalars(bits_from_mont(fr, h), self.h_n)
        bits_aux = bits_from_std(fr, wit_aux)
        bits_in = bits_from_std(fr, wit_in)
        bits_a = pad_scalars(torch.cat([bits_in, sel(bits_aux, self.a_aux_idx)], dim=-1),
                             self.crs_a[0].shape[-1])
        bits_b = pad_scalars(
            torch.cat([sel(bits_in, self.b_in_idx), sel(bits_aux, self.b_aux_idx)], dim=-1),
            self.crs_b1[0].shape[-1])
        bits_l = pad_scalars(bits_aux, self.crs_l[0].shape[-1])

        h_pt = self._msm(g1_device, self.crs_h, bits_h)
        l_pt = self._msm(g1_device, self.crs_l, bits_l)
        a_answer = self._msm(g1_device, self.crs_a, bits_a)
        b1_answer = self._msm(g1_device, self.crs_b1, bits_b)
        b2_answer = self._msm(g2_device, self.crs_b2, bits_b)

        def bconst(pt):
            return tuple(c.unsqueeze(-2).expand(tuple(c.shape[:-1]) + (B, 1)) for c in pt)

        g1o, g2o = g1_device.ops, g2_device.ops
        g_a = point_add(g1o, bconst(self.ga_const), a_answer)
        g_b = point_add(g2o, bconst(self.gb_const), b2_answer)
        a_s = scalar_mul_const(g1o, a_answer, self.s)
        b1_r = scalar_mul_const(g1o, b1_answer, self.r)
        g_c = point_add(g1o, bconst(self.gc_const), a_s)
        g_c = point_add(g1o, g_c, b1_r)
        g_c = point_add(g1o, g_c, h_pt)
        g_c = point_add(g1o, g_c, l_pt)
        return g_a, g_b, g_c

    # ------------------------------------------------------------- host APIs
    def encode_witness(self, provers) -> Tuple[torch.Tensor, ...]:
        """Host ProvingAssignments -> packed std-form byte tensors (B, k, nbytes)."""
        fr = self.fr

        def enc(rows: List[List[int]], width: int) -> torch.Tensor:
            flat = []
            for row in rows:
                flat.extend(list(row) + [0] * (width - len(row)))
            u8 = fr.pack_std(flat).reshape(len(rows), width, fr.nbytes)
            return torch.from_numpy(u8.copy()).to(self.device)

        a = enc([p.a for p in provers], self.m)
        b = enc([p.b for p in provers], self.m)
        c = enc([p.c for p in provers], self.m)
        wit_in = enc([p.input_assignment for p in provers], self.num_inputs)
        wit_aux = enc([p.aux_assignment for p in provers], self.num_aux)
        return a, b, c, wit_in, wit_aux

    def encode_circuits(self, circuits: Sequence[Circuit]):
        """Fused synthesis + native C LC evaluation -> packed wire bytes.
        Falls back to the assignment path when the native library is
        unavailable (a host-side fallback, as in the reference)."""
        from .. import native

        if not native.available():
            provers = [self.compiled.prove_assignment(c) for c in circuits]
            return self.encode_witness(provers)
        fr = self.fr
        B = len(circuits)
        m = self.m
        nb = fr.nbytes
        a8 = np.zeros((B, m, nb), np.uint8)
        b8 = np.zeros((B, m, nb), np.uint8)
        c8 = np.zeros((B, m, nb), np.uint8)
        wi = np.zeros((B, self.num_inputs, nb), np.uint8)
        wa = np.zeros((B, self.num_aux, nb), np.uint8)
        n_cons = self.num_constraints
        for i, circ in enumerate(circuits):
            in_arr, aux_arr, ra, rb, rc = self.compiled.prove_bytes(circ, nb)
            a8[i, :n_cons] = ra
            b8[i, :n_cons] = rb
            c8[i, :n_cons] = rc
            wi[i] = native.limbs_to_bytes(in_arr, nb)
            if self.num_aux:
                wa[i] = native.limbs_to_bytes(aux_arr, nb)
        return tuple(torch.from_numpy(x).to(self.device) for x in (a8, b8, c8, wi, wa))

    def decode(self, g_a, g_b, g_c) -> List[Proof]:
        pa = g1_device.decode_points(tuple(x[..., 0] for x in g_a))
        pb = g2_device.decode_points(tuple(x[..., 0] for x in g_b))
        pc = g1_device.decode_points(tuple(x[..., 0] for x in g_c))
        return [Proof(a=x, b=y, c=z) for x, y, z in zip(pa, pb, pc)]

    def prove_batch(self, circuits: Sequence[Circuit]) -> List[Proof]:
        """Host synthesis per circuit + one device step + decode."""
        return self.decode(*self.step(*self.encode_circuits(circuits)))
