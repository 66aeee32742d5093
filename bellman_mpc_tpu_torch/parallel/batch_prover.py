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

On a mesh (`mesh=`, parallel/mesh.make_mesh, lead device = the engine's)
the strategy is "table" ("auto" becomes it; any other raises ValueError):
each base set's tables are built once at full N on the lead and each
"model" shard's N-slice is placed on its device at build (a view where the
device is the same); the step's table MSMs run sharded, the proofs over
"data" and the bases over "model" (parallel/sharded.py).  Under
BMT_SHARD_NTT_EXP (default 18, read at construction) the h(x) pipeline's
NTTs are sharded too once the domain reaches 2^BMT_SHARD_NTT_EXP.  A base
set or a batch that does not divide by its axis raises ValueError.

The reference's opt-ins, read from the environment at construction (all
off by default; `glv`, `merge_g1` and `stack_msms` say what was built):
  * BMT_GLV=1 (rns): GLV-2 on G1 and GLS-4 on G2 (ops/glv.py).  The tables
    are built for 130-bit (G1) and 66-bit (G2) scalars and extended with
    phi (2N bases) or psi (4N bases); the step keeps std-form digits and
    decomposes them on the device, so each G1 MSM folds 18 windows at c = 8
    over twice the lanes and the G2 MSM 10 over four times the lanes;
  * BMT_MERGE_G1=1 (rns): the four G1 MSMs fold as one over their
    concatenated tables (`seg_sizes`), one K1 launch per window at the sum
    of their widths, and a segmented tree reduction; with BMT_GLV=1 each
    segment holds [P_s || phi(P_s)];
  * BMT_STACK_MSMS=1 (ladder, pippenger): the four G1 MSMs run as one over
    bases padded to the widest set by identities and stacked on an axis
    after the limb (and component) axes.  The reference's stacked path
    runs under vmap, where its table lookups by id(bases) fail, so rns
    (unless merged), table and flatpip raise ValueError here;
  * BMT_CARRIES=scan|flat: the limb carry strategy (fields/limb.py, read at
    call time; no effect on what is built).
Density bookkeeping is resolved at build time from a template synthesis;
the input-wire queries ride the aux queries' power-of-two padding, as in the
reference (8 MSMs collapse to 5).  The table window width follows the
reference: BMT_TABLE_C, else `pick_table_c` under BMT_TABLE_MEM_MB for
signed tables on the card (against the extended width and the decomposed
scalar bits under GLV, the sum of the segments when merged), else 4.
Where the rns tables of all W windows would not fit the card
(`table_budget`: half its memory; without GLV or merging), they hold
ceil(W / k) windows for the fewest passes k that fit: each MSM folds its
digits in k passes over the same tables and joins the passes by Horner's
rule (`_msm_in_passes`); tables are built over slices of the bases
(TABLE_CHUNK_BYTES of limb table each) to bound the build's peak.
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
    point_double,
    point_identity,
    scalar_mul_bits,
    scalar_mul_const,
    tree_reduce,
)
from ..curves.rns_point import default_rns_field, rns_g1_ops, rns_g2_ops
from ..fields import bls12_381 as bc
from ..fields.limb import LIMB_BITS, LimbField
from ..groth16.prover import (
    DETERMINISTIC_R,
    DETERMINISTIC_S,
    _h_pipeline,
    _h_pipeline_sharded,
    synthesize_witness,
)
from ..groth16.types import Parameters, Proof
from ..ops.domain import domain_size_for, warm_twiddles
from ..ops.fold_kernels import PAD_C, pad_rns_table
from ..ops.glv import (
    GLS_NBITS,
    GLV_NBITS,
    decompose_glv2_device,
    decompose_gls4_device,
    digits_to_bits_msb,
)
from ..ops.msm import (
    digits_from_bits,
    msm_flat_pippenger,
    msm_pippenger_batched,
    msm_table,
    msm_table_affine,
    msm_table_affine_rns,
    phi_extend_affine_tables,
    pick_table_c,
    psi_extend_affine_tables_g2,
    shifted_bases,
    signed_digits,
    tables_in_lazy_range,
    tables_to_rns,
    window_tables,
    window_tables_affine,
)
from ..r1cs.core import Circuit
from ..utils import profiling
from .sharded import BaseShards, shard_batch_inputs, sharded_msm_table, sharded_msm_table_affine

NBITS = 255  # Fr scalar bits
STRATEGIES = ("rns", "table", "pippenger", "flatpip", "ladder")
STACKABLE = ("ladder", "pippenger")  # the strategies BMT_STACK_MSMS=1 runs


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


def glv_signed_digits(scal: torch.Tensor, c: int, logical_sizes=None) -> torch.Tensor:
    """(L, B, N) std digits -> GLV signed window digits (W', B, 2N): one
    device decomposition, the |k1| and |k2| bits concatenated on the base
    axis to match the phi-extended tables, each lane's digits negated where
    its part is negative.  With `logical_sizes` the halves are interleaved
    per segment, to match the merged [P_s || phi(P_s)] layout."""
    n1, m1, n2, m2 = decompose_glv2_device(scal)
    b1, b2 = digits_to_bits_msb(m1), digits_to_bits_msb(m2)
    if logical_sizes is None:
        bits, neg = torch.cat([b1, b2], dim=-1), torch.cat([n1, n2], dim=-1)
    else:
        pb, pn, off = [], [], 0
        for n_s in logical_sizes:
            pb += [b1[..., off : off + n_s], b2[..., off : off + n_s]]
            pn += [n1[..., off : off + n_s], n2[..., off : off + n_s]]
            off += n_s
        bits, neg = torch.cat(pb, dim=-1), torch.cat(pn, dim=-1)
    sd = signed_digits(digits_from_bits(bits, c), c)
    return torch.where(neg[None], -sd, sd)


def gls_signed_digits(scal: torch.Tensor, c: int) -> torch.Tensor:
    """(L, B, N) std digits -> GLS-4 signed window digits (W', B, 4N) matching
    the psi-extended G2 tables."""
    neg, mag = decompose_gls4_device(scal)
    bits = torch.cat([digits_to_bits_msb(mag[t], GLS_NBITS) for t in range(4)], dim=-1)
    negs = torch.cat([neg[t] for t in range(4)], dim=-1)
    sd = signed_digits(digits_from_bits(bits, c), c)
    return torch.where(negs[None], -sd, sd)


TABLE_CHUNK_BYTES = 6 << 30  # limb table held at once while a table is built


def table_budget(device):
    """Bytes the rns tables may hold: half a card's memory; None (no limit)
    off the card."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 2


def _pad_pow2_int(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m *= 2
    return m


class BatchProver:
    """Per-(circuit, params) batched prover (MSM strategies: module doc)."""

    def __init__(self, engine, params: Parameters, circuit_template: Circuit,
                 msm_strategy: str = "auto", pippenger_c: int = 8, mesh=None):
        assert engine.name == "bls12_381"
        self.mesh = mesh
        if mesh is not None:
            if msm_strategy not in ("table", "auto"):
                raise ValueError(f"a mesh runs the table strategy, not {msm_strategy!r}")
            if mesh.lead != engine.device:
                raise ValueError(f"the mesh's lead device {mesh.lead} is not the engine's {engine.device}")
            msm_strategy = "table"
        if msm_strategy == "auto":
            msm_strategy = "rns" if engine.device.type == "cuda" else "ladder"
        if msm_strategy not in STRATEGIES:
            raise ValueError(f"unknown msm_strategy {msm_strategy!r}")
        self.glv = msm_strategy == "rns" and os.environ.get("BMT_GLV", "0") == "1"
        self.merge_g1 = msm_strategy == "rns" and os.environ.get("BMT_MERGE_G1", "0") == "1"
        self.stack_msms = os.environ.get("BMT_STACK_MSMS") == "1" and not self.merge_g1
        if self.stack_msms and msm_strategy not in STACKABLE:
            raise ValueError(f"BMT_STACK_MSMS=1 runs the {' and '.join(STACKABLE)} strategies, "
                             f"not {msm_strategy!r}")
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
        if mesh is not None:
            for name, crs, _ in self._base_sets():
                if crs[0].shape[-1] % mesh.shape["model"]:
                    raise ValueError(f"the {crs[0].shape[-1]} {name} bases do not divide over "
                                     f"{mesh.shape['model']} 'model' shards")

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
        shard_exp = int(os.environ.get("BMT_SHARD_NTT_EXP", "18"))
        if mesh is not None and self.exp >= shard_exp:
            self._pipeline = _h_pipeline_sharded(self.fr, engine.fr_host, self.exp, mesh)
        else:
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
        "rns": affine bucket tables (phi/psi-extended under GLV) -> int16
        RNS residues in the 80-row padded layout (the limb tables are
        freed), the four G1 sets as one concatenated table when merged;
        "table": the limb bucket tables (on a mesh, BaseShards of them);
        "flatpip": the shifted bases of sets of 16 or more."""
        strategy = self.msm_strategy
        self._tables = {}
        self._merged = None
        self._sbases = {}
        self.table_passes = 1
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
        if self.merge_g1:
            self._build_merged_g1(c_env, budget, pick)
        plan = {}
        for _, crs, grp in self._base_sets():
            g2 = grp is g2_device
            if (self.merge_g1 and not g2) or id(crs) in plan:
                continue
            n = crs[0].shape[-1]
            nbits, n_eff = ((GLS_NBITS, 4 * n) if g2 else (GLV_NBITS, 2 * n)) if self.glv else (NBITS, n)
            plan[id(crs)] = (crs, grp, c_env or (pick_table_c(n_eff, g2, budget, nbits) if pick else 4), nbits)
        if strategy == "rns" and not (self.glv or self.merge_g1):
            self.table_passes = self._pick_passes(plan.values())
        for crs, grp, c_tab, nbits in plan.values():
            if strategy == "table":
                if self._table_signed:
                    tab = self._limb_table(grp, crs, c_tab, nbits)
                else:
                    tab = window_tables(grp.ops, crs, c_tab)
                if self.mesh is not None:
                    tab = BaseShards(self.mesh, tab)
                self._tables[id(crs)] = (tab, None, c_tab)
                continue
            self._tables[id(crs)] = self._rns_table(grp, crs, c_tab, nbits) + (c_tab,)

    def _pick_passes(self, plan) -> int:
        """The fewest passes k whose tables, each of ceil(W / k) of its W
        windows, fit `table_budget`.  Every RNS table entry is an affine
        point of 80 int16 rows per coordinate."""
        budget = table_budget(self.device)
        if budget is None:
            return 1
        sizes = [(crs[0].shape[-1] * (2 if grp is g2_device else 1), -(-nbits // c) + 1, (1 << (c - 1)) + 1)
                 for crs, grp, c, nbits in plan]

        def total(k):
            return sum(4 * PAD_C * n * nb * -(-w // k) for n, w, nb in sizes)

        k = 1
        while total(k) > budget and k < max(w for _, w, _ in sizes):
            k += 1
        return k

    def _rns_table(self, grp, crs, c_tab: int, nbits: int):
        """One base set's padded RNS table and its bound: ceil(W / passes)
        windows, built over slices of the bases whose limb tables hold at
        most TABLE_CHUNK_BYTES each; a GLV table (whose phi- or
        psi-extension doubles the base axis) in one slice."""
        g2 = grp is g2_device
        rops = rns_g2_ops() if g2 else rns_g1_ops()
        w_pass = -(-(-(-nbits // c_tab) + 1) // self.table_passes)
        if self.table_passes > 1:
            nbits = c_tab * (w_pass - 1)  # window_tables_affine then builds w_pass windows
        n = crs[0].shape[-1]
        chunk = n
        limb_bytes = w_pass * ((1 << (c_tab - 1)) + 1) * (576 if g2 else 288)
        while not self.glv and chunk > 1 and chunk * limb_bytes > TABLE_CHUNK_BYTES:
            chunk //= 2
        out = None
        for n0 in range(0, n, chunk):
            tab = self._limb_table(grp, tuple(x[..., n0 : n0 + chunk] for x in crs), c_tab, nbits)
            rtab, bound = tables_to_rns(rops, bc.fp, tab)
            del tab
            padded = pad_rns_table(default_rns_field(), rtab)
            del rtab
            if chunk == n:
                return padded, bound
            if out is None:
                out = tuple(torch.empty(tuple(t.shape[:-1]) + (n,), dtype=t.dtype, device=t.device)
                            for t in padded)
            for o, t in zip(out, padded):
                o[..., n0 : n0 + chunk] = t
            del padded
        return out, bound

    def _limb_table(self, grp, crs, c_tab: int, nbits: int):
        """Signed affine limb tables of one base set, phi- (G1) or
        psi-extended (G2) under GLV; the extended coordinates are checked
        to lie below 2p, the bound the RNS conversion (and with it the
        fold's table bound and K schedule) is derived under."""
        tab = window_tables_affine(grp.ops, crs, c_tab, nbits)
        if self.glv:
            ext = psi_extend_affine_tables_g2 if grp is g2_device else phi_extend_affine_tables
            tab = ext(bc.fp, tab)
            assert tables_in_lazy_range(bc.fp, tab), "an extended table left the lazy range"
        return tab

    def _build_merged_g1(self, c_env: int, budget: int, pick: bool) -> None:
        """The four G1 sets' RNS tables concatenated on the base axis, then
        padded once: built one set at a time (each limb table freed after
        its conversion), segments of the sets' widths (twice that under
        GLV), the window width budgeted against their sum.  Aliased CRS sets
        share a table."""
        sets = [crs for _, crs, grp in self._base_sets() if grp is g1_device]
        self._g1_logical_sizes = tuple(crs[0].shape[-1] for crs in sets)
        nbits = GLV_NBITS if self.glv else NBITS
        self._g1_seg_sizes = tuple((2 if self.glv else 1) * n for n in self._g1_logical_sizes)
        c_tab = c_env or (pick_table_c(sum(self._g1_seg_sizes), False, budget, nbits) if pick else 4)
        rns_tabs, by_id, bound = [], {}, None
        for crs in sets:
            if id(crs) not in by_id:
                tab = self._limb_table(g1_device, crs, c_tab, nbits)
                by_id[id(crs)], bound = tables_to_rns(rns_g1_ops(), bc.fp, tab)
                del tab
            rns_tabs.append(by_id[id(crs)])
        merged = tuple(torch.cat([t[k] for t in rns_tabs], dim=-1) for k in range(2))
        del rns_tabs, by_id
        self._merged = (pad_rns_table(default_rns_field(), merged), bound, c_tab)

    def table_info(self) -> List[Tuple[str, int, int, int]]:
        """(name, base count as built, window width c, table bytes) per
        table: one entry per MSM, the merged G1 table as "g1_merged"; empty
        for the strategies without tables."""
        nbytes = lambda tab: sum(t.numel() * t.element_size() for t in tab)
        out = []
        if self._merged is not None:
            tab, _, c = self._merged
            out.append(("g1_merged", tab[0].shape[-1], c, nbytes(tab)))
        for name, crs, _ in self._base_sets():
            if id(crs) in self._tables:
                tab, _, c = self._tables[id(crs)]
                if isinstance(tab, BaseShards):
                    tab = tab.full
                out.append((name, tab[0].shape[-1], c, nbytes(tab)))
        return out

    # ------------------------------------------------------------------ step
    def _msm(self, grp, crs, bits):
        """One MSM of the step: bits (NBITS, B, N) -> limb point (L, [2,] B, 1);
        under GLV (L, B, N) std digits in place of the bits."""
        strategy = self.msm_strategy
        ops = grp.ops
        if strategy in ("rns", "table"):
            tab, bound, c_tab = self._tables[id(crs)]
            if strategy == "rns":
                g2 = grp is g2_device
                rops = rns_g2_ops() if g2 else rns_g1_ops()
                if self.glv:
                    sd = gls_signed_digits(bits, c_tab) if g2 else glv_signed_digits(bits, c_tab)
                else:
                    sd = signed_digits(digits_from_bits(bits, c_tab), c_tab)
                return self._msm_in_passes(ops, rops, tab, sd, bound, c_tab)
            digits = digits_from_bits(bits, c_tab)
            if self.mesh is not None:
                if self._table_signed:
                    return sharded_msm_table_affine(self.mesh, ops, tab, signed_digits(digits, c_tab))
                return sharded_msm_table(self.mesh, ops, tab, digits)
            if self._table_signed:
                return msm_table_affine(ops, tab, signed_digits(digits, c_tab))
            return msm_table(ops, tab, digits)
        c = self.pippenger_c
        if strategy == "flatpip" and id(crs) in self._sbases:
            return msm_flat_pippenger(ops, self._sbases[id(crs)], digits_from_bits(bits, c), c)
        return self._msm_limb(ops, crs, bits)

    def _msm_in_passes(self, ops, rops, tab, sd, bound, c_tab):
        """The RNS fold over tables of W' windows: the signed digits cut
        into `table_passes` passes of W' windows, pass p folding
        sum_i sum_w d[p W' + w, i] 2^(c w) P_i against the same tables, the
        passes joined by Horner's rule in limb form:
        R = R_{k-1}; R = 2^(c W') R + R_p for p = k-2 .. 0, timed as the
        device span "msm.join", its doublings counted as "msm.join_doublings"
        (utils/profiling.py).  One pass (W' = W) is the plain fold."""
        w_pass = tab[0].shape[tab[0].dim() - 3]
        parts = [msm_table_affine_rns(rops, bc.fp, tab, sd[p * w_pass : (p + 1) * w_pass], bound)
                 for p in range(-(-sd.shape[0] // w_pass))]
        acc = parts[-1]
        if len(parts) == 1:
            return acc
        profiling.count("msm.join_doublings", c_tab * w_pass * (len(parts) - 1))
        with profiling.device_span("msm.join", sd.device):
            for part in reversed(parts[:-1]):
                for _ in range(c_tab * w_pass):
                    acc = point_double(ops, acc)
                acc = point_add(ops, acc, part)
        return acc

    def _msm_limb(self, ops, bases, bits):
        """The bucket method (pippenger, 16 bases or more) or per-proof
        ladders and a tree sum: bases (L, [2,] [S,] N), bits (NBITS, [S,] B,
        N) -> (L, [2,] [S,] B, 1)."""
        c = self.pippenger_c
        if self.msm_strategy == "pippenger" and bases[0].shape[-1] >= 16:
            return msm_pippenger_batched(ops, bases, digits_from_bits(bits, c), c)
        per_proof = tuple(x[..., None, :].expand(tuple(x.shape[:-1]) + tuple(bits.shape[-2:]))
                          for x in bases)  # the bases broadcast over B
        return tree_reduce(ops, scalar_mul_bits(ops, per_proof, bits))

    def _msm_merged_g1(self, scal_list):
        """The four G1 MSMs as one fold over the merged table: the scalars
        (bits, or std digits under GLV) concatenated on the base axis, one
        K1 launch per window over all segments, a segmented reduction;
        under GLV each segment's reduction recombines k1 P + k2 phi(P).
        Returns one limb point (L, B, 1) per MSM."""
        tab, bound, c_tab = self._merged
        scal = torch.cat(scal_list, dim=-1)
        if self.glv:
            sd = glv_signed_digits(scal, c_tab, logical_sizes=self._g1_logical_sizes)
        else:
            sd = signed_digits(digits_from_bits(scal, c_tab), c_tab)
        pts = msm_table_affine_rns(rns_g1_ops(), bc.fp, tab, sd, bound,
                                   seg_sizes=self._g1_seg_sizes)  # (L, B, S)
        return [tuple(x[..., s : s + 1] for x in pts) for s in range(len(scal_list))]

    def _msm_stacked(self, grp, base_list, bits_list):
        """The G1 MSMs as one: bases padded to the widest set with
        identities and stacked on an axis after the limb axis, the bits
        padded alike and stacked after the bit axis.  Returns one limb
        point (L, B, 1) per MSM."""
        ops = grp.ops
        n_max = max(b[0].shape[-1] for b in base_list)

        def pad_base(bs):
            pad = n_max - bs[0].shape[-1]
            if pad == 0:
                return bs
            ident = point_identity(ops, (pad,), self.device)
            return tuple(torch.cat([x, i_], dim=-1) for x, i_ in zip(bs, ident))

        padded = [pad_base(b) for b in base_list]
        bases = tuple(torch.stack([b[k] for b in padded], dim=-2) for k in range(3))  # (L, S, n_max)
        bits = torch.stack([torch.nn.functional.pad(b, (0, n_max - b.shape[-1])) for b in bits_list], dim=1)
        out = self._msm_limb(ops, bases, bits)  # (L, S, B, 1)
        return [tuple(x.select(-3, i) for x in out) for i in range(len(base_list))]

    def step(self, a8, b8, c8, wit_in8, wit_aux8):
        """Packed std-form bytes (B, k, nbytes) -> projective (g_a, g_b, g_c),
        each coordinate (L, [2,] B, 1)."""
        fr = self.fr
        B = a8.shape[0]
        if self.mesh is not None:
            a8, b8, c8, wit_in8, wit_aux8 = shard_batch_inputs(
                self.mesh, (a8, b8, c8, wit_in8, wit_aux8), batch_axis=0)

        def unpack(x8):
            B_, k, nb = x8.shape
            return fr.unpack_device(x8.reshape(B_ * k, nb)).reshape(fr.L, B_, k)

        abc = fr.to_mont(torch.stack([unpack(a8), unpack(b8), unpack(c8)], dim=1))
        with profiling.device_span("step.h", abc.device, units=B):
            h = self._pipeline(abc[:, 0], abc[:, 1], abc[:, 2])[..., : self.m - 1]
        wit_in = unpack(wit_in8)
        wit_aux = unpack(wit_aux8)

        def pad_scalars(bits, n):
            k = bits.shape[-1]
            return bits if k == n else torch.nn.functional.pad(bits, (0, n - k))

        def sel(bits, idx):
            return bits[:, :, torch.as_tensor(idx, dtype=torch.long, device=bits.device)]

        if self.glv:  # std-form digits; each MSM decomposes its own
            bits_h = pad_scalars(std_from_mont(fr, h), self.h_n)
            bits_aux, bits_in = wit_aux, wit_in
        else:
            bits_h = pad_scalars(bits_from_mont(fr, h), self.h_n)
            bits_aux = bits_from_std(fr, wit_aux)
            bits_in = bits_from_std(fr, wit_in)
        bits_a = pad_scalars(torch.cat([bits_in, sel(bits_aux, self.a_aux_idx)], dim=-1),
                             self.crs_a[0].shape[-1])
        bits_b = pad_scalars(
            torch.cat([sel(bits_in, self.b_in_idx), sel(bits_aux, self.b_aux_idx)], dim=-1),
            self.crs_b1[0].shape[-1])
        bits_l = pad_scalars(bits_aux, self.crs_l[0].shape[-1])

        g1_bits = [bits_h, bits_l, bits_a, bits_b]
        if self.merge_g1:
            h_pt, l_pt, a_answer, b1_answer = self._msm_merged_g1(g1_bits)
        elif self.stack_msms:
            h_pt, l_pt, a_answer, b1_answer = self._msm_stacked(
                g1_device, [self.crs_h, self.crs_l, self.crs_a, self.crs_b1], g1_bits)
        else:
            h_pt, l_pt, a_answer, b1_answer = (
                self._msm(g1_device, crs, bits)
                for crs, bits in zip((self.crs_h, self.crs_l, self.crs_a, self.crs_b1), g1_bits))
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

    def run_step(self, *device_args):
        """The raw device step, `step` under the reference's name (for
        benchmarking device-only throughput)."""
        return self.step(*device_args)
