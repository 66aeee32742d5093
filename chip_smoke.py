#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bellman_mpc_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # the full run (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # phases 1-3 only
    python3 chip_smoke.py --mesh-only     # phases 1-5's setup and batch, then phase 14

Phases (each raises on failure; nothing is caught):
  1. require a CUDA card and the package; print
     `nvidia-smi --query-gpu=name,power.limit`;
  2. build every kernel from bellman_mpc_tpu_torch/csrc with nvcc (one
     process per source, in parallel);
  3. hold each kernel bit-exact against its plain PyTorch version on the
     card: K3 on (71, 16384) residues of random field elements and at a
     ragged lane count one past a full wave of persistent blocks, K1 at
     16384 lanes and K2 at 8192 lanes on encoded curve points with both
     signs and (0, 0) sentinels mixed in, over three chained windows, and
     K2 over two windows one lane past a full wave of its persistent
     blocks; K4 and LimbField.mul against LimbField.mul_plain on Fr, Fp
     and the mock field at 1, 13 and one past a full wave of lanes with
     the edge operands 0, 1, p-1, p, 2p-1, at the main path's (24, 8192),
     (24, 16384) and (36, 16), and on NTT-stage views and broadcast
     constants (check_mont_mul); K5 and K6 (the lazy columns) against
     their plain versions on Fp, Fr and the mock field at 1 and 13 lanes and
     one past a full wave, on stacked products and on reductions with and
     without folds before the REDC (check_lazy); K7 (one level of the RNS
     tree reduction) against its plain version on G1 and G2 at 1 and 13
     output lanes, one past a full wave of its blocks, on a merged (B,
     count, n_s) view and down a whole tree (check_tree); time K3 and K1 at
     16384 lanes, K2 at 8192 lanes, K4 at (24, 8192) and (24, 16384), K5 and
     K6 at (36, 1536) and (36, 131072) beside their plain versions, and K7
     at the cells' first-level shapes (TREE_TIMED) beside its plain version
     and the aten level it replaced;
  4. setup: ffi.test_create_parameters(), the MiMC-322 CRS (constants seed
     42) on its default engine, Bls12Engine() on the card, then
     BatchProver(msm_strategy="rns") with its padded RNS tables;
  5. prove_batch on B=16 random witnesses, launch counts checked (K1 132
     times, K2 33 times, K4 once for every limb multiply: k4_counts derives
     162 per step and 1847 per decode; the plain multiply never on a CUDA
     tensor; K5 once per LimbField.lazy_mul_many call and K6 once per
     LazyCols.reduce call, both counted by `counted`, and no plain lazy call
     on a CUDA tensor; K7 48 times, once per level of each MSM's tree, as
     derived_trees reads off the prover, and no plain tree level on a CUDA
     tensor); the 16 proofs
     verified on the card by one BatchVerifier.verify,
     proof 0 by verify_proof, a batch with one wrong public input rejected
     (each with K4's count from pairing_k4_counts, no plain multiply, no K1
     or K2), and the first 4 again by the host oracle's loop (a CPU
     engine), timed;
  6. timings: one step and one decode counted apart (K4 as k4_counts, K5
     and K6 as in phase 5, their sums phase 5's), table build, median
     step of 3, proofs/s, decode seconds, and one fold window's kernel time
     beside its plain version's at the main path's shapes (gathered from the
     real tables);
  7. the sequential create_random_proof of witness 0 (K4 3236 times, no
     fold kernel) equals batch proof 0 in its 192 serialized bytes (which
     phase 5 verified on the card);
  8. RangeDemo (the chip gate's setup and witnesses, n = 4, B = 16):
     setup, BatchProver(rns), 16/16 verified by one BatchVerifier on the
     card, proof 0 equal to the sequential proof, launch counts checked;
  9. pairings at scale: pairing_eq_batch on 30 equations of points made
     by the engine's device ladders, every third false, giving the known
     answers (the host encode timed apart; phase 10c runs it at 12,288
     lanes); K4 counts checked as in phase 5 (pairing_product_is_one runs
     in every verify_proof, pairing_batch in phase 13);
 10. the trusted-setup ceremony (groth16/mpc.py): (a) setup, proofs and
     verification on DummyEngine on the card for the mock tests' XorDemo,
     AndDemo and AddDemo, equal to DummyEngine("cpu")'s, K4 at L = 2 only;
     (b) generate_parameters_mpc(basis="lagrange") on AndDemo, byte for
     byte generate_parameters' CRS under the deterministic trapdoor, its
     proof verified on the card, a bad contribution rejected; (c) a
     phase-1 contribution at 2048 powers (its points from one device
     ladder per group) checked by verify_common_paramter (10,243
     equations, one pairing_eq_batch of 12,288 lanes): accepted, and
     rejected with two tau powers swapped; (d) the Lagrange transform
     (engine.g1/g2.intt) of its first 8 tau points equal to L_j(tau) G;
     prints a `ceremony:` line with the times and K4 counts;
 11. the limb MSM strategies and the rest of the slice (same MiMC-322 CRS):
     (a) BatchProver with ladder, table (signed, pick_table_c's width),
     pippenger and flatpip (c = 8), each built and run on phase 5's 16
     witnesses, every proof equal to the rns proofs in its 192 bytes, K4
     launched as k4_counts says per step and per decode, no fold kernel, no
     plain multiply; (b) generate_random_parameters under
     BMT_FIXED_BASE=comb, its parameter bytes equal to phase 4's; (c) the
     sequential proof of witness 0 under BMT_MSM_STRATEGY=pippenger equal to
     batch proof 0; (d) h(x) of witness 0 through EvaluationDomain equal to
     _h_pipeline's limbs; prints a `strategies:` line with each strategy's
     build, step and decode seconds, peak memory and K4 launches beside
     rns's, and the comb and ladder setups' seconds;
 12. the opt-ins of BatchProver (same CRS and witnesses): (a) rns under
     BMT_GLV=1 (GLV-2 / GLS-4), BMT_MERGE_G1=1 and both, each built, one
     step and decode with every proof equal to the rns proofs in its 192
     bytes, K1 and K2 launched as derived_folds says (72/10, 44/33, 23/10
     at MiMC-322), K4 as k4_counts, no plain multiply; (b) BMT_STACK_MSMS=1
     with pippenger (c = 8), the same checks; (c) under BMT_CARRIES=scan,
     h(x) of witness 0 and the decode of phase 6's step equal the flat
     run's limbs and points; prints an `opt-ins:` line with each one's
     build, one timed step, decode, peak memory, launches and aten
     operator calls per step (and its GLV digit path's) beside rns's.
     Phase 3 also holds K1 at 57,344 and 114,688 lanes and K2 at 32,768
     lanes (the opt-ins' widths) against their plain versions and times
     them;
 13. the host surface: (a) ffi.test_bellman() and ffi.process() (ten times
     5,000,000), timed; (b) neo_create_parameters refused on DummyEngine at
     MiMC-322 (PolynomialDegreeTooLarge: the mock field's domains stop at
     2^9, as in the reference), then timed_prove_verify(DummyEngine on the
     card, samples=3) with the constants cut to 100 rounds: two positive
     averages, K4 launched at L = 2, no plain multiply; (c) each ported
     bench of bellman_mpc_tpu_torch.benches at quick on the card, its JSON
     lines printed, K4 launched (exactly 1 + 60 for ntt and 1 + one
     pairing_batch's for pairing), no plain multiply, K1 and K2 only under
     batch_verify (its items come from an rns BatchProver); (d) one SHA-256
     compression of 512 allocated bits (a 55-byte message padded to one
     block) through the port's TestConstraintSystem: satisfied, 25,840
     constraints beyond the 512 inputs, the digest equal to hashlib's; one
     BLAKE2s of 32 bytes equal to hashlib.blake2s(person=b"12345678");
     prints a `host surface:` line with the times and K4 counts;
 14. the mesh (parallel/mesh.py, parallel/sharded.py), on logical shards of
     the card: (a) BatchProver(mesh=make_mesh(4, shape=(2, 2), devices=
     [cuda:0] * 4)) (the table strategy, c = 8, each base set's tables
     split over "model" at build; the tables are phase 11's, kept in host
     memory by SharedTables) and prove_batch of phase 5's 16 witnesses,
     every proof equal to phase 5's in its 192 bytes, K4 as k4_counts says
     per step and per decode, no fold kernel, no plain multiply; (b) h(x)
     of phase 5's batch through _h_pipeline_sharded on a (1, 4) mesh equal
     to _h_pipeline's canonical limbs (the raw lanes in another lazy form
     counted), K4 as sharded_h_k4; (c) sharded_msm_table and
     sharded_msm_table_affine on 64 G1 bases, B = 2, on a (2, 4) mesh and
     sharded_msm (the ladder) on a (1, 2) mesh equal to the host oracle,
     and a (1, 3) mesh refused (ValueError); (d) bench_scaling at quick,
     its JSON lines printed; (e) with two cards or more, (a) on a mesh of
     the real cards; prints a `mesh:` line with the build, step and decode
     times, the peak memory and the K4 counts.

Prints the kernels' JSON line (every kernel with its launches on the main
path, error, times, bound and library yardstick), the card's name and power
limit, and, last, {"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

B_PROOFS = 16
NBITS = 255
SOURCES = {
    "mont_mul": "bellman_mpc_tpu_torch/csrc/mont_mul.cu",
    "rns_mul_many": "bellman_mpc_tpu_torch/csrc/fold_kernels.cu",
    "rns_fold_window": "bellman_mpc_tpu_torch/csrc/fold_kernels.cu",
    "rns_fold_window_g2": "bellman_mpc_tpu_torch/csrc/fold_kernels.cu",
    "lazy_cols": "bellman_mpc_tpu_torch/csrc/mont_mul.cu",
    "lazy_redc": "bellman_mpc_tpu_torch/csrc/mont_mul.cu",
    "rns_tree_add": "bellman_mpc_tpu_torch/csrc/fold_kernels.cu",
}
# the TPU kernel each replaces; K5, K6 and K7 have no TPU counterpart (the
# reference leaves the lazy columns and the tree reduction to XLA)
REPLACES = {
    "mont_mul": "bellman_mpc_tpu/ops/pallas_kernels.py:87",
    "rns_mul_many": "bellman_mpc_tpu/ops/pallas_kernels.py:268",
    "rns_fold_window": "bellman_mpc_tpu/ops/pallas_kernels.py:470",
    "rns_fold_window_g2": "bellman_mpc_tpu/ops/pallas_kernels.py:663",
    "lazy_cols": "none",
    "lazy_redc": "none",
    "rns_tree_add": "none",
}
# H100 SXM device memory rate and dense int8 tensor-core rate (NVIDIA data
# sheet), and 32-bit integer instructions per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput: add, multiply-add, shift, logic and compare all 64)
MEM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
INT32_PER_CLOCK_PER_SM = 64


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:.1f} s] {msg}", file=sys.stderr, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of fn() over `reps` eager calls (CUDA events), after one
    warm-up call: the device time, or the host's time to issue the calls
    where that is longer."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, reps: int, calls: int = 1) -> float:
    """Mean device time of one fn() call over `reps` replays of a CUDA graph
    that captured `calls` calls back to back (CUDA events), after one eager
    warm-up call.  The replays queue the work faster than the card runs it,
    so the host's per-call launch overhead (tens of microseconds of Python
    around each kernel) does not stand in for the kernel's time; `calls` > 1
    also spreads the graph's own launch (a few microseconds) over that many
    kernels, for kernels that take about as long."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * calls)


def max_abs_err(a, b) -> int:
    import torch

    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in zip(a, b))


def point_pool(group, hostg, n: int, rng: random.Random, device):
    """n random curve points (host multiples of the generator) as padded RNS
    affine coordinates (80, [2,] n) int32."""
    from bellman_mpc_tpu_torch.curves.device import to_affine
    from bellman_mpc_tpu_torch.curves.rns_point import default_rns_field, limb_coord_to_rns
    from bellman_mpc_tpu_torch.fields import bls12_381 as bc
    from bellman_mpc_tpu_torch.ops.fold_kernels import rns_pad_rows

    pts = [hostg.mul(hostg.generator, rng.getrandbits(64) | 1) for _ in range(n)]
    x, y, _ = to_affine(group.ops, group.encode_points(pts, device))
    f = default_rns_field()
    return tuple(rns_pad_rows(f, limb_coord_to_rns(f, bc.fp, c).res) for c in (x, y))


def gather_q(pool, lanes: int, rng: random.Random, device):
    """lanes gathered pool points, every 7th lane the (0, 0) sentinel, every
    7th from lane 3 a point zero only in part (G1: x; G2: component 1 of x
    and y), which is not the sentinel, and random signs."""
    import torch

    idx = torch.tensor([rng.randrange(pool[0].shape[-1]) for _ in range(lanes)], device=device)
    q = tuple(t[..., idx].clone() for t in pool)
    for t in q:
        t[..., ::7] = 0
    if q[0].dim() == 3:  # G2: component 1 of x and y
        for t in q:
            t[:, 1, 3::7] = 0
    else:  # G1: x
        q[0][:, 3::7] = 0
    sgn = torch.tensor([rng.randrange(2) == 1 for _ in range(lanes)], device=device)
    return q, sgn


# the opt-ins' fold widths at B = 16 MiMC-322 (phase 12): K1 over the merged
# G1 table (3,584 bases; 7,168 under GLV), K2 over the psi-extended b2 table
# (4 x 512 bases)
WIDE_LANES = {"rns_fold_window": (57344, 114688), "rns_fold_window_g2": (32768,)}


def check_kernels(device, rng: random.Random, g1_lanes=16384, g2_lanes=8192, wide=WIDE_LANES):
    """Phase 3: every kernel against its plain version, bit-exact; K1 and K2
    also at the opt-ins' widths (`wide`), each timed beside its plain
    version."""
    import torch

    from bellman_mpc_tpu_torch.curves import rns_point as rpt
    from bellman_mpc_tpu_torch.curves.device import g1_device, g2_device
    from bellman_mpc_tpu_torch.curves.host import G1, G2
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk

    f = rpt.default_rns_field()
    results = {}
    # K3 on residues of random field elements
    n3 = g1_lanes
    xs = f.encode([rng.randrange(f.p) for _ in range(n3)], device=device).res
    ys = f.encode([rng.randrange(f.p) for _ in range(n3)], device=device).res
    got = fk.rns_mul_many(f, xs, ys)
    want = f.mul_many([(rpt.RnsVal(f, xs, 1), rpt.RnsVal(f, ys, 1))])[0].res
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0, f"K3 disagrees with its plain version: max_abs_err {err}"
    xp, yp = fk.rns_pad_rows(f, xs).contiguous(), fk.rns_pad_rows(f, ys).contiguous()
    plain = fk.rns_mul_block_plain(f, xp, yp)
    err_pad = max_abs_err(fk.rns_pad_rows(f, got), plain)
    assert err_pad == 0
    # a ragged lane count one past a full wave of K3's persistent blocks
    nr = fk.rns_mul_wave_lanes() + 1
    xr = f.encode([rng.randrange(f.p) for _ in range(nr)], device=device).res
    yr = f.encode([rng.randrange(f.p) for _ in range(nr)], device=device).res
    err_r = max_abs_err(fk.rns_pad_rows(f, fk.rns_mul_many(f, xr, yr)),
                        fk.rns_mul_block_plain(f, fk.rns_pad_rows(f, xr), fk.rns_pad_rows(f, yr)))
    assert err_r == 0, f"K3 disagrees with its plain version at {nr} lanes: max_abs_err {err_r}"
    results["rns_mul_many"] = dict(
        lanes=n3, ragged_lanes=nr, max_abs_err=max(err, err_r),
        ms=graph_time_ms(lambda: fk.rns_mul_many(f, xs, ys), 20),
        eager_ms=cuda_time_ms(lambda: fk.rns_mul_many(f, xs, ys), 20),
        plain_ms=cuda_time_ms(lambda: fk.rns_mul_block_plain(f, xp, yp), 3),
    )
    log(f"K3 rns_mul_many: bit-exact at (71, {n3}) and (71, {nr})")

    for name, group, hostg, rops, lanes, npool in (
        ("rns_fold_window", g1_device, G1, rpt.rns_g1_ops(), g1_lanes, 64),
        ("rns_fold_window_g2", g2_device, G2, rpt.rns_g2_ops(), g2_lanes, 32),
    ):
        g2 = rops.fp2
        pool = point_pool(group, hostg, npool, rng, device)
        tab_bound = rpt.limb_coord_to_rns(f, group.ops.f, group.ops.f.zeros((1,), device)).a
        tab_n, cap = fk._tab_n(tab_bound), Fraction(fk.G2_CAP if g2 else fk.G1_CAP)
        b = rops.b3c if g2 else rops.b3
        fold = fk.rns_fold_window_g2 if g2 else fk.rns_fold_window

        def plain(acc, q, sgn):
            """The plain version, its output laid out as the kernel's."""
            if not g2:
                return fk.fold_window_g1_plain(f, b, acc, q[0], q[1], sgn.to(torch.int32), tab_n, int(cap))
            return fk.fold_window_g2_plain_stacked(f, b, acc, q, sgn, tab_n, int(cap))

        def chained(n, windows):
            """`windows` windows from the identity at n lanes, each checked;
            returns the worst error and the last window's inputs."""
            acc = tuple(fk.rns_pad_rows(f, v.res) for v in rpt.point_identity(rops, (n,), device))
            worst = 0
            for _ in range(windows):
                acc_in = acc
                q, sgn = gather_q(pool, n, rng, device)
                want = plain(acc, q, sgn)
                acc = fold(f, b, acc, q, sgn, tab_bound, cap)
                torch.cuda.synchronize()
                err = max_abs_err(acc, want)
                worst = max(worst, err)
                assert err == 0, f"{name} disagrees with its plain version at {n} lanes: max_abs_err {err}"
            return worst, (acc_in, q, sgn)

        worst, (acc_in, q, sgn) = chained(lanes, 3)
        results[name] = dict(lanes=lanes, max_abs_err=worst)
        log(f"{name}: bit-exact over 3 chained windows at {lanes} lanes")
        if g2:  # one lane past a full wave: a block takes a second, ragged tile
            nw = fk.fold_g2_wave_lanes() + 1
            results[name].update(wave_lanes=nw, max_abs_err=max(worst, chained(nw, 2)[0]))
            log(f"{name}: bit-exact over 2 chained windows at {nw} lanes")
        kern = lambda: fold(f, b, acc_in, q, sgn, tab_bound, cap)
        results[name].update(ms=graph_time_ms(kern, 20), eager_ms=cuda_time_ms(kern, 20),
                             plain_ms=cuda_time_ms(lambda: plain(acc_in, q, sgn), 3))
        results[name]["wide"] = []
        for n in wide[name]:  # the opt-ins' widths: two chained windows, then timed
            err, (acc_w, q_w, sgn_w) = chained(n, 2)
            results[name]["wide"].append(dict(
                lanes=n, max_abs_err=err,
                ms=graph_time_ms(lambda: fold(f, b, acc_w, q_w, sgn_w, tab_bound, cap), 20),
                plain_ms=cuda_time_ms(lambda: plain(acc_w, q_w, sgn_w), 3)))
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            log(f"{name}: bit-exact over 2 chained windows at {n} lanes")
    return results


# K7's first-level shapes in the cells (output lanes = B x N / 2): G1 over
# SHA-256's and the Spend's h (16 x 32,768, 4 x 131,072) and MiMC-322's h
# (256 x 1,024); G2 over the Spend's b (4 x 65,536) and MiMC-322's b (256 x
# 512; SHA-256's 16 x 8,192 has as many lanes)
TREE_TIMED = (("g1", 16, 32768), ("g1", 256, 1024), ("g2", 4, 65536), ("g2", 256, 512))


def tree_launches(widths, passes: int) -> int:
    """K7 launches of one rns step: one per halving of each MSM's base axis,
    in every pass."""
    return passes * sum(n.bit_length() - 1 for n in widths)


def derived_trees(bp) -> int:
    """K7 launches of one step of an rns BatchProver, from what it built:
    tree_launches over its tables' base counts and passes; the merged G1
    table reduces each run of equal segment widths as one tree."""
    seg = bp._g1_seg_sizes if bp.merge_g1 else ()
    runs = [n for i, n in enumerate(seg) if i == 0 or seg[i - 1] != n]
    sets = [n for name, n, _, _ in bp.table_info() if name != "g1_merged"]
    return tree_launches(sets, bp.table_passes) + tree_launches(runs, 1)


def tree_bound(int_rate: float, g2: bool, lanes: int):
    """K7's (bound_ms, bound_by) at `lanes` output lanes: two points read and
    one written (9 coordinates of 71 int32 words, twice for G2), or its 12
    RNS products (36 for G2: Karatsuba)."""
    tc, i32 = rns_mul_ops()
    comps, muls = (2, 36) if g2 else (1, 12)
    return bound(9 * comps * 71 * 4 * lanes, muls * i32 * lanes, int_rate, muls * tc * lanes)


def check_tree(device, rng: random.Random):
    """Phase 3, K7 (`rns_tree_level`): bit-exact against tree_level_plain on
    G1 and G2 at 1 and 13 output lanes, one past a full wave of its blocks
    and on a merged (B, count, n_s) view, then down a whole tree; timed at
    the cells' first-level shapes (TREE_TIMED) beside its plain version and
    the aten level it replaced (rpt.point_add over RnsField), with its bound."""
    import torch

    from bellman_mpc_tpu_torch.curves import rns_point as rpt
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk

    f = rpt.default_rns_field()
    m = torch.from_numpy(fk.pad_consts(f)["m_pad"]).to(device)

    def tiles(g2, shape):
        full = (fk.PAD_C,) + ((2,) if g2 else ()) + tuple(shape)
        mb = m.reshape((fk.PAD_C,) + (1,) * (len(full) - 1))
        return tuple((torch.randint(0, 1 << 30, full, device=device) % mb).to(torch.int32) for _ in range(3))

    out = {"max_abs_err": 0, "cases": [], "timed": []}
    for g2 in (False, True):
        rops = rpt.rns_g2_ops() if g2 else rpt.rns_g1_ops()
        b, cap = (rops.b3c, fk.G2_CAP) if g2 else (rops.b3, fk.G1_CAP)
        wave = fk.tree_wave_lanes(g2) + 1
        for shape in ((1, 2), (13, 2), (1, 26), (1, 2 * wave), (2, 3, 8)):
            acc = tiles(g2, shape)
            err = max_abs_err(fk.rns_tree_level(f, b, acc, cap, g2), fk.tree_level_plain(f, b, acc, cap, g2))
            assert err == 0, f"K7 disagrees with its plain version at {'G2' if g2 else 'G1'} {shape}: {err}"
            out["cases"].append(f"{'G2' if g2 else 'G1'} {list(shape)}")
        acc = want = tiles(g2, (3, 64))
        while acc[0].shape[-1] > 1:  # a whole tree, each level's output the next one's input
            acc = fk.rns_tree_level(f, b, acc, cap, g2)
            want = fk.tree_level_plain(f, b, want, cap, g2)
            assert max_abs_err(acc, want) == 0, f"K7 disagrees down the tree at {tuple(acc[0].shape)}"
        out["cases"].append(f"{'G2' if g2 else 'G1'} tree of 64 x 3")
    log(f"K7 rns_tree_add: bit-exact at {len(out['cases'])} cases: " + "; ".join(out["cases"]))
    int_rate = int32_ops_per_s()
    for group, B, n in TREE_TIMED:
        g2 = group == "g2"
        rops = rpt.rns_g2_ops() if g2 else rpt.rns_g1_ops()
        b, cap = (rops.b3c, fk.G2_CAP) if g2 else (rops.b3, fk.G1_CAP)
        acc = tiles(g2, (B, n))
        halves = [tuple(rops.wrap(fk.rns_unpad_rows(f, t[..., s]).contiguous(), Fraction(cap)) for t in acc)
                  for s in (slice(0, n // 2), slice(n // 2, None))]
        lanes = B * n // 2
        bound_ms, bound_by = tree_bound(int_rate, g2, lanes)
        out["timed"].append(dict(
            group=group, B=B, N=n, lanes=lanes,
            ms=graph_time_ms(lambda: fk.rns_tree_level(f, b, acc, cap, g2), 10),
            eager_ms=cuda_time_ms(lambda: fk.rns_tree_level(f, b, acc, cap, g2), 10),
            plain_ms=cuda_time_ms(lambda: fk.tree_level_plain(f, b, acc, cap, g2), 2),
            aten_ms=cuda_time_ms(lambda: rpt.point_add(rops, *halves), 2),
            bound_ms=bound_ms, bound_by=bound_by))
        log(f"K7 at {group} ({B}, {n}): {out['timed'][-1]}")
        del acc, halves
        torch.cuda.empty_cache()
    return out


def fold_window_cases(bp, rng: random.Random):
    """One window of K1 (h table, 16384 lanes at B=16) and of K2 (b2 table,
    8192 lanes) on gathered table points: {name: (lanes, kernel call, plain
    call)}, where the plain call's output is laid out as the kernel's."""
    import torch

    from bellman_mpc_tpu_torch.curves import rns_point as rpt
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk

    f = rpt.default_rns_field()
    dev = bp.device

    def case(crs, rops):
        (xs, ys), bound, c = bp._tables[id(crs)]
        g2 = rops.fp2
        n = crs[0].shape[-1]
        nb = (1 << (c - 1)) + 1
        mag = torch.tensor([[rng.randrange(nb) for _ in range(n)] for _ in range(B_PROOFS)], device=dev)
        sgn = torch.tensor([[rng.randrange(2) == 1 for _ in range(n)] for _ in range(B_PROOFS)], device=dev)
        n_idx = torch.arange(n, device=dev)
        w = 3
        if g2:
            q = (xs[:, :, w][:, :, mag, n_idx].to(torch.int32), ys[:, :, w][:, :, mag, n_idx].to(torch.int32))
        else:
            q = (xs[:, w][:, mag, n_idx].to(torch.int32), ys[:, w][:, mag, n_idx].to(torch.int32))
        cap = Fraction(fk.G2_CAP if g2 else fk.G1_CAP)
        acc = tuple(fk.rns_pad_rows(f, v.res) for v in rpt.point_identity(rops, (B_PROOFS, n), dev))
        fold = fk.rns_fold_window_g2 if g2 else fk.rns_fold_window
        b = rops.b3c if g2 else rops.b3
        acc = fold(f, b, acc, q, sgn, bound, cap)  # a generic accumulator
        lanes = B_PROOFS * n
        if g2:
            def plain():
                return fk.fold_window_g2_plain_stacked(f, b, acc, q, sgn, fk._tab_n(bound), int(cap))
        else:
            a_f = [t.reshape(fk.PAD_C, lanes).contiguous() for t in acc]
            q_f = [t.reshape(fk.PAD_C, lanes).contiguous() for t in q]

            def plain():
                ref = fk.fold_window_g1_plain(f, b, a_f, q_f[0], q_f[1], sgn.reshape(-1).to(torch.int32),
                                              fk._tab_n(bound), int(cap))
                return tuple(t.reshape(acc[0].shape) for t in ref)
        return lanes, (lambda: fold(f, b, acc, q, sgn, bound, cap)), plain

    return {"rns_fold_window": case(bp.crs_h, rpt.rns_g1_ops()),
            "rns_fold_window_g2": case(bp.crs_b2, rpt.rns_g2_ops())}


def time_fold_windows(bp, rng: random.Random):
    """Phase 6b: K1 and K2 on gathered table points (fold_window_cases),
    bit-exact against their plain versions, and both timed."""
    out = {}
    for name, (lanes, kern, plain) in fold_window_cases(bp, rng).items():
        err = max_abs_err(kern(), plain())
        assert err == 0, f"{name} disagrees with its plain version on table points"
        out[name] = dict(lanes=lanes, max_abs_err=err, ms=graph_time_ms(kern, 20),
                         plain_ms=cuda_time_ms(plain, 3))
    return out


def limb_digits(f, vals, device):
    """(L, n) int32 canonical 11-bit digits of the host ints vals (each below
    2^(11 L))."""
    import numpy as np
    import torch

    nb = f.nbytes
    u = np.frombuffer(b"".join(v.to_bytes(nb, "little") for v in vals), np.uint8).reshape(len(vals), nb)
    u = np.concatenate([u, np.zeros((len(vals), 2), np.uint8)], axis=1).astype(np.int32)
    j = f._byte_idx
    chunk = u[:, j] | (u[:, j + 1] << 8) | (u[:, j + 2] << 16)
    return torch.from_numpy(np.ascontiguousarray(((chunk >> f._bit_shift) & 2047).T.astype(np.int32))).to(device)


def lazy_limbs(f, n: int, rng: random.Random, device):
    """(L, n) int32 canonical digits of values in [0, 2p); every 5th lane
    within 2^8 of 2p, the largest value the kernels take."""
    vals = [2 * f.p - 1 - rng.randrange(256) if i % 5 == 0 else rng.randrange(2 * f.p)
            for i in range(n)]
    return limb_digits(f, vals, device)


def edge_limbs(f, n: int, rng: random.Random, device):
    """Two (L, n) lazy_limbs operands whose first lanes pair the edge values
    0, 1, p-1, p and 2p-1 every way (25 lanes, fewer when n is smaller)."""
    edges = [0, 1, f.p - 1, f.p, 2 * f.p - 1]
    pairs = [(x, y) for x in edges for y in edges][:n]
    a, b = lazy_limbs(f, n, rng, device), lazy_limbs(f, n, rng, device)
    a[:, :len(pairs)] = limb_digits(f, [x for x, _ in pairs], device)
    b[:, :len(pairs)] = limb_digits(f, [y for _, y in pairs], device)
    return a, b


K4_TIMED_LANES = (8192, 16384)  # Fr: an NTT stage of a B = 16 step, a whole-batch product


def check_mont_mul(device, rng: random.Random):
    """Phase 3, K4: the kernel (mont_mul) and LimbField.mul, which launches
    it on a CUDA tensor, bit-exact against the plain version,
    LimbField.mul_plain: on Fr, Fp and the mock field at 1 and 13 lanes and
    one lane past a full wave of its blocks, with the edge operands 0, 1,
    p-1, p, 2p-1 paired every way in the first lanes; on Fr at the main
    path's (24, 8192) and (24, 16384), and on Fp at decode's (36, 16); on the
    call sites' strided and broadcast operands (NTT-stage upper halves of a
    B = 16, m = 1024 batch against their (L, 1, 1, half) twiddles, a
    mul_const constant).  Times K4 (device time, 20 calls per captured
    graph), its eager call and its plain version at Fr (24, 8192) and
    (24, 16384), and the graph floor: a one-element PyTorch kernel timed the
    same way."""
    import torch

    from bellman_mpc_tpu_torch.fields.bls12_381 import fp, fr
    from bellman_mpc_tpu_torch.fields.mock import mock
    from bellman_mpc_tpu_torch.ops.mont_kernels import mont_mul, wave_lanes

    checked = []

    def check(f, a, b, what):
        want = f.mul_plain(a, b)
        got = (mont_mul(f, a, b), f.mul(a, b))
        torch.cuda.synchronize()
        err = max(max_abs_err(g, want) for g in got)
        assert err == 0, f"K4 disagrees with its plain version at {what}: max_abs_err {err}"
        checked.append(what)

    for name, f, more in (("Fr", fr, K4_TIMED_LANES), ("Fp", fp, (16,)), ("mock", mock, ())):
        for n in (1, 13, wave_lanes(f.L) + 1) + more:
            check(f, *edge_limbs(f, n, rng, device), f"{name} ({f.L}, {n})")
    x = lazy_limbs(fr, B_PROOFS * 1024, rng, device).reshape(fr.L, B_PROOFS, 1024)
    for s in (1, 5, 10):
        m, half = 1 << s, 1 << (s - 1)
        tw = lazy_limbs(fr, half, rng, device).reshape(fr.L, 1, 1, half)
        check(fr, x.reshape(fr.L, B_PROOFS, 1024 // m, m)[..., half:], tw, f"NTT stage {s}'s upper half")
    check(fr, x, fr.limbs_const(12345, x), "a mul_const constant")
    log(f"K4 mont_mul: bit-exact at {len(checked)} cases: " + "; ".join(checked))
    out = {"max_abs_err": 0, "cases": checked, "timed": {}}
    for n in K4_TIMED_LANES:
        a, b = lazy_limbs(fr, n, rng, device), lazy_limbs(fr, n, rng, device)
        out["timed"][n] = dict(ms=graph_time_ms(lambda: mont_mul(fr, a, b), 20, 20),
                               eager_ms=cuda_time_ms(lambda: mont_mul(fr, a, b), 50),
                               plain_ms=cuda_time_ms(lambda: fr.mul_plain(a, b), 5))
    one = torch.zeros(1, dtype=torch.int32, device=device)
    out["graph_floor_ms"] = graph_time_ms(lambda: one.add_(1), 20, 20)
    return out


# Fp lanes of the lazy kernels timed in phase 3: a stacked product or
# reduction of six coordinates of a B = 256 step's proof assembly, and a
# CRS ladder's or bucket chain's width
LAZY_TIMED_LANES = (1536, 131072)


def lazy_ops(f):
    """(K5, K6) 32-bit integer instructions per lane, the least each
    function needs: K5 L^2 multiply-adds; K6 a carry pass and packing over
    the 2L columns (5 per column), REDC over s 32-bit words (s^2 word
    products of m p, each a low and a high multiply-add and two carry adds,
    and s products for m) and the L output digits (3 each)."""
    s = -(-(2 * f.p).bit_length() // 32)
    return f.L * f.L, 10 * f.L + 4 * s * s + s + 3 * f.L


def lazy_bounds(int_rate: float, f, lanes: int) -> dict:
    """(bound_ms, bound_by) of K5 and K6 at (L, lanes): K5 reads 2L and
    writes 2L words per lane, K6 reads 2L and writes L, or their operations."""
    k5_ops, k6_ops = lazy_ops(f)
    return {"lazy_cols": bound(4 * f.L * 4 * lanes, k5_ops * lanes, int_rate),
            "lazy_redc": bound(3 * f.L * 4 * lanes, k6_ops * lanes, int_rate)}


def check_lazy(device, rng: random.Random):
    """Phase 3, K5 and K6 (ops/mont_kernels.py): lazy_cols against
    LimbField.mul_cols on three stacked products (lazy_limbs operands and
    their digit sums), lazy_redc against LimbField.lazy_redc_plain on the
    reduction of 3 t0 + (t2 - t0 - t1) and on a scaling of t0 to the int32
    edge (a plan with folds before the REDC), on Fp, Fr and the mock field at
    1 and 13 lanes and one lane past a full wave of each kernel's blocks,
    and on Fp at LAZY_TIMED_LANES; times both at those Fp widths (20 calls
    per captured graph), eagerly and their plain versions."""
    import torch

    from bellman_mpc_tpu_torch.fields.bls12_381 import fp, fr
    from bellman_mpc_tpu_torch.fields.limb import _reduce_plan
    from bellman_mpc_tpu_torch.fields.mock import mock
    from bellman_mpc_tpu_torch.ops.mont_kernels import lazy_cols, lazy_redc, wave_lanes

    def inputs(f, n):
        a, b, c, d = (lazy_limbs(f, n, rng, device) for _ in range(4))
        dm = f._dmax_lazy
        t0, t1, t2 = f.lazy_mul_many([(a, b), (c, d), (a + c, b + d)],
                                     [(dm, dm), (dm, dm), (tuple(2 * x for x in dm),) * 2])
        value = sum(h << (11 * i) for i, h in enumerate(t0.hi))
        edge = t0.scale(min(((1 << 31) - 1) // max(t0.hi), (f.p * f.R - 1) // value))
        return (torch.stack([a, c, a + c], dim=1), torch.stack([b, d, b + d], dim=1),
                [(lc.cols.contiguous(), _reduce_plan(f, lc.hi, False)) for lc in (3 * t0 + (t2 - t0 - t1), edge)])

    checked = []
    for name, f, more in (("Fp", fp, LAZY_TIMED_LANES), ("Fr", fr, ()), ("mock", mock, ())):
        for n in (1, 13, wave_lanes(f.L, "lazy_cols") + 1, wave_lanes(f.L, "lazy_redc") + 1) + more:
            lhs, rhs, reds = inputs(f, n)
            err = max_abs_err(lazy_cols(f, lhs, rhs), f.mul_cols(lhs, rhs))
            err = max([err] + [max_abs_err(lazy_redc(f, cols, plan), f.lazy_redc_plain(cols, plan))
                               for cols, plan in reds])
            assert err == 0, f"K5 or K6 disagrees with its plain version at {name} ({f.L}, {n}): {err}"
            checked.append(f"{name} ({f.L}, {n}) plans {[plan for _, plan in reds]}")
    log(f"K5 lazy_cols, K6 lazy_redc: bit-exact at {len(checked)} cases: " + "; ".join(checked))
    int_rate = int32_ops_per_s()
    out = {"max_abs_err": 0, "cases": checked, "timed": {}}
    for n in LAZY_TIMED_LANES:
        lhs, rhs, reds = inputs(fp, n)
        cols, plan = reds[0]
        bounds = lazy_bounds(int_rate, fp, n)
        out["timed"][n] = {
            "lazy_cols": dict(ms=graph_time_ms(lambda: lazy_cols(fp, lhs, rhs), 20, 20),
                              eager_ms=cuda_time_ms(lambda: lazy_cols(fp, lhs, rhs), 50),
                              plain_ms=cuda_time_ms(lambda: fp.mul_cols(lhs, rhs), 5),
                              bound_ms=bounds["lazy_cols"][0], bound_by=bounds["lazy_cols"][1]),
            "lazy_redc": dict(ms=graph_time_ms(lambda: lazy_redc(fp, cols, plan), 20, 20),
                              eager_ms=cuda_time_ms(lambda: lazy_redc(fp, cols, plan), 50),
                              plain_ms=cuda_time_ms(lambda: fp.lazy_redc_plain(cols, plan), 5),
                              bound_ms=bounds["lazy_redc"][0], bound_by=bounds["lazy_redc"][1]),
        }
    return out


def inv_muls(f) -> int:
    """Multiplies of LimbField.inv: pow_const(p - 2) squares once per bit and
    multiplies once per set bit."""
    e = f.p - 2
    return e.bit_length() + bin(e).count("1")


def k4_counts(exp: int) -> dict:
    """K4 launches (= LimbField.mul calls on the card) of the main path, by
    part, for a 2^exp domain; the counts are the code's:
    h(x) pipeline (groth16/prover._h_pipeline): 7 NTTs of exp stages, one
      multiply each (ops/domain.ntt); 1/n after each of the 4 inverse NTTs;
      4 distribute_powers of 2 exp + 1 (a multiply and a square per
      doubling, then the product); the z^-1 scaling; the coset product:
      15 exp + 10;
    a step (BatchProver.step): to_mont, the h(x) pipeline, std_from_mont;
    decode (DeviceGroup.decode_points): a G1 point set is an Fp inversion,
      x and y times z^-1 and 2 from_mont; a G2 point set the norm (one
      stacked product), its inversion, 2 products by it, x and y times z^-1
      (one stacked Karatsuba product each) and 4 from_mont; prove_batch
      decodes two G1 sets and one G2 set;
    the sequential proof (create_random_proof): the h(x) pipeline, from_mont
      of h, and one decode per MSM with at least 4 dense bases (the
      device's; groth16/engine._MSM_DEVICE_THRESHOLD): h, l and the aux
      parts of a and b on G1, b's aux part on G2; the input parts (2 bases)
      stay on the host."""
    from bellman_mpc_tpu_torch.fields.bls12_381 import fp

    h = 7 * exp + 4 + 4 * (2 * exp + 1) + 1 + 1
    g1 = inv_muls(fp) + 2 + 2
    g2 = 1 + inv_muls(fp) + 2 + 2 + 4
    return {"step": 1 + h + 1, "decode": 2 * g1 + g2, "sequential": h + 1 + 4 * g1 + g2,
            "decode_g1": g1, "decode_g2": g2}


def pairing_k4_counts() -> dict:
    """K4 launches (= LimbField.mul calls on the card) of the pairing entry
    points (ops/pairing.py); the counts are the code's:
    a Miller loop: the line's two fp2_mul_fp products (2 Fp products each)
      in every doubling and every add step of _RUNS (63 and 5); its point
      updates and Fp12 products are lazy columns, which launch no K4;
    a final exponentiation (exact or x-chain): its one fp12_inv, whose
      fp2_inv makes 2 squares, an Fp inversion and 2 products; the ladders,
      Frobenius maps and Fp12 products are lazy columns;
    fp12_decode: one from_mont per Fp coordinate (12);
    pairing_product_is_one: a Miller loop and a final exponentiation, and so
      are verify_proof and BatchVerifier.verify on a CUDA engine when the IC
      sum has fewer than 4 bases (the host's; every circuit here has one
      public input); pairing_eq_batch: two Miller loops, one final
      exponentiation; pairing_batch: a Miller loop, a final exponentiation
      and a decode."""
    from bellman_mpc_tpu_torch.fields.bls12_381 import fp
    from bellman_mpc_tpu_torch.ops.pairing import _RUNS

    miller = 4 * sum(n for n, _ in _RUNS) + 4 * sum(1 for _, add in _RUNS if add)
    final_exp = 2 + inv_muls(fp) + 2
    return {"miller": miller, "final_exp": final_exp, "product_is_one": miller + final_exp,
            "eq_batch": 2 * miller + final_exp, "pairing_batch": miller + final_exp + 12}


def check_no_fold(counts: dict, what: str) -> None:
    """No plain multiply, lazy column call or tree level on the card and no
    fold, tree or RNS kernel."""
    assert counts["mont_mul_plain"] == counts["lazy_plain"] == counts["tree_plain"] == 0, (what, counts)
    assert (counts["rns_fold_window"] == counts["rns_fold_window_g2"] == counts["rns_mul_many"]
            == counts["rns_tree_add"] == 0), (what, counts)


def check_pairing_counts(counts: dict, k4: int, what: str) -> None:
    """A pairing run launched K4 exactly k4 times, ran no plain multiply on
    the card and no fold kernel."""
    assert counts["mont_mul"] == k4, (what, counts, k4)
    check_no_fold(counts, what)


def raises(exc, fn) -> bool:
    """True when fn() raises exc (any other exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def batch_verify(engine, vk, proofs, inputs, seed: int) -> None:
    """One BatchVerifier.verify over all proofs (raises InvalidProof)."""
    from bellman_mpc_tpu_torch.groth16 import BatchVerifier

    bv = BatchVerifier()
    for proof, inp in zip(proofs, inputs):
        bv.queue((proof, inp))
    bv.verify(engine, vk, random.Random(seed))


HOST_VERIFIED = 4  # proofs the host oracle checks again (cut from 16 as phase 13 was added)


def verify_on_card(kl, engine, params, pvk, proofs, inputs) -> dict:
    """Phase 5's verification: the batch of proofs by one BatchVerifier on
    the card, proof 0 by verify_proof, a batch with one wrong public input
    rejected (each counted), then the first HOST_VERIFIED proofs by the
    host oracle's loop (a CPU engine), timed."""
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine, verify_proof
    from bellman_mpc_tpu_torch.r1cs import InvalidProof

    k4 = pairing_k4_counts()["product_is_one"]
    assert len(params.vk.ic) < 4, "the IC sum would run a device MSM: its K4 count is not in k4"
    _, c, batch_s = counted(kl, lambda: batch_verify(engine, params.vk, proofs, inputs, 1))
    check_pairing_counts(c, k4, "BatchVerifier.verify")
    _, c, single_s = counted(kl, lambda: verify_proof(engine, pvk, proofs[0], inputs[0]))
    check_pairing_counts(c, k4, "verify_proof")
    wrong = [list(x) for x in inputs]
    wrong[len(wrong) // 2][0] += 1
    rejected, c, bad_s = counted(
        kl, lambda: raises(InvalidProof, lambda: batch_verify(engine, params.vk, proofs, wrong, 2)))
    assert rejected, "a batch with a wrong public input verified"
    check_pairing_counts(c, k4, "BatchVerifier.verify (wrong input)")
    host = Bls12Engine("cpu")
    t0 = time.perf_counter()
    for proof, inp in zip(proofs[:HOST_VERIFIED], inputs):
        verify_proof(host, pvk, proof, inp)
    host_s = time.perf_counter() - t0
    return {"batch_verify_s": batch_s, "verify_single_s": single_s, "batch_reject_s": bad_s,
            "host_verify_s": host_s, "k4_per_verify": k4}


def pairings_at_scale(kl, engine, device, n_eq: int = 30, rng=None) -> dict:
    """Phase 9: pairing_eq_batch on n_eq equations e(a G1, b G2) ==
    e(c G1, G2) with c = ab, or ab + 1 in every third (false) one, the
    points made by the engine's device ladders, against the known truth,
    with the host encode timed apart; counted (pairing_k4_counts).
    pairing_product_is_one (4 terms, bucket 8) runs in every verify_proof
    (phases 5 and 10b), pairing_batch in phase 13's bench_pairing (8
    pairs), held there against the host oracle; tests/test_torch_cuda.py
    holds it with an identity lane."""
    import torch

    from bellman_mpc_tpu_torch.curves.host import G1, G2
    from bellman_mpc_tpu_torch.fields.bls12_381 import R
    from bellman_mpc_tpu_torch.ops import pairing as dp

    rng = rng or random.Random(9)
    k4 = pairing_k4_counts()
    out = {}
    torch.cuda.reset_peak_memory_stats()
    sa = [rng.randrange(1, R) for _ in range(n_eq)]
    sb = [rng.randrange(1, R) for _ in range(n_eq)]
    truth = [i % 3 != 2 for i in range(n_eq)]
    sc = [a * b % R + (0 if t else 1) for a, b, t in zip(sa, sb, truth)]
    t0 = time.perf_counter()
    g1_pts = engine.g1.batch_mul(G1.generator, sa + sc)
    a1, a2 = g1_pts[:n_eq], g1_pts[n_eq:]
    b1 = engine.g2.batch_mul(G2.generator, sb)
    b2 = [G2.generator] * n_eq
    out["eq_points_s"] = time.perf_counter() - t0
    m = dp._bucket(n_eq)
    t0 = time.perf_counter()
    dp.encode_pairs(a1, b1, m, device)
    dp.encode_pairs([G1.neg(p) for p in a2], b2, m, device)
    torch.cuda.synchronize()
    out["eq_encode_s"] = time.perf_counter() - t0
    eqs, c, out["pairing_eq_s"] = counted(kl, lambda: dp.pairing_eq_batch(a1, b1, a2, b2, device))
    check_pairing_counts(c, k4["eq_batch"], "pairing_eq_batch")
    assert eqs.tolist() == truth, "pairing_eq_batch disagrees with the known answers"
    out.update(n_eq=n_eq, equations_per_s=n_eq / out["pairing_eq_s"])
    out["pairing_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["k4"] = k4
    return out


CEREMONY_POWERS = 2048  # the 2m tau powers of MiMC-322's Lagrange ceremony (m = 1024)
# the Lagrange transform's size: cut from MiMC-322's m = 1024 to 512 as phase
# 12 was added, to 32 as phase 13 was and to 8 as phase 14 was (its ladders
# are launch-bound: one stage per doubling of m; still above the 4 points
# that route to the host butterflies)
LAGRANGE_M = 8
# the mock Groth16 tests' trapdoor and blinding (tests/test_groth16_mock.py, tests/mod.rs:302-307)
MOCK_TRAPDOOR = (48577, 22580, 53332, 5481, 3673)
MOCK_BLINDING = (27134, 17146)


def mock_circuits() -> dict:
    """The mock Groth16 tests' circuits (tests/test_groth16_mock.py:39-118)
    on the port's r1cs, each with (a, b, public output) witnesses: XorDemo,
    AndDemo (the port's models.AndDemo has the same constraints), AddDemo."""
    from bellman_mpc_tpu_torch.fields.mock import MODULUS
    from bellman_mpc_tpu_torch.models import AndDemo
    from bellman_mpc_tpu_torch.r1cs import AssignmentMissing, Circuit

    def need(v):
        if v is None:
            raise AssignmentMissing()
        return v

    class XorDemo(Circuit):
        def __init__(self, a, b):
            self.a, self.b = a, b

        def synthesize(self, cs):
            a = cs.alloc("a", lambda: int(need(self.a)))
            cs.enforce("a_boolean", lambda lc: lc + cs.one() - a, lambda lc: lc + a, lambda lc: lc)
            b = cs.alloc("b", lambda: int(need(self.b)))
            cs.enforce("b_boolean", lambda lc: lc + cs.one() - b, lambda lc: lc + b, lambda lc: lc)
            c = cs.alloc_input("c", lambda: int(need(self.a) ^ need(self.b)))
            cs.enforce("c_xor", lambda lc: lc + a + a, lambda lc: lc + b, lambda lc: lc + a + b - c)

    class AddDemo(Circuit):
        def __init__(self, a, b):
            self.a, self.b = a, b

        def synthesize(self, cs):
            a = cs.alloc("a", lambda: need(self.a))
            b = cs.alloc("b", lambda: need(self.b))
            c = cs.alloc_input("c", lambda: (need(self.a) + need(self.b)) % MODULUS)
            cs.enforce("c_add", lambda lc: lc + a + b, lambda lc: lc + cs.one(), lambda lc: lc + c)

    return {
        "xor": (XorDemo, [(False, False, 0), (True, False, 1), (False, True, 1), (True, True, 0)]),
        "and": (AndDemo, [(True, False, 0), (True, True, 1)]),
        "add": (AddDemo, [(1, 3, 4), (5, MODULUS - 2, 3)]),
    }


def mock_on_card(kl, device) -> dict:
    """Phase 10a: setup, proofs and verification on DummyEngine on the card
    for the mock circuits; CRS and proofs equal DummyEngine("cpu")'s; a
    wrong public input fails.  The mock field (L = 2) is the engine's only
    limb field, so every K4 launch here is at L = 2: exp + 2 per setup (the
    iFFT's exp stages and 1/n, the decode's from_mont) and 15 exp + 11 per
    proof (the h(x) pipeline and the decode of h)."""
    from bellman_mpc_tpu_torch.groth16 import (
        DummyEngine,
        create_proof,
        generate_parameters,
        prepare_verifying_key,
        verify_proof,
    )
    from bellman_mpc_tpu_torch.r1cs import InvalidProof

    card, cpu = DummyEngine(device), DummyEngine("cpu")
    assert card.fr.L == 2 and card.device == device
    p = card.fr_host.p
    out = {"setup_s": 0.0, "proof_s": 0.0, "k4": 0, "proofs": 0}
    for name, (circ, witnesses) in mock_circuits().items():
        params, c, s = counted(kl, lambda: generate_parameters(card, circ(None, None), 1, 1, *MOCK_TRAPDOOR))
        exp = len(params.h).bit_length()  # h has m - 1 elements
        assert c["mont_mul"] == exp + 2, (name, c)
        check_no_fold(c, f"mock setup {name}")
        assert params == generate_parameters(cpu, circ(None, None), 1, 1, *MOCK_TRAPDOOR), name
        out["setup_s"] += s
        out["k4"] += c["mont_mul"]
        pvk = prepare_verifying_key(card, params.vk)
        for a, b, pub in witnesses:
            proof, c, s = counted(kl, lambda: create_proof(card, circ(a, b), params, *MOCK_BLINDING))
            assert c["mont_mul"] == 15 * exp + 11, (name, c)
            check_no_fold(c, f"mock proof {name}")
            assert proof == create_proof(cpu, circ(a, b), params, *MOCK_BLINDING), (name, a, b)
            verify_proof(card, pvk, proof, [pub])
            assert raises(InvalidProof, lambda: verify_proof(card, pvk, proof, [(pub + 1) % p]))
            out["proof_s"] += s
            out["k4"] += c["mont_mul"]
            out["proofs"] += 1
    return out


def lagrange_ceremony(kl, engine) -> dict:
    """Phase 10b: the canned 3+3-player ceremony end to end on AndDemo (4
    constraints, m = 4, 8 powers), the reference's BLS ceremony test
    (tests/test_mpc.py:261-298): generate_parameters_mpc in the Lagrange
    basis gives generate_parameters' CRS under the deterministic trapdoor
    byte for byte, and a proof from it verifies on the card; a bad list
    contribution (mpc_bad_paramters_custom through paramter_list_excute)
    raises CeremonyError.  A phase-1 contribution with tampered powers is
    (c)'s rejection; the power basis runs in the CPU tests (on the card it
    takes as long as the Lagrange ceremony)."""
    from bellman_mpc_tpu_torch.groth16 import (
        DETERMINISTIC_TRAPDOOR,
        create_random_proof,
        generate_parameters,
        params_to_bytes,
        prepare_verifying_key,
        verify_proof,
    )
    from bellman_mpc_tpu_torch.groth16 import mpc
    from bellman_mpc_tpu_torch.models import AndDemo

    k4 = pairing_k4_counts()
    t = DETERMINISTIC_TRAPDOOR
    out = {}
    direct, c, out["direct_setup_s"] = counted(kl, lambda: generate_parameters(
        engine, AndDemo(None, None), engine.g1.generator(), engine.g2.generator(),
        t["alpha"], t["beta"], t["gamma"], t["delta"], t["tau"]))
    check_no_fold(c, "generate_parameters (AndDemo)")
    lag, c, out["lagrange_s"] = counted(
        kl, lambda: mpc.generate_parameters_mpc(engine, AndDemo(None, None), basis="lagrange"))
    check_no_fold(c, "generate_parameters_mpc (lagrange)")
    out["lagrange_k4"] = c["mont_mul"]
    out["crs_bytes"] = len(params_to_bytes(lag))
    assert params_to_bytes(lag) == params_to_bytes(direct), "the Lagrange ceremony's CRS != generate_parameters'"
    proof = create_random_proof(engine, AndDemo(True, True), lag)
    _, c, out["verify_s"] = counted(
        kl, lambda: verify_proof(engine, prepare_verifying_key(engine, direct.vk), proof, [1]))
    check_pairing_counts(c, k4["product_is_one"], "verify_proof (ceremony CRS)")

    lst = mpc.init_parameter_list(engine)
    lst = mpc.paramter_list_excute(engine, lst, mpc.mpc_common_paramters_custom_generator(engine, lst[-1], 5))
    bad = mpc.mpc_bad_paramters_custom(engine, lst[-1], 7)
    rejected, c, out["bad_reject_s"] = counted(
        kl, lambda: raises(mpc.CeremonyError, lambda: mpc.paramter_list_excute(engine, lst, bad)))
    assert rejected, "a bad contribution was accepted"
    check_pairing_counts(c, k4["eq_batch"], "paramter_list_excute (bad)")
    return out


def lagrange_scalars(host, tau: int, m: int):
    """L_j(tau) over the m-point domain, from the host closed form
    L_j(tau) = w^j (tau^m - 1) / (m (tau - w^j))."""
    p = host.p
    w = host.nth_root_of_unity(m.bit_length() - 1)
    z = (pow(tau, m, p) - 1) * host.inv(m) % p
    lam, wj = [], 1
    for _ in range(m):
        lam.append(wj * z * host.inv((tau - wj) % p) % p)
        wj = wj * w % p
    return lam


def contribution_check(kl, engine, n: int, m: int, rng: random.Random):
    """Phase 10c: one phase-1 contribution at n powers from
    initial_common_paramters, checked by verify_common_paramter: 4 + 4n +
    n - 1 equations in one pairing_eq_batch, accepted; with two tau powers
    swapped, rejected.  Returns (numbers, the contribution, (d)'s expected
    points L_j(tau) G of both groups at m points)."""
    from bellman_mpc_tpu_torch.groth16 import mpc
    from bellman_mpc_tpu_torch.ops.pairing import _bucket

    k4 = pairing_k4_counts()["eq_batch"]
    p = engine.fr_host.p
    st = mpc.initial_common_paramters(engine, n)
    alpha, beta, tau = (rng.randrange(2, p) for _ in range(3))
    g1, g2 = engine.g1.generator(), engine.g2.generator()
    out = {"n_powers": n}

    # From the all-generator state every point of the contribution is a
    # multiple of the generator (result_i = mine_i = s_i G), so the player's
    # points come from the engine's device ladders, one batch_mul per group
    # over all three lists and (d)'s L_j(tau).  mpc_common_paramters_generator
    # scales the running points with the host mul instead: 3n per group,
    # 12,288 at 2048 powers (one of each is timed below).
    powers = [pow(tau, i, p) for i in range(n)]
    scal = powers + [alpha * x % p for x in powers] + [beta * x % p for x in powers]
    scal += lagrange_scalars(engine.fr_host, tau, m)

    def build():
        pts = list(zip(engine.g1.batch_mul(g1, scal), engine.g2.batch_mul(g2, scal)))
        lists = [mpc.TauParameterPair([mpc.ParameterPair(r1, r2, r1, r2) for r1, r2 in pts[k * n:(k + 1) * n]])
                 for k in range(3)]
        contrib = mpc.CommonParamter(
            alpha=mpc.make_new_paramter(engine, alpha, st.alpha_g1, st.alpha_g2, g1, g2, False),
            beta=mpc.make_new_paramter(engine, beta, st.beta_g1, st.beta_g2, g1, g2, False),
            tau=lists[0], alpha_mul_tau=lists[1], beta_mul_tau=lists[2])
        return contrib, {"g1": [a for a, _ in pts[3 * n:]], "g2": [b for _, b in pts[3 * n:]]}

    (contrib, want), c, out["build_s"] = counted(kl, build)
    check_no_fold(c, "contribution ladders")
    out["build_k4"] = c["mont_mul"]
    # one host mul of each group, what mpc_common_paramters_generator runs per point
    head = contrib.alpha_mul_tau.list[0]  # alpha G from the ladders
    for name, group, base, pt in (("g1", engine.g1, g1, head.g1_result), ("g2", engine.g2, g2, head.g2_result)):
        t0 = time.perf_counter()
        assert group.mul(base, alpha) == pt, f"the {name} ladder and the host mul disagree"
        out[f"host_{name}_mul_s"] = time.perf_counter() - t0
    new, c, out["check_s"] = counted(kl, lambda: mpc.verify_common_paramter(engine, st, contrib))
    check_pairing_counts(c, k4, "verify_common_paramter")
    assert new.tau_g1 == contrib.tau.get_g1() and new.beta_mul_tau_g2 == contrib.beta_mul_tau.get_g2()
    lst, i = contrib.tau.list, n // 2
    lst[i], lst[i + 1] = lst[i + 1], lst[i]
    rejected, c, out["reject_s"] = counted(
        kl, lambda: raises(mpc.CeremonyError, lambda: mpc.verify_common_paramter(engine, st, contrib)))
    assert rejected, "a contribution with two tau powers swapped was accepted"
    check_pairing_counts(c, k4, "verify_common_paramter (swapped powers)")
    lst[i], lst[i + 1] = lst[i + 1], lst[i]
    n_eq = 4 + 4 * n + n - 1
    out.update(n_eq=n_eq, lanes=_bucket(n_eq), equations_per_s=n_eq / out["check_s"], k4_per_check=k4)
    return out, contrib, want


def lagrange_transform(kl, engine, contrib, want: dict, m: int) -> dict:
    """Phase 10d: engine.g1.intt and engine.g2.intt of the contribution's
    first m tau points (log2 m stage ladders and the 1/n ladder, then the
    decode, whose Fermat inversion and products are K4's only launches),
    equal to L_j(tau) G (`want`, from contribution_check)."""
    host = engine.fr_host
    k4 = k4_counts(1)
    out = {"m": m}
    for name, group, pts in (("g1", engine.g1, contrib.tau.get_g1()[:m]),
                             ("g2", engine.g2, contrib.tau.get_g2()[:m])):
        got, c, out[f"{name}_intt_s"] = counted(kl, lambda: group.intt(pts, host))
        assert c["mont_mul"] == k4[f"decode_{name}"], (name, c)
        check_no_fold(c, f"{name}.intt")
        out[f"{name}_k4"] = c["mont_mul"]
        assert got == want[name], f"{name}.intt != L_j(tau) G"
    return out


def ceremony(kl, engine, device, rng: random.Random, n_powers=CEREMONY_POWERS, m=LAGRANGE_M) -> dict:
    """Phase 10: the trusted-setup ceremony on the card (a)-(d)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"mock": mock_on_card(kl, device)}
    out["mock"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lagrange_anddemo"] = lagrange_ceremony(kl, engine)
    out["lagrange_anddemo"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["check"], contrib, want = contribution_check(kl, engine, n_powers, m, rng)
    out["check"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["transform"] = lagrange_transform(kl, engine, contrib, want, m)
    out["transform"]["s"] = time.perf_counter() - t0
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


class SharedTables:
    """Phase 11's signed affine tables kept for phase 14a, whose mesh prover
    builds the same ones (same CRS, c = 8, 255 bits).  While `serving`,
    BatchProver's window_tables_affine returns the stored build for the same
    base points, else builds and stores it; `offload` moves the store to
    host memory, so that no later measurement's device memory holds it.
    Phase 11 runs the build itself; phase 14a's prover is built from the
    stored tables (29-38 s saved on one H100 at 700 W, by host)."""

    def __init__(self):
        self.store = {}
        self.hits = 0

    @contextlib.contextmanager
    def serving(self):
        from bellman_mpc_tpu_torch.parallel import batch_prover

        build = batch_prover.window_tables_affine

        def cached(ops, points, c, nbits=NBITS):
            key = (id(ops), c, nbits) + tuple(x.cpu().numpy().tobytes() for x in points)
            if key in self.store:
                self.hits += 1
            else:
                self.store[key] = build(ops, points, c, nbits)
            return tuple(t.to(points[0].device) for t in self.store[key])

        batch_prover.window_tables_affine = cached
        try:
            yield
        finally:
            batch_prover.window_tables_affine = build

    def offload(self) -> None:
        self.store = {k: tuple(t.cpu() for t in v) for k, v in self.store.items()}


LIMB_STRATEGIES = ("ladder", "table", "pippenger", "flatpip")
PIPPENGER_C = 8


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def limb_strategies(kl, engine, params, constants, circuits, want, k4, shared: SharedTables) -> dict:
    """Phase 11a: BatchProver with each limb strategy (signed tables at
    pick_table_c's width; pippenger and flatpip at c = 8) on phase 5's
    witnesses: its build, one step and its decode (prove_batch's body, timed
    apart), all proofs equal to the rns proofs `want` in their 192 bytes.
    The MSMs' point operations are lazy columns, so a step launches K4 as
    rns's does (to_mont, the h(x) pipeline, std_from_mont), and no fold
    kernel; no plain multiply runs on the card.  The table strategy's
    tables are kept in `shared` (host memory) for phase 14a."""
    import torch

    from bellman_mpc_tpu_torch.groth16 import proof_to_bytes
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver

    want_bytes = [proof_to_bytes(p) for p in want]
    out = {}
    for strategy in LIMB_STRATEGIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with shared.serving():
            bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy=strategy,
                             pippenger_c=PIPPENGER_C)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        tables = [[n, k, c] for n, k, c, _ in bp.table_info()]
        assert all(c == 8 for _, _, c in tables) and len(tables) == (5 if strategy == "table" else 0), tables
        args = bp.encode_circuits(circuits)
        res, c_step, step_s = counted(kl, lambda: bp.step(*args))
        proofs, c_dec, decode_s = counted(kl, lambda: bp.decode(*res))
        for what, c, n in (("step", c_step, k4["step"]), ("decode", c_dec, k4["decode"])):
            assert c["mont_mul"] == n, (strategy, what, c, n)
            check_no_fold(c, f"{strategy} {what}")
        assert [proof_to_bytes(p) for p in proofs] == want_bytes, f"{strategy}: proofs differ from rns's"
        out[strategy] = {"build_s": build_s, "step_s": step_s, "decode_s": decode_s,
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "k4_step": c_step["mont_mul"], "k4_decode": c_dec["mont_mul"],
                         "fold_launches": c_step["rns_fold_window"] + c_step["rns_fold_window_g2"],
                         "tables": tables}
        log(f"strategy {strategy}: {out[strategy]}")
        del bp, args, res
        shared.offload()
    torch.cuda.empty_cache()
    return out


def domain_h(kl, engine, circuit) -> dict:
    """Phase 11d: h(x) of one witness through EvaluationDomain (ifft and
    coset_fft of a, b and c, mul_assign, sub_assign, divide_by_z_on_coset,
    icoset_fft) equal to _h_pipeline's limbs; its 15 exp + 10 multiplies
    are K4's launches."""
    import torch

    from bellman_mpc_tpu_torch.groth16.prover import _h_pipeline, synthesize_witness
    from bellman_mpc_tpu_torch.ops.domain import EvaluationDomain, domain_size_for

    fr, host, dev = engine.fr, engine.fr_host, engine.device
    prover = synthesize_witness(engine, circuit)
    m, exp = domain_size_for(len(prover.a), host)

    def run():
        a, b, c = (EvaluationDomain.from_coeffs(fr, host, v, dev) for v in (prover.a, prover.b, prover.c))
        for d in (a, b, c):
            d.ifft()
            d.coset_fft()
        a.mul_assign(b)
        a.sub_assign(c)
        a.divide_by_z_on_coset()
        a.icoset_fft()
        return a.coeffs

    got, c, s = counted(kl, run)
    assert c["mont_mul"] == 15 * exp + 10, c
    check_no_fold(c, "EvaluationDomain h(x)")
    abc = (fr.encode(list(v) + [0] * (m - len(v)), device=dev) for v in (prover.a, prover.b, prover.c))
    assert torch.equal(got, _h_pipeline(fr, host, exp)(*abc)), "EvaluationDomain h(x) != _h_pipeline's"
    return {"m": m, "s": s, "k4": c["mont_mul"]}


def strategies_phase(kl, engine, params, constants, circuits, proofs, k4, shared: SharedTables) -> dict:
    """Phase 11: the limb strategies (a), setup under BMT_FIXED_BASE=comb
    (b), a sequential proof under BMT_MSM_STRATEGY=pippenger (c) and h(x)
    through EvaluationDomain (d)."""
    from bellman_mpc_tpu_torch.groth16 import (
        create_random_proof,
        generate_random_parameters,
        params_to_bytes,
        proof_to_bytes,
    )
    from bellman_mpc_tpu_torch.models import MiMCDemo

    out = {"strategies": limb_strategies(kl, engine, params, constants, circuits, proofs, k4, shared)}
    with environ(BMT_FIXED_BASE="comb"):
        comb, c, out["comb_setup_s"] = counted(kl, lambda: generate_random_parameters(engine, MiMCDemo(constants)))
    check_no_fold(c, "comb setup")
    assert params_to_bytes(comb) == params_to_bytes(params), "comb setup's parameters differ"
    with environ(BMT_MSM_STRATEGY="pippenger"):
        seq, c, out["pippenger_sequential_s"] = counted(kl, lambda: create_random_proof(engine, circuits[0], params))
    assert c["mont_mul"] == k4["sequential"], c
    check_no_fold(c, "pippenger sequential proof")
    assert proof_to_bytes(seq) == proof_to_bytes(proofs[0]), "pippenger sequential proof != batch proof 0"
    out["domain_h"] = domain_h(kl, engine, circuits[0])
    return out


OPT_INS = {"glv": {"BMT_GLV": "1"}, "merged": {"BMT_MERGE_G1": "1"},
           "glv_merged": {"BMT_GLV": "1", "BMT_MERGE_G1": "1"}}
# MiMC-322's K1 and K2 launches per step (c from pick_table_c at 1536 MiB:
# 8 per set; 6 for the merged 3,584 and 7,168 bases; GLV: 18 windows of
# 130-bit G1 scalars, 10 of 66-bit G2 scalars at c = 8), which
# `derived_folds` must reproduce from the CRS widths
MIMC322_FOLDS = {"glv": (72, 10), "merged": (44, 33), "glv_merged": (23, 10)}
MIMC322_WIDTHS = (1024, 1024, 1024, 512, 512)  # h, l, a, b1, b2 bases


def derived_folds(bp, B: int) -> dict:
    """K1 and K2 launches per step and the lanes of each launch, from the
    CRS widths and BatchProver's rule for c (BMT_TABLE_C, else pick_table_c
    under BMT_TABLE_MEM_MB, against 2N bases of 130-bit scalars on G1 and 4N
    of 66-bit ones on G2 under GLV, and the sum of the G1 widths when
    merged): W = ceil(nbits / c) + 1 windows per table, one launch each."""
    from bellman_mpc_tpu_torch.ops.glv import GLS_NBITS, GLV_NBITS
    from bellman_mpc_tpu_torch.ops.msm import pick_table_c

    c_env = int(os.environ.get("BMT_TABLE_C", "0"))
    budget = int(os.environ.get("BMT_TABLE_MEM_MB", "1536"))
    pick = lambda n, g2, nbits: c_env or pick_table_c(n, g2, budget, nbits)
    n1 = [x[0].shape[-1] for x in (bp.crs_h, bp.crs_l, bp.crs_a, bp.crs_b1)]
    n2 = bp.crs_b2[0].shape[-1]
    (m1, bits1), (m2, bits2) = ((2, GLV_NBITS), (4, GLS_NBITS)) if bp.glv else ((1, NBITS), (1, NBITS))
    sets = [m1 * sum(n1)] if bp.merge_g1 else [m1 * n for n in n1]
    c1 = [pick(n, False, bits1) for n in sets]
    c2 = pick(m2 * n2, True, bits2)
    return {"k1": sum(windows(c, bits1) for c in c1), "k2": windows(c2, bits2), "c": c1 + [c2],
            "k1_lanes": sorted({B * n for n in sets}), "k2_lanes": B * m2 * n2}


def aten_ops(fn):
    """(fn(), the aten operator calls fn made), counted by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Counter() as counter:
        out = fn()
    return out, counter.n


def step_ops(bp, args) -> dict:
    """One step's aten operator calls, and those of its GLV / GLS digit
    path (batch_prover.glv_signed_digits and gls_signed_digits: the device
    decompositions, bits, window and signed digits) with that path's
    seconds (synchronized around each call)."""
    import torch

    from bellman_mpc_tpu_torch.parallel import batch_prover as bpm

    dec = {"calls": 0, "aten_ops": 0, "s": 0.0}

    def wrap(fn):
        def counted_fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, n = aten_ops(lambda: fn(*a, **kw))
            torch.cuda.synchronize()
            dec.update(calls=dec["calls"] + 1, aten_ops=dec["aten_ops"] + n, s=dec["s"] + time.perf_counter() - t0)
            return out
        return counted_fn

    orig = bpm.glv_signed_digits, bpm.gls_signed_digits
    bpm.glv_signed_digits, bpm.gls_signed_digits = wrap(orig[0]), wrap(orig[1])
    try:
        _, n = aten_ops(lambda: bp.step(*args))
    finally:
        bpm.glv_signed_digits, bpm.gls_signed_digits = orig
    return {"aten_ops": n, "digit_path": dec}


def opt_in(kl, engine, params, constants, circuits, want_bytes, k4, name: str) -> dict:
    """Phase 12a, one opt-in: BatchProver(rns) built under its variables,
    one counted step and decode, the proofs against the rns proofs' bytes,
    K1 / K2 launches against derived_folds (and MIMC322_FOLDS at MiMC-322's
    widths), K4 as k4_counts, no plain multiply; then one timed step and
    one step's aten operator calls."""
    import torch

    from bellman_mpc_tpu_torch.groth16 import proof_to_bytes
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver

    env = OPT_INS[name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with environ(**env):
        bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert (bp.glv, bp.merge_g1, bp.stack_msms) == ("BMT_GLV" in env, "BMT_MERGE_G1" in env, False)
    B = len(circuits)
    want = derived_folds(bp, B)
    tables = [[n, k, c] for n, k, c, _ in bp.table_info()]
    assert [c for _, _, c in tables] == want["c"], (name, tables, want)
    if bp.merge_g1:
        assert tables[0][:2] == ["g1_merged", want["k1_lanes"][0] // B], tables
    args = bp.encode_circuits(circuits)
    res, c_step, _ = counted(kl, lambda: bp.step(*args))
    proofs, c_dec, decode_s = counted(kl, lambda: bp.decode(*res))
    folds = (c_step["rns_fold_window"], c_step["rns_fold_window_g2"])
    assert folds == (want["k1"], want["k2"]), (name, c_step, want)
    widths = tuple(x[0].shape[-1] for x in (bp.crs_h, bp.crs_l, bp.crs_a, bp.crs_b1, bp.crs_b2))
    if widths == MIMC322_WIDTHS:
        assert folds == MIMC322_FOLDS[name], (name, folds)
    assert c_step["mont_mul"] == k4["step"] and c_step["mont_mul_plain"] == 0 and c_step["rns_mul_many"] == 0, c_step
    assert c_step["rns_tree_add"] == derived_trees(bp) and c_step["tree_plain"] == 0, (name, c_step)
    assert c_dec["mont_mul"] == k4["decode"], c_dec
    check_no_fold(c_dec, f"{name} decode")
    assert [proof_to_bytes(p) for p in proofs] == want_bytes, f"{name}: proofs differ from rns's"
    steps = time_steps(bp, args, 1)
    ops = step_ops(bp, args)
    out = {"build_s": build_s, "step_s": statistics.median(steps), "steps_s": steps, "decode_s": decode_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "k1_step": folds[0], "k2_step": folds[1],
           "k4_step": c_step["mont_mul"], "k4_decode": c_dec["mont_mul"], "k7_step": c_step["rns_tree_add"],
           "aten_ops_step": ops["aten_ops"],
           "digit_path": ops["digit_path"], "k1_lanes": want["k1_lanes"], "k2_lanes": want["k2_lanes"],
           "tables": tables}
    log(f"opt-in {name}: {out}")
    del bp, args, res
    torch.cuda.empty_cache()
    return out


def stacked_pippenger(kl, engine, params, constants, circuits, want_bytes, k4) -> dict:
    """Phase 12b: BMT_STACK_MSMS=1 with pippenger (c = 8): the four G1 MSMs
    as one bucket-method MSM over bases stacked after the limb axis; its
    proofs against the rns proofs' bytes, K4 as k4_counts, no fold kernel."""
    import torch

    from bellman_mpc_tpu_torch.groth16 import proof_to_bytes
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with environ(BMT_STACK_MSMS="1"):
        bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="pippenger",
                         pippenger_c=PIPPENGER_C)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert bp.stack_msms
    args = bp.encode_circuits(circuits)
    res, c_step, step_s = counted(kl, lambda: bp.step(*args))
    proofs, c_dec, decode_s = counted(kl, lambda: bp.decode(*res))
    for what, c, n in (("step", c_step, k4["step"]), ("decode", c_dec, k4["decode"])):
        assert c["mont_mul"] == n, ("stacked pippenger", what, c, n)
        check_no_fold(c, f"stacked pippenger {what}")
    assert [proof_to_bytes(p) for p in proofs] == want_bytes, "stacked pippenger: proofs differ from rns's"
    out = {"build_s": build_s, "step_s": step_s, "decode_s": decode_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "k4_step": c_step["mont_mul"]}
    log(f"stacked pippenger: {out}")
    del bp, args, res
    torch.cuda.empty_cache()
    return out


def scan_carries(kl, engine, circuit, rns_out, proofs, k4) -> dict:
    """Phase 12c: under BMT_CARRIES=scan, h(x) of one witness through
    _h_pipeline and the decode of phase 6's rns step equal the flat run's
    limbs and points; each with the flat run's K4 launches."""
    import torch

    from bellman_mpc_tpu_torch.curves.device import g1_device, g2_device
    from bellman_mpc_tpu_torch.groth16.prover import _h_pipeline, synthesize_witness
    from bellman_mpc_tpu_torch.ops.domain import domain_size_for

    fr, host, dev = engine.fr, engine.fr_host, engine.device
    prover = synthesize_witness(engine, circuit)
    m, exp = domain_size_for(len(prover.a), host)
    abc = [fr.encode(list(v) + [0] * (m - len(v)), device=dev) for v in (prover.a, prover.b, prover.c)]
    g_a, g_b, g_c = rns_out

    def decode():
        return (g1_device.decode_points(tuple(x[..., 0] for x in g_a)),
                g2_device.decode_points(tuple(x[..., 0] for x in g_b)),
                g1_device.decode_points(tuple(x[..., 0] for x in g_c)))

    out = {}
    runs = {}
    for carries in ("flat", "scan"):
        with environ(BMT_CARRIES=carries):
            h, c_h, out[f"h_{carries}_s"] = counted(kl, lambda: _h_pipeline(fr, host, exp)(*abc))
            pts, c_d, out[f"decode_{carries}_s"] = counted(kl, decode)
        assert c_h["mont_mul"] == 15 * exp + 10 and c_d["mont_mul"] == k4["decode"], (carries, c_h, c_d)
        check_no_fold(c_h, f"{carries} h(x)")
        check_no_fold(c_d, f"{carries} decode")
        runs[carries] = (h, pts)
    assert torch.equal(runs["scan"][0], runs["flat"][0]), "scan carries: h(x) limbs differ from flat's"
    assert runs["scan"][1] == runs["flat"][1] == ([p.a for p in proofs], [p.b for p in proofs],
                                                  [p.c for p in proofs]), "scan carries: decoded points differ"
    log(f"scan carries: {out}")
    return out


def opt_ins_phase(kl, engine, params, constants, circuits, proofs, k4, rns_out) -> dict:
    """Phase 12: the opt-ins of BatchProver (a) BMT_GLV=1, BMT_MERGE_G1=1
    and both, (b) BMT_STACK_MSMS=1 with pippenger, (c) BMT_CARRIES=scan."""
    from bellman_mpc_tpu_torch.groth16 import proof_to_bytes

    want_bytes = [proof_to_bytes(p) for p in proofs]
    out = {name: opt_in(kl, engine, params, constants, circuits, want_bytes, k4, name) for name in OPT_INS}
    out["stacked_pippenger"] = stacked_pippenger(kl, engine, params, constants, circuits, want_bytes, k4)
    out["scan_carries"] = scan_carries(kl, engine, circuits[0], rns_out, proofs, k4)
    return out


BENCH_KEYS = {"bench", "value", "unit"}  # every line of the reference's _emit
# the mock field's two-adicity stops its domains at 2^9, below MiMC-322's
# 2^10 (646 constraints), in the reference as in the port: the timed loop
# runs on the mock engine at the reference's small-field size
# (tests/test_models.py), 202 constraints in a domain of 256
MOCK_MIMC_ROUNDS = 100
SHA256_BLOCK_CONSTRAINTS = 25840  # one compression (sha256.rs test_full_block)


@contextlib.contextmanager
def mimc_rounds(rounds: int):
    """Cut the round constants that models/mimc.py's parameter and timing
    helpers draw (they call mimc_constants(field, seed)) to `rounds` for the
    block."""
    import importlib

    mod = importlib.import_module("bellman_mpc_tpu_torch.models.mimc")
    orig = mod.mimc_constants
    mod.mimc_constants = lambda field, seed=42: orig(field, seed, rounds)
    try:
        yield
    finally:
        mod.mimc_constants = orig


@contextlib.contextmanager
def recorded(module, name: str, calls: list):
    """For the block, module.name records (args, result) of each call in
    `calls` (the benches import their entry points when they run)."""
    fn = getattr(module, name)

    def spy(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def no_plain(counts: dict, what: str) -> None:
    assert counts["mont_mul"] > 0 and counts["mont_mul_plain"] == counts["lazy_plain"] == 0, (what, counts)


def gadget_hashes() -> dict:
    """Phase 13d: one SHA-256 compression of 512 allocated bits (a 55-byte
    message, padded to one block) and one BLAKE2s of 32 bytes through the
    port's TestConstraintSystem, against hashlib."""
    import hashlib

    from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
    from bellman_mpc_tpu_torch.gadgets import AllocatedBit, Boolean, blake2s, bytes_to_bits, bytes_to_bits_le
    from bellman_mpc_tpu_torch.gadgets.sha256 import get_sha256_iv, sha256_compression_function
    from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem

    rng = random.Random(13)
    msg = bytes(rng.randrange(256) for _ in range(55))
    block = msg + b"\x80" + (8 * len(msg)).to_bytes(8, "big")
    t0 = time.perf_counter()
    cs = TestConstraintSystem(fr_host)
    bits = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"input bit {i}"), b))
            for i, b in enumerate(bytes_to_bits(block))]
    words = sha256_compression_function(cs.namespace("sha256"), bits, get_sha256_iv())
    got = [b.get_value() for w in words for b in w.into_bits_be()]
    assert cs.is_satisfied(), cs.which_is_unsatisfied()
    assert len(bits) == 512 and cs.num_constraints() - 512 == SHA256_BLOCK_CONSTRAINTS, cs.num_constraints()
    assert got == bytes_to_bits(hashlib.sha256(msg).digest()), "SHA-256 gadget differs from hashlib"
    sha_s = time.perf_counter() - t0
    data = bytes(rng.randrange(256) for _ in range(32))
    t0 = time.perf_counter()
    cs2 = TestConstraintSystem(fr_host)
    bits2 = [Boolean.from_bit(AllocatedBit.alloc(cs2.namespace(f"input bit {i}"), b))
             for i, b in enumerate(bytes_to_bits_le(data))]
    got2 = [b.get_value() for b in blake2s(cs2, bits2, b"12345678")]
    assert cs2.is_satisfied(), cs2.which_is_unsatisfied()
    assert got2 == bytes_to_bits_le(hashlib.blake2s(data, digest_size=32, person=b"12345678").digest())
    return {"sha256_block_s": sha_s, "sha256_constraints": cs.num_constraints(),
            "blake2s_32_s": time.perf_counter() - t0, "blake2s_constraints": cs2.num_constraints()}


def host_surface_phase(kl, device) -> dict:
    """Phase 13: (a) ffi.test_bellman and ffi.process; (b) timed_prove_verify
    on DummyEngine on the card (K4 at L = 2), after the MiMC-322 circuit is
    refused by the mock field as by the reference; (c) each ported bench at
    quick on the card, its JSON line printed, K4 launched, no plain
    multiply; (d) gadget_hashes."""
    import io

    from bellman_mpc_tpu_torch import benches, ffi
    from bellman_mpc_tpu_torch.curves import pairing_host as ph
    from bellman_mpc_tpu_torch.groth16 import DummyEngine
    from bellman_mpc_tpu_torch.ops import pairing as dp
    from bellman_mpc_tpu_torch.models.mimc import neo_create_parameters, timed_prove_verify
    from bellman_mpc_tpu_torch.r1cs import PolynomialDegreeTooLarge

    out = {}
    t_phase = time.perf_counter()
    assert ffi.test_bellman() is None
    t0 = time.perf_counter()
    assert ffi.process() == [5_000_000] * 10
    out["process_s"] = time.perf_counter() - t0

    dummy = DummyEngine(device)
    assert raises(PolynomialDegreeTooLarge, lambda: neo_create_parameters(dummy))
    with mimc_rounds(MOCK_MIMC_ROUNDS):
        (prove_avg, verify_avg), c, s = counted(kl, lambda: timed_prove_verify(dummy, samples=3))
    assert prove_avg > 0 and verify_avg > 0, (prove_avg, verify_avg)
    no_plain(c, "timed_prove_verify")
    check_no_fold(c, "timed_prove_verify")
    out["timed_prove_verify"] = {"rounds": MOCK_MIMC_ROUNDS, "samples": 3, "avg_prove_s": prove_avg,
                                 "avg_verify_s": verify_avg, "s": s, "k4": c["mont_mul"]}

    # K4 per bench at quick: six forward NTTs of 2^10 (one multiply per
    # stage), and one pairing_batch (pairing_k4_counts)
    k4_exact = {"ntt": 6 * 10, "pairing": pairing_k4_counts()["pairing_batch"]}
    out["benches"] = {}
    pairings = []  # bench_pairing's pairs and values, held against the host oracle below
    for name in benches.DEFAULT_BENCHES:  # the four ported ones
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), recorded(dp, "pairing_batch", pairings):
            _, c, s = counted(kl, lambda: getattr(benches, f"bench_{name}")(True, device))
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        for line in lines:
            print(json.dumps(line), flush=True)
            assert BENCH_KEYS <= set(line) and line["value"] > 0, line
        assert len(lines) == (2 if name == "batch_verify" else 1), lines
        no_plain(c, f"bench_{name}")
        if name in k4_exact:  # one multiply in the bench's warm-up, then the bench's own
            assert c["mont_mul"] == 1 + k4_exact[name], (name, c, k4_exact[name])
        if name == "batch_verify":  # its items come from one rns BatchProver step
            assert c["rns_fold_window"] > 0 and c["rns_fold_window_g2"] > 0, c
        else:
            check_no_fold(c, f"bench_{name}")
        out["benches"][name] = {"s": s, "lines": lines, "k4": c["mont_mul"],
                                "k1": c["rns_fold_window"], "k2": c["rns_fold_window_g2"]}
    (g1s, g2s, _), vals = pairings[0]
    assert len(pairings) == 1 and len(vals) == 8
    t0 = time.perf_counter()
    assert vals == [ph.pairing(p, q) for p, q in zip(g1s, g2s)], "pairing_batch != host oracle"
    out["host_pairing_8_s"] = time.perf_counter() - t0
    out["pairing_batch_8_s"] = out["benches"]["pairing"]["lines"][0]["total_s"]
    out["gadgets"] = gadget_hashes()
    out["s"] = time.perf_counter() - t_phase
    return out


MESH_SHAPE = (2, 2)  # phase 14a: four logical shards of the one card
MESH_MSM_BASES = 64  # phase 14c, at B = 2 on a (2, 4) mesh (tests/test_sharded.py's shape)
# phase 14c's ladder: cut from (2, 4) to (1, 2) for the script's time (each
# logical shard runs 255 launch-bound bit steps in turn: 48-65 s at (2, 4)
# on one H100 at 700 W, by host); the table MSMs keep (2, 4)
MESH_LADDER_SHAPE = (1, 2)


def sharded_h_k4(exp: int, d: int) -> int:
    """K4 launches of _h_pipeline_sharded over d "model" shards at 2^exp:
    per sharded NTT d x (2 + exp - log2 d) multiplies (the size-d DFT, the
    twiddle, the row NTTs) and d more on inverse (the row NTT's 1/N2, the
    1/N1); 4 inverse and 3 forward NTTs, then distribute_powers and the
    pointwise products as in _h_pipeline."""
    e2 = exp - (d.bit_length() - 1)
    return d * (7 * e2 + 22) + 8 * exp + 6


def mont_batch(bp, args):
    """The (a, b, c) Montgomery limbs (L, B, m) of encoded circuits, as
    BatchProver.step unpacks them."""
    import torch

    fr = bp.fr

    def unpack(x8):
        B, k, nb = x8.shape
        return fr.unpack_device(x8.reshape(B * k, nb)).reshape(fr.L, B, k)

    abc = fr.to_mont(torch.stack([unpack(x) for x in args[:3]], dim=1))
    return abc[:, 0], abc[:, 1], abc[:, 2]


def mesh_prove(kl, engine, params, constants, circuits, want_bytes, k4, mesh, shared=None) -> dict:
    """Phase 14a (and e): BatchProver(mesh=) built, then prove_batch, its
    step and decode timed and counted apart; every proof equal to phase 5's
    in its 192 bytes, K4 as k4_counts says (the MSMs' point operations are
    lazy columns), no fold kernel, no plain multiply.  With `shared`, the
    tables come from phase 11's build (SharedTables)."""
    import torch

    from bellman_mpc_tpu_torch.groth16 import proof_to_bytes
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shared.serving() if shared else contextlib.nullcontext():
        bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tables = [[n, k, c] for n, k, c, _ in bp.table_info()]
    assert bp.msm_strategy == "table" and all(c == 8 for _, _, c in tables), tables
    parts = {}

    def part(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            before = dict(kl.launch_counts)
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            parts[name] = (time.perf_counter() - t, {k: v - before[k] for k, v in kl.launch_counts.items()})
            return out
        return run

    bp.step, bp.decode = part("step", bp.step), part("decode", bp.decode)
    proofs, c, prove_s = counted(kl, lambda: bp.prove_batch(circuits))
    (step_s, c_step), (decode_s, c_dec) = parts["step"], parts["decode"]
    assert c_step["mont_mul"] == k4["step"] and c_dec["mont_mul"] == k4["decode"], (c_step, c_dec, k4)
    assert c["mont_mul_plain"] == 0, c
    check_no_fold(c, f"mesh {mesh.shape} prove_batch")
    assert [proof_to_bytes(p) for p in proofs] == want_bytes, f"mesh {mesh.shape}: proofs differ from rns's"
    out = {"shape": [mesh.shape["data"], mesh.shape["model"]], "devices": [str(x) for r in mesh.grid for x in r],
           "build_s": build_s, "prove_batch_s": prove_s, "step_s": step_s, "decode_s": decode_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "k4_step": c_step["mont_mul"], "k4_decode": c_dec["mont_mul"], "tables": tables}
    del bp
    torch.cuda.empty_cache()
    return out


def sharded_h(kl, bp_args, engine, exp: int) -> dict:
    """Phase 14b: h(x) of phase 5's batch through _h_pipeline_sharded on a
    (1, 4) mesh (N1 = 4) gives _h_pipeline's canonical limbs; K4 as
    sharded_h_k4.  The two transforms may leave a value in another lazy
    form below 2p (0 as p in MiMC's top coefficient, which the prover
    drops), so the raw lanes that differ are counted, not required equal."""
    import torch

    from bellman_mpc_tpu_torch.groth16.prover import _h_pipeline, _h_pipeline_sharded
    from bellman_mpc_tpu_torch.parallel import make_mesh

    bp, args = bp_args
    abc = mont_batch(bp, args)
    mesh = make_mesh(4, shape=(1, 4), devices=[engine.device] * 4)
    got, c, s = counted(kl, lambda: _h_pipeline_sharded(engine.fr, engine.fr_host, exp, mesh)(*abc))
    assert c["mont_mul"] == sharded_h_k4(exp, 4) and c["mont_mul_plain"] == 0, c
    check_no_fold(c, "sharded h(x)")
    want, c_local, s_local = counted(kl, lambda: _h_pipeline(engine.fr, engine.fr_host, exp)(*abc))
    fr = engine.fr
    assert torch.equal(fr.canon(got), fr.canon(want)), "sharded h(x) != _h_pipeline's"
    return {"shape": [1, 4], "B": abc[0].shape[1], "m": 1 << exp, "s": s, "local_s": s_local,
            "k4": c["mont_mul"], "k4_local": c_local["mont_mul"],
            "raw_lanes_differ": int((got != want).any(0).sum())}


def sharded_msms(kl, device) -> dict:
    """Phase 14c: sharded_msm_table and sharded_msm_table_affine (c = 4) on
    64 G1 bases k G (k = 1..64), B = 2, on a (2, 4) mesh of logical shards,
    and sharded_msm (the ladder) on MESH_LADDER_SHAPE, each equal to the
    host oracle (sum_k s_k k) G; a (1, 3) mesh over 48 bases raises the
    butterfly's power-of-two ValueError before any shard's work."""
    import torch

    from bellman_mpc_tpu_torch.curves import host as chost
    from bellman_mpc_tpu_torch.curves.device import g1_device, scalars_to_bits
    from bellman_mpc_tpu_torch.fields.bls12_381 import R
    from bellman_mpc_tpu_torch.ops.msm import digits_from_bits, signed_digits, window_tables, window_tables_affine
    from bellman_mpc_tpu_torch.parallel import make_mesh
    from bellman_mpc_tpu_torch.parallel.sharded import sharded_msm, sharded_msm_table, sharded_msm_table_affine

    rng = random.Random(14)
    n, B, c = MESH_MSM_BASES, 2, 4
    G = chost.G1.generator
    bases = [chost.G1.mul(G, k + 1) for k in range(n)]
    scalars = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
    want = [chost.G1.mul(G, sum(s * (k + 1) for k, s in enumerate(row)) % R) for row in scalars]
    pts = g1_device.encode_points(bases, device)
    bits = torch.stack([scalars_to_bits(s, NBITS, device) for s in scalars], dim=1)
    mesh = make_mesh(8, shape=(2, 4), devices=[device] * 8)
    ops = g1_device.ops
    out = {"n": n, "B": B, "shape": [2, 4], "ladder_shape": list(MESH_LADDER_SHAPE)}
    t0 = time.perf_counter()
    tab = window_tables(ops, pts, c)
    atab = window_tables_affine(ops, pts, c)
    torch.cuda.synchronize()
    out["tables_s"] = time.perf_counter() - t0
    d, m = MESH_LADDER_SHAPE
    ladder_mesh = make_mesh(d * m, shape=MESH_LADDER_SHAPE, devices=[device] * (d * m))
    runs = {"ladder": lambda: sharded_msm(ladder_mesh, ops, pts, bits),
            "table": lambda: sharded_msm_table(mesh, ops, tab, digits_from_bits(bits, c)),
            "table_affine": lambda: sharded_msm_table_affine(mesh, ops, atab,
                                                             signed_digits(digits_from_bits(bits, c), c))}
    for name, fn in runs.items():
        res, cnt, s = counted(kl, fn)
        assert res[0].shape[-2:] == (B, 1) and res[0].device == device, res[0].shape
        got = g1_device.decode_points(tuple(x[..., 0] for x in res))
        assert all(chost.G1.eq(g, w) for g, w in zip(got, want)), f"sharded {name} MSM != host oracle"
        assert cnt["mont_mul_plain"] == 0, cnt
        check_no_fold(cnt, f"sharded {name} MSM")
        out[name] = {"s": s, "k4": cnt["mont_mul"]}
    mesh3 = make_mesh(3, shape=(1, 3), devices=[device] * 3)
    assert raises(ValueError, lambda: sharded_msm(mesh3, ops, g1_device.encode_points(bases[:48], device),
                                                  bits[..., :48])), "(1, 3) mesh not refused"
    return out


def mesh_phase(kl, engine, params, constants, circuits, proofs, k4, shared=None) -> dict:
    """Phase 14: (a) BatchProver on a (2, 2) mesh of logical shards of the
    card; (b) the sharded h(x); (c) the three sharded MSMs and the
    butterfly's refusal; (d) bench_scaling at quick (one card: the d = 1
    line); (e) with two cards or more, (a) again on a mesh of real cards."""
    import io

    import torch

    from bellman_mpc_tpu_torch import benches
    from bellman_mpc_tpu_torch.groth16 import proof_to_bytes
    from bellman_mpc_tpu_torch.parallel import BatchProver, make_mesh

    t_phase = time.perf_counter()
    dev = engine.device
    want_bytes = [proof_to_bytes(p) for p in proofs]
    mesh = make_mesh(4, shape=MESH_SHAPE, devices=[dev] * 4)
    out = {"logical": mesh_prove(kl, engine, params, constants, circuits, want_bytes, k4, mesh, shared)}
    if shared:
        out["logical"]["tables_from_phase_11"] = shared.hits
        shared.store.clear()
    log(f"mesh {MESH_SHAPE}: {out['logical']}")
    bp1 = BatchProver(engine, params, circuits[0], msm_strategy="ladder")  # its encoder only
    exp = bp1.m.bit_length() - 1
    out["sharded_h"] = sharded_h(kl, (bp1, bp1.encode_circuits(circuits)), engine, exp)
    del bp1
    out["msms"] = sharded_msms(kl, dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, c, s = counted(kl, lambda: benches.bench_scaling(True))
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    for line in lines:
        print(json.dumps(line), flush=True)
        assert BENCH_KEYS <= set(line) and line["value"] > 0, line
    assert [x["devices"] for x in lines] == [d for d in (1, 2, 4, 8) if d <= torch.cuda.device_count()], lines
    no_plain(c, "bench_scaling")
    check_no_fold(c, "bench_scaling")
    out["bench_scaling"] = {"s": s, "k4": c["mont_mul"], "values": [[x["devices"], x["value"]] for x in lines]}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = make_mesh(4, shape=(2, 2)) if n_cards >= 4 else make_mesh(2, shape=(1, 2))
        out["cards"] = mesh_prove(kl, engine, params, constants, circuits, want_bytes, k4, cards)
    out["s"] = time.perf_counter() - t_phase
    return out


def int32_ops_per_s() -> float:
    """The card's peak rate of 32-bit integer instructions: SMs x 64 per
    clock x the maximum SM clock that nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip())
    return torch.cuda.get_device_properties(0).multi_processor_count * INT32_PER_CLOCK_PER_SM * mhz * 1e6


def rns_mul_ops(k: int = 35):
    """(tensor-core ops, int32 instructions) of one RNS Montgomery multiply
    per lane, counting only what the algorithm cannot skip, each on the
    fastest exact unit the card has for it.  The two base extensions' k (k
    + 1) multiply-adds each go on the int8 tensor cores: 12-bit operands
    split into 6-bit halves make 4 int8 products per multiply-add, each a
    multiply and an add (2 ops).  The rest are three int32 instructions
    (product, Barrett high product, multiply-subtract) for each of the 2k+1
    channel products, the k kappa, k+1 M^-1, k (M'/m')^-1 and k correction
    products and the 2(k+1) extension reductions."""
    tensor = 2 * k * (k + 1) * 4 * 2
    int32 = 3 * ((2 * k + 1) + k + (k + 1) + k + 2 * (k + 1) + k)
    return tensor, int32


def mont_mul_ops(f) -> int:
    """Integer instructions per lane of the least Montgomery product of two
    L-limb inputs: pack each into s 32-bit words and unpack the result (3
    per limb each), then CIOS Montgomery over s words: s^2 word products for
    a*b and s^2 for m*p, each a low and a high multiply-add and two carry
    adds, plus s products for m.  Far fewer than the 11-bit-limb
    algorithm's, so that the bound is what the function needs."""
    s = -(-(2 * f.p).bit_length() // 32)
    return 9 * f.L + 8 * s * s + s


def bound(nbytes: float, int_ops: float, int_rate: float, tensor_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate,
    the int32 instructions over the card's integer rate and the tensor-core
    ops over the int8 tensor-core rate (the two units run side by side)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / int_rate, tensor_ops / INT8_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mont_mul_bound(int_rate: float, lanes: int):
    """K4's (bound_ms, bound_by) at (24, lanes): a, b read and the output
    written once, or the Fr Montgomery product's operations."""
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr

    return bound(3 * fr.L * lanes * 4, mont_mul_ops(fr) * lanes, int_rate)


def fold_bound(int_rate: float, name: str, lanes: int):
    """A fold window's (bound_ms, bound_by) at `lanes`: the accumulator and
    the gathered point read, the accumulator written and the sign read once
    (int32 words; the 71 real RNS channels, not the 80-row padded tiles),
    or its RNS multiplies' operations (K1 11, K2 33)."""
    row = 71 * 4
    tc, i32 = rns_mul_ops()
    muls, rows = (11, 8) if name == "rns_fold_window" else (33, 16)
    return bound((rows * row + 4) * lanes, muls * i32 * lanes, int_rate, muls * tc * lanes)


def kernel_bounds(int_rate: float, k3_lanes: int, fold_lanes: dict, mont_lanes: int):
    """bound_ms and bound_by of each kernel at the shapes it was timed at:
    each input read once and each output written once (int32 words; the 71
    real RNS channels, not the 80-row padded tiles), and the RNS multiplies'
    (K1 11, K2 33) or the Fr Montgomery product's operations."""
    tc, i32 = rns_mul_ops()
    return {
        "mont_mul": mont_mul_bound(int_rate, mont_lanes),
        "rns_mul_many": bound(3 * 71 * 4 * k3_lanes, i32 * k3_lanes, int_rate, tc * k3_lanes),
        **{name: fold_bound(int_rate, name, fold_lanes[name]) for name in ("rns_fold_window", "rns_fold_window_g2")},
    }


def windows(c: int, nbits: int = NBITS) -> int:
    return -(-nbits // c) + 1


def time_steps(bp, args, n: int = 3):
    import torch

    steps = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bp.step(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return steps


def counted(kl, fn):
    """Run fn() with every launch count set to 0 just before it; returns
    (result, the counts read just after, seconds).  `mont_mul_plain` counts
    the calls of K4's plain version on a CUDA tensor, `lazy_plain` those of
    K5's and K6's, `tree_plain` those of K7's; `lazy_products` and `lazy_reductions` count the calls of
    LimbField.lazy_mul_many and LazyCols.reduce (on any device), each of
    which launches K5 or K6 once on a CUDA tensor."""
    import torch

    from bellman_mpc_tpu_torch.fields.limb import LazyCols, LimbField

    calls = {"lazy_products": 0, "lazy_reductions": 0}
    spied = [(LimbField, "lazy_mul_many", "lazy_products"), (LazyCols, "reduce", "lazy_reductions")]
    originals = [getattr(cls, name) for cls, name, _ in spied]

    def spy(fn_, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn_(*a, **kw)
        return wrapped

    for (cls, name, key), orig in zip(spied, originals):
        setattr(cls, name, spy(orig, key))
    kl.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for (cls, name, _), orig in zip(spied, originals):
            setattr(cls, name, orig)
    lazy_plain = kl.plain_counts["lazy_cols"] + kl.plain_counts["lazy_redc"]
    return (out, dict(kl.launch_counts, mont_mul_plain=kl.plain_counts["mont_mul"], lazy_plain=lazy_plain,
                      tree_plain=kl.plain_counts["rns_tree_add"], **calls),
            time.perf_counter() - t0)


def check_lazy_launches(counts: dict, what: str) -> None:
    """A run on the card: one K5 per lazy product, one K6 per lazy reduction,
    no plain lazy call."""
    assert (counts["lazy_cols"] == counts["lazy_products"] and counts["lazy_redc"] == counts["lazy_reductions"]
            and counts["lazy_plain"] == 0), (what, counts)


def main() -> int:
    t_start = time.perf_counter()
    kernels_only = "--kernels-only" in sys.argv[1:]
    mesh_only = "--mesh-only" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from bellman_mpc_tpu_torch import native
    from bellman_mpc_tpu_torch.ops import kernel_lib as kl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # phase 2: build
    build_s = kl.build(verbose=True)
    print(f"build: {build_s:.3f} s (nvcc, sm_90a, one process per source)", flush=True)

    # phase 3: kernel vs plain
    rng = random.Random(2024)
    checks = check_kernels(device, rng)
    checks["mont_mul"] = check_mont_mul(device, rng)
    checks["lazy"] = check_lazy(device, rng)
    checks["tree"] = check_tree(device, rng)
    print("kernel checks: " + json.dumps(checks), flush=True)
    if kernels_only:
        return 0

    # phase 4: setup
    from bellman_mpc_tpu_torch import ffi
    from bellman_mpc_tpu_torch.groth16 import (
        Bls12Engine,
        create_random_proof,
        generate_random_parameters,
        prepare_verifying_key,
        proof_to_bytes,
        verify_proof,
    )
    from bellman_mpc_tpu_torch.models import MiMCDemo, RangeDemo, mimc, mimc_constants
    from bellman_mpc_tpu_torch.parallel import BatchProver

    engine = Bls12Engine()
    assert engine.device == device
    host = engine.fr_host
    constants = mimc_constants(host, seed=42)
    t0 = time.perf_counter()
    params = ffi.test_create_parameters()  # MiMC-322 from seed 42, on Bls12Engine() (the card)
    setup_s = time.perf_counter() - t0
    log(f"setup (MiMC-{len(constants)}): {setup_s:.3f} s")
    t0 = time.perf_counter()
    bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    torch.cuda.synchronize()
    prover_build_s = time.perf_counter() - t0
    info = bp.table_info()
    log(f"prover build {prover_build_s:.3f} s; m={bp.m}, tables " + ", ".join(
        f"{n}: n={k} c={c} {b / 2**30:.3f} GiB" for n, k, c, b in info))
    assert all(c == 8 for _, _, c, _ in info), "window width differs from pick_table_c's 8"

    # phase 5: the main path, counted
    assert native.available(), "native LC evaluator did not build"
    prng = random.Random(0)
    wit = [(prng.randrange(host.p), prng.randrange(host.p)) for _ in range(B_PROOFS)]
    circuits = [MiMCDemo(constants, xl, xr) for xl, xr in wit]
    k4 = k4_counts(bp.m.bit_length() - 1)
    proofs, counts, prove_s = counted(kl, lambda: bp.prove_batch(circuits))
    log(f"prove_batch B={B_PROOFS}: {prove_s:.3f} s, launches {counts}")
    W = windows(8)
    assert counts["rns_fold_window"] == 4 * W and counts["rns_fold_window_g2"] == W, counts
    assert counts["mont_mul"] == k4["step"] + k4["decode"] and counts["rns_mul_many"] == 0, (counts, k4)
    assert counts["mont_mul_plain"] == 0, counts
    check_lazy_launches(counts, "prove_batch")
    assert counts["lazy_cols"] > 0 and counts["lazy_redc"] > 0, counts
    # K7 once per level of every MSM's tree reduction: 48 at MiMC-322's widths
    trees = derived_trees(bp)
    assert trees == tree_launches(MIMC322_WIDTHS, 1) == 48, trees
    assert counts["rns_tree_add"] == trees and counts["tree_plain"] == 0, counts
    if mesh_only:
        del bp
        torch.cuda.empty_cache()
        mp = mesh_phase(kl, engine, params, constants, circuits, proofs, k4)
        print("mesh: " + json.dumps(mp) + f" on {smi} (the shards of a one-card mesh share the card)", flush=True)
        return 0
    pvk = prepare_verifying_key(engine, params.vk)
    inputs = [[mimc(host, xl, xr, constants)] for xl, xr in wit]
    ver = verify_on_card(kl, engine, params, pvk, proofs, inputs)
    print(f"verified {len(proofs)}/{B_PROOFS} proofs on the card: one BatchVerifier "
          f"{ver['batch_verify_s']:.3f} s, proof 0 alone {ver['verify_single_s']:.3f} s, wrong input "
          f"rejected; host oracle on {HOST_VERIFIED} {ver['host_verify_s']:.3f} s", flush=True)

    # phase 6: timings
    args = bp.encode_circuits(circuits)
    rns_out, step_counts, _ = counted(kl, lambda: bp.step(*args))
    assert step_counts["mont_mul"] == k4["step"] and step_counts["mont_mul_plain"] == 0, step_counts
    check_lazy_launches(step_counts, "step")
    assert step_counts["lazy_cols"] > 0 and step_counts["lazy_redc"] > 0, step_counts
    decoded, decode_counts, decode_s = counted(kl, lambda: bp.decode(*rns_out))
    assert decode_counts["mont_mul"] == k4["decode"] and decode_counts["mont_mul_plain"] == 0, decode_counts
    check_lazy_launches(decode_counts, "decode")
    assert step_counts["rns_tree_add"] == trees and decode_counts["rns_tree_add"] == 0, (step_counts, decode_counts)
    assert counts["lazy_cols"] == step_counts["lazy_cols"] + decode_counts["lazy_cols"], (counts, step_counts)
    assert counts["lazy_redc"] == step_counts["lazy_redc"] + decode_counts["lazy_redc"], (counts, step_counts)
    assert decoded == proofs
    log(f"step: K4 {step_counts['mont_mul']}, K5 {step_counts['lazy_cols']}, K6 {step_counts['lazy_redc']} "
        f"launches; decode: K4 {decode_counts['mont_mul']}, K5 {decode_counts['lazy_cols']}, "
        f"K6 {decode_counts['lazy_redc']}, {decode_s:.3f} s")
    steps = time_steps(bp, args)
    step_s = statistics.median(steps)
    rns_aten_ops = step_ops(bp, args)["aten_ops"]
    fold_times = time_fold_windows(bp, rng)
    m = bp.m
    del bp, args
    torch.cuda.empty_cache()

    # phase 7: the sequential prover
    seq, counts_seq, seq_s = counted(
        kl, lambda: create_random_proof(engine, MiMCDemo(constants, *wit[0]), params))
    log(f"sequential proof: {seq_s:.3f} s, launches {counts_seq}")
    assert counts_seq["mont_mul"] == k4["sequential"] and counts_seq["mont_mul_plain"] == 0, counts_seq
    assert counts_seq["rns_fold_window"] == counts_seq["rns_fold_window_g2"] == 0, counts_seq
    assert seq == proofs[0], "the sequential proof differs from batch proof 0"
    assert proof_to_bytes(seq) == proof_to_bytes(proofs[0]) and len(proof_to_bytes(seq)) == 192
    # the same 192 bytes as batch proof 0, which verify_proof checked on the card in phase 5
    print("sequential proof == batch proof 0 (192 bytes)", flush=True)

    # phase 8: RangeDemo, the chip gate's second shape
    def range_circ(d):
        w = 8 + d
        return RangeDemo(a=1, b=1 + d, n=4, w=w, wArray=[(w >> i) & 1 for i in range(4)],
                         less_or_equal=1, less=1, not_all_zeros=1)

    t0 = time.perf_counter()
    r_params = generate_random_parameters(engine, RangeDemo(
        a=1, b=2, n=4, w=9, wArray=[0, 0, 0, 0], less_or_equal=1, less=1, not_all_zeros=1))
    r_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bp_r = BatchProver(engine, r_params, range_circ(1), msm_strategy="rns")
    torch.cuda.synchronize()
    r_build_s = time.perf_counter() - t0
    r_info = bp_r.table_info()
    ds = [1 + (i % 7) for i in range(B_PROOFS)]
    r_proofs, r_counts, r_prove_s = counted(kl, lambda: bp_r.prove_batch([range_circ(d) for d in ds]))
    log(f"RangeDemo m={bp_r.m} tables {[(n, k, c) for n, k, c, _ in r_info]}: "
        f"prove_batch {r_prove_s:.3f} s, launches {r_counts}")
    cs = {n: c for n, _, c, _ in r_info}
    k4_r = k4_counts(bp_r.m.bit_length() - 1)
    assert r_counts["mont_mul"] == k4_r["step"] + k4_r["decode"] and r_counts["mont_mul_plain"] == 0, r_counts
    assert r_counts["rns_fold_window"] == sum(windows(cs[n]) for n in ("h", "l", "a", "b1")), r_counts
    assert r_counts["rns_fold_window_g2"] == windows(cs["b2"]), r_counts
    assert len(r_params.vk.ic) < 4
    _, c, r_verify_s = counted(
        kl, lambda: batch_verify(engine, r_params.vk, r_proofs, [[1 + d] for d in ds], 3))
    check_pairing_counts(c, ver["k4_per_verify"], "BatchVerifier.verify (RangeDemo)")
    r_seq, r_seq_counts, r_seq_s = counted(
        kl, lambda: create_random_proof(engine, range_circ(ds[0]), r_params))
    assert r_seq_counts["mont_mul"] == k4_r["sequential"] and r_seq_counts["mont_mul_plain"] == 0, r_seq_counts
    assert r_seq == r_proofs[0], "RangeDemo sequential proof differs from batch proof 0"
    assert proof_to_bytes(r_seq) == proof_to_bytes(r_proofs[0])
    print(f"RangeDemo: verified {len(r_proofs)}/{B_PROOFS} by one BatchVerifier on the card "
          f"({r_verify_s:.3f} s); sequential proof == batch proof 0", flush=True)

    # phase 9: pairings at scale
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30  # phases 4-8
    del bp_r
    torch.cuda.empty_cache()
    pa = pairings_at_scale(kl, engine, device)
    log(f"pairings: {pa}")
    verify_line = {
        "verify_single_s": ver["verify_single_s"], "batch_verify_16_s": ver["batch_verify_s"],
        "batch_reject_16_s": ver["batch_reject_s"], "host_verify_4_s": ver["host_verify_s"],
        "range_batch_verify_16_s": r_verify_s,
        "pairing_eq_s": pa["pairing_eq_s"], "n_eq": pa["n_eq"], "equations_per_s": pa["equations_per_s"],
        "eq_encode_s": pa["eq_encode_s"], "eq_points_s": pa["eq_points_s"],
        "pairing_peak_mem_gib": pa["pairing_peak_mem_gib"], "k4_per_call": pa["k4"],
    }
    print("verify and pairing: " + json.dumps(verify_line) + f" on {smi}", flush=True)

    # phase 10: the ceremony
    cer = ceremony(kl, engine, device, random.Random(10))
    log(f"ceremony: {cer}")
    mk, lc, ck, tr = cer["mock"], cer["lagrange_anddemo"], cer["check"], cer["transform"]
    ceremony_line = {
        "mock_s": mk["s"], "mock_setup_s": mk["setup_s"], "mock_proof_s": mk["proof_s"],
        "mock_proofs": mk["proofs"], "mock_k4_L2": mk["k4"],
        "anddemo_s": lc["s"], "anddemo_lagrange_s": lc["lagrange_s"],
        "anddemo_direct_setup_s": lc["direct_setup_s"], "anddemo_verify_s": lc["verify_s"],
        "bad_reject_s": lc["bad_reject_s"],
        "lagrange_k4": lc["lagrange_k4"],
        "check_powers": ck["n_powers"], "check_equations": ck["n_eq"], "check_lanes": ck["lanes"],
        "check_build_s": ck["build_s"], "check_accept_s": ck["check_s"], "check_reject_s": ck["reject_s"],
        "check_equations_per_s": ck["equations_per_s"], "k4_per_check": ck["k4_per_check"],
        "check_build_k4": ck["build_k4"], "host_g1_mul_s": ck["host_g1_mul_s"],
        "host_g2_mul_s": ck["host_g2_mul_s"],
        "intt_m": tr["m"], "g1_intt_s": tr["g1_intt_s"], "g2_intt_s": tr["g2_intt_s"],
        "g1_intt_k4": tr["g1_k4"], "g2_intt_k4": tr["g2_k4"],
        "ceremony_peak_mem_gib": cer["peak_mem_gib"],
    }
    print("ceremony: " + json.dumps(ceremony_line) + f" on {smi}", flush=True)

    # phase 11: the limb strategies, the comb setup, the pippenger sequential
    # proof and h(x) through EvaluationDomain
    shared = SharedTables()
    st = strategies_phase(kl, engine, params, constants, circuits, proofs, k4, shared)
    strategy_line = {"rns": {"build_s": prover_build_s, "step_s": step_s, "decode_s": decode_s,
                             "k4_step": step_counts["mont_mul"]},
                     **st["strategies"], "ladder_setup_s": setup_s, "comb_setup_s": st["comb_setup_s"],
                     "ladder_sequential_s": seq_s, "pippenger_sequential_s": st["pippenger_sequential_s"],
                     "domain_h": st["domain_h"]}
    print("strategies: " + json.dumps(strategy_line) + f" on {smi}", flush=True)

    # phase 12: the opt-ins (GLV-2/GLS-4, merged G1, both; stacked MSMs; scan carries)
    oi = opt_ins_phase(kl, engine, params, constants, circuits, proofs, k4, rns_out)
    opt_in_line = {"rns": {"build_s": prover_build_s, "step_s": step_s, "steps_s": steps, "decode_s": decode_s,
                           "peak_mem_gib_phases_4_8": peak_mem_gib, "k1_step": counts["rns_fold_window"],
                           "k2_step": counts["rns_fold_window_g2"],
                           "k4_step": step_counts["mont_mul"], "aten_ops_step": rns_aten_ops},
                   **oi}
    print("opt-ins: " + json.dumps(opt_in_line) + f" on {smi}", flush=True)

    # phase 13: the host surface (ffi, the MiMC timing loop, the benches, the gadgets)
    hs = host_surface_phase(kl, device)
    host_line = {
        "s": hs["s"], "process_s": hs["process_s"], "timed_prove_verify": hs["timed_prove_verify"],
        "pairing_batch_8_s": hs["pairing_batch_8_s"], "host_pairing_8_s": hs["host_pairing_8_s"],
        **{f"bench_{k}": {"s": v["s"], "k4": v["k4"], "k1": v["k1"], "k2": v["k2"],
                          "values": [[x["bench"], x["value"], x["unit"]] for x in v["lines"]]}
           for k, v in hs["benches"].items()},
        **hs["gadgets"],
    }
    print("host surface: " + json.dumps(host_line) + f" on {smi}", flush=True)

    # phase 14: the mesh (logical shards of the card; real cards where there are two or more)
    mp = mesh_phase(kl, engine, params, constants, circuits, proofs, k4, shared)
    print("mesh: " + json.dumps(mp) + f" on {smi} (the shards of a one-card mesh share the card)", flush=True)

    # the kernels' line
    int_rate = int32_ops_per_s()
    k4_timed = checks["mont_mul"]["timed"]
    k4_bounds = {n: mont_mul_bound(int_rate, n) for n in k4_timed}
    bounds = kernel_bounds(int_rate, checks["rns_mul_many"]["lanes"],
                           {k: v["lanes"] for k, v in fold_times.items()}, K4_TIMED_LANES[-1])
    timed = {
        "mont_mul": k4_timed[K4_TIMED_LANES[-1]], "rns_mul_many": checks["rns_mul_many"],
        "rns_fold_window": fold_times["rns_fold_window"],
        "rns_fold_window_g2": fold_times["rns_fold_window_g2"],
    }
    errs = {
        "mont_mul": checks["mont_mul"]["max_abs_err"],
        "rns_mul_many": checks["rns_mul_many"]["max_abs_err"],
        "rns_fold_window": max(checks["rns_fold_window"]["max_abs_err"],
                               fold_times["rns_fold_window"]["max_abs_err"]),
        "rns_fold_window_g2": max(checks["rns_fold_window_g2"]["max_abs_err"],
                                  fold_times["rns_fold_window_g2"]["max_abs_err"]),
    }
    # launches in the main path's run (prove_batch: one B = 16 step and its
    # decode); K3's standalone kernel is never launched there (its multiply
    # runs inside K1 and K2), so its count is 0
    lazy_timed = checks["lazy"]["timed"]
    for name in ("lazy_cols", "lazy_redc"):  # at the step's shape
        timed[name] = lazy_timed[LAZY_TIMED_LANES[0]][name]
        errs[name] = checks["lazy"]["max_abs_err"]
        bounds[name] = (timed[name]["bound_ms"], timed[name]["bound_by"])
    timed["rns_tree_add"] = checks["tree"]["timed"][0]  # a G1 first level of SHA-256's and the Spend's
    errs["rns_tree_add"] = checks["tree"]["max_abs_err"]
    bounds["rns_tree_add"] = (timed["rns_tree_add"]["bound_ms"], timed["rns_tree_add"]["bound_by"])
    launches = {k: counts[k] for k in SOURCES}
    kernels = []
    for name in SOURCES:
        bound_ms, bound_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        if name in ("rns_fold_window", "rns_fold_window_g2"):  # per opt-in, and at its widths
            k = "k1" if name == "rns_fold_window" else "k2"
            kernels[-1].update(
                launches_step_rns=step_counts[name],
                **{f"launches_step_{o}": oi[o][f"{k}_step"] for o in OPT_INS},
                shapes=[{"lanes": w["lanes"], "ms": w["ms"], "plain_ms": w["plain_ms"],
                         "bound_ms": fold_bound(int_rate, name, w["lanes"])[0],
                         "bound_by": fold_bound(int_rate, name, w["lanes"])[1]} for w in checks[name]["wide"]])
        if name == "mont_mul":  # per part of the run, and at both timed shapes
            kernels[-1].update(
                launches_step=step_counts["mont_mul"], launches_decode=decode_counts["mont_mul"],
                launches_verify=ver["k4_per_verify"], launches_batch_verify=ver["k4_per_verify"],
                launches_eq_batch=pa["k4"]["eq_batch"], launches_contribution_check=ck["k4_per_check"],
                launches_mock_proof_L2=mk["k4"], launches_g1_intt=tr["g1_k4"], launches_g2_intt=tr["g2_k4"],
                **{f"launches_step_{k}": v["k4_step"] for k, v in st["strategies"].items()},
                **{f"launches_step_{o}": oi[o]["k4_step"] for o in OPT_INS},
                launches_step_stacked_pippenger=oi["stacked_pippenger"]["k4_step"],
                launches_timed_prove_verify_mock=hs["timed_prove_verify"]["k4"],
                **{f"launches_bench_{k}": v["k4"] for k, v in hs["benches"].items()},
                launches_step_mesh_2x2=mp["logical"]["k4_step"], launches_decode_mesh_2x2=mp["logical"]["k4_decode"],
                launches_sharded_h_1x4=mp["sharded_h"]["k4"], launches_bench_scaling=mp["bench_scaling"]["k4"],
                graph_floor_ms=checks["mont_mul"]["graph_floor_ms"],
                shapes=[{"shape": [24, n], "ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
                         "bound_ms": k4_bounds[n][0], "bound_by": k4_bounds[n][1]} for n, t in k4_timed.items()])
        if name in ("lazy_cols", "lazy_redc"):  # per part of the run, and at both timed shapes
            kernels[-1].update(
                launches_step=step_counts[name], launches_decode=decode_counts[name],
                shapes=[{"shape": [36, n], **t[name]} for n, t in lazy_timed.items()])
        if name == "rns_tree_add":  # per step, per opt-in, at each first level
            kernels[-1].update(
                launches_step=step_counts[name], launches_decode=decode_counts[name],
                **{f"launches_step_{o}": oi[o]["k7_step"] for o in OPT_INS},
                shapes=checks["tree"]["timed"])
    total_s = time.perf_counter() - t_start
    print(json.dumps({
        "setup_s": setup_s, "prover_build_s": prover_build_s, "prove_batch_s": prove_s,
        "step_s": step_s, "steps_s": steps, "proofs_per_s": B_PROOFS / step_s, "decode_s": decode_s,
        "sequential_proof_s": seq_s, "batch_verify_16_s": ver["batch_verify_s"],
        "verify_single_s": ver["verify_single_s"], "host_verify_4_s": ver["host_verify_s"],
        "pairing_batch_8_s": hs["pairing_batch_8_s"], "pairing_eq_s": pa["pairing_eq_s"],
        "range_setup_s": r_setup_s, "range_prover_build_s": r_build_s,
        "range_prove_batch_s": r_prove_s, "range_sequential_proof_s": r_seq_s,
        "range_tables": [[n, k, c] for n, k, c, _ in r_info], "B": B_PROOFS, "m": m,
        "ceremony_check_s": ck["check_s"], "anddemo_ceremony_s": lc["lagrange_s"],
        **{f"{k}_step_s": v["step_s"] for k, v in st["strategies"].items()},
        "comb_setup_s": st["comb_setup_s"],
        **{f"{o}_step_s": oi[o]["step_s"] for o in OPT_INS},
        "stacked_pippenger_step_s": oi["stacked_pippenger"]["step_s"],
        "host_surface_s": hs["s"],
        "mesh_s": mp["s"], "mesh_2x2_build_s": mp["logical"]["build_s"], "mesh_2x2_step_s": mp["logical"]["step_s"],
        **{f"bench_{k}_s": v["s"] for k, v in hs["benches"].items()},
        "peak_mem_gib": peak_mem_gib,
        "int32_ops_per_s": int_rate, "total_s": total_s,
    }), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
