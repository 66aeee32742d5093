#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bellman_mpc_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # the full run (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # phases 1-3 only

Phases (each raises on failure; nothing is caught):
  1. require a CUDA card; print `nvidia-smi --query-gpu=name,power.limit`;
  2. build the fold kernels from bellman_mpc_tpu_torch/csrc with nvcc;
  3. hold each kernel bit-exact against its plain PyTorch version on the
     card: K3 on (71, 16384) residues of random field elements, K1 at 16384
     lanes and K2 at 8192 lanes on encoded curve points with both signs and
     (0, 0) sentinels mixed in, over three chained windows;
  4. setup: generate_random_parameters for MiMC-322 (constants seed 42),
     then BatchProver(msm_strategy="rns") with its padded RNS tables;
  5. prove_batch on B=16 random witnesses, launch counts checked (K1 132
     times, K2 33 times per step), all 16 proofs verified by the port's
     verifier;
  6. timings: table build, median step of 3, proofs/s, and one fold
     window's kernel time beside its plain version's at the main path's
     shapes (gathered from the real tables).

Prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

import json
import random
import statistics
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

B_PROOFS = 16
KERNEL_SOURCE = "bellman_mpc_tpu_torch/csrc/fold_kernels.cu"
REPLACES = {
    "rns_mul_many": "bellman_mpc_tpu/ops/pallas_kernels.py:268",
    "rns_fold_window": "bellman_mpc_tpu/ops/pallas_kernels.py:470",
    "rns_fold_window_g2": "bellman_mpc_tpu/ops/pallas_kernels.py:663",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events), after
    one warm-up call."""
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
    """lanes gathered pool points, every 7th lane the (0, 0) sentinel, and
    random signs."""
    import torch

    idx = torch.tensor([rng.randrange(pool[0].shape[-1]) for _ in range(lanes)], device=device)
    q = tuple(t[..., idx].clone() for t in pool)
    for t in q:
        t[..., ::7] = 0
    sgn = torch.tensor([rng.randrange(2) == 1 for _ in range(lanes)], device=device)
    return q, sgn


def check_kernels(device, rng: random.Random, g1_lanes=16384, g2_lanes=8192):
    """Phase 3: every kernel against its plain version, bit-exact."""
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
    results["rns_mul_many"] = dict(
        lanes=n3, max_abs_err=err,
        ms=cuda_time_ms(lambda: fk.rns_mul_many(f, xs, ys), 20),
        plain_ms=cuda_time_ms(lambda: fk.rns_mul_block_plain(f, xp, yp), 3),
    )
    log(f"K3 rns_mul_many: bit-exact at (71, {n3})")

    for name, group, hostg, rops, lanes, npool in (
        ("rns_fold_window", g1_device, G1, rpt.rns_g1_ops(), g1_lanes, 64),
        ("rns_fold_window_g2", g2_device, G2, rpt.rns_g2_ops(), g2_lanes, 32),
    ):
        g2 = rops.fp2
        pool = point_pool(group, hostg, npool, rng, device)
        tab_bound = rpt.limb_coord_to_rns(f, group.ops.f, group.ops.f.zeros((1,), device)).a
        cap = Fraction(fk.G2_CAP if g2 else fk.G1_CAP)
        acc = tuple(fk.rns_pad_rows(f, v.res) for v in rpt.point_identity(rops, (lanes,), device))
        worst = 0
        for _ in range(3):
            q, sgn = gather_q(pool, lanes, rng, device)
            if g2:
                flat = lambda t: [t[:, 0].contiguous(), t[:, 1].contiguous()]
                plain = fk.fold_window_g2_plain(
                    f, rops.b3c, sum((flat(t) for t in acc), []), sum((flat(t) for t in q), []),
                    sgn.to(torch.int32), fk._tab_n(tab_bound), int(cap))
                plain = tuple(torch.stack([plain[2 * i], plain[2 * i + 1]], dim=1) for i in range(3))
                got = fk.rns_fold_window_g2(f, rops.b3c, acc, q, sgn, tab_bound, cap)
            else:
                plain = fk.fold_window_g1_plain(f, rops.b3, acc, q[0], q[1], sgn.to(torch.int32),
                                                fk._tab_n(tab_bound), int(cap))
                got = fk.rns_fold_window(f, rops.b3, acc, q, sgn, tab_bound, cap)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain)
            worst = max(worst, err)
            assert err == 0, f"{name} disagrees with its plain version: max_abs_err {err}"
            acc = got
        results[name] = dict(lanes=lanes, max_abs_err=worst)
        log(f"{name}: bit-exact over 3 chained windows at {lanes} lanes")
    return results


def time_fold_windows(bp, rng: random.Random):
    """Phase 6b: one window of K1 (h table, 16384 lanes at B=16) and of K2
    (b2 table, 8192 lanes) on gathered table points, kernel vs plain."""
    import torch

    from bellman_mpc_tpu_torch.curves import rns_point as rpt
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk

    f = rpt.default_rns_field()
    dev = bp.device
    out = {}
    for name, crs, rops in (("rns_fold_window", bp.crs_h, rpt.rns_g1_ops()),
                            ("rns_fold_window_g2", bp.crs_b2, rpt.rns_g2_ops())):
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
            flat = lambda t: [t[:, 0].reshape(fk.PAD_C, lanes).contiguous(),
                              t[:, 1].reshape(fk.PAD_C, lanes).contiguous()]
            a_f = sum((flat(t) for t in acc), [])
            q_f = sum((flat(t) for t in q), [])
            plain = lambda: fk.fold_window_g2_plain(f, b, a_f, q_f, sgn.reshape(-1).to(torch.int32),
                                                    fk._tab_n(bound), int(cap))
        else:
            a_f = [t.reshape(fk.PAD_C, lanes).contiguous() for t in acc]
            q_f = [t.reshape(fk.PAD_C, lanes).contiguous() for t in q]
            plain = lambda: fk.fold_window_g1_plain(f, b, a_f, q_f[0], q_f[1],
                                                    sgn.reshape(-1).to(torch.int32),
                                                    fk._tab_n(bound), int(cap))
        kern = lambda: fold(f, b, acc, q, sgn, bound, cap)
        got = kern()
        ref = plain()
        if g2:
            ref = tuple(torch.stack([ref[2 * i], ref[2 * i + 1]], dim=1) for i in range(3))
        err = max_abs_err(tuple(t.reshape(got[0].shape) for t in ref), got)
        assert err == 0, f"{name} disagrees with its plain version on table points"
        out[name] = dict(lanes=lanes, max_abs_err=err, ms=cuda_time_ms(kern, 20),
                         plain_ms=cuda_time_ms(plain, 3))
    return out


def main() -> int:
    kernels_only = "--kernels-only" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from bellman_mpc_tpu_torch import native
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # phase 2: build
    build_s = fk.build(verbose=True)
    print(f"build: {build_s:.3f} s (nvcc, sm_90a)", flush=True)

    # phase 3: kernel vs plain
    rng = random.Random(2024)
    checks = check_kernels(device, rng)
    print("kernel checks: " + json.dumps(checks), flush=True)
    if kernels_only:
        return 0

    # phase 4: setup
    from bellman_mpc_tpu_torch.groth16 import (
        Bls12Engine,
        generate_random_parameters,
        prepare_verifying_key,
        verify_proof,
    )
    from bellman_mpc_tpu_torch.models import MiMCDemo, mimc, mimc_constants
    from bellman_mpc_tpu_torch.parallel import BatchProver

    engine = Bls12Engine(device)
    host = engine.fr_host
    constants = mimc_constants(host, seed=42)
    t0 = time.perf_counter()
    params = generate_random_parameters(engine, MiMCDemo(constants))
    setup_s = time.perf_counter() - t0
    log(f"setup (MiMC-{len(constants)}): {setup_s:.3f} s")
    t0 = time.perf_counter()
    bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    info = bp.table_info()
    log(f"prover build {build_s:.3f} s; m={bp.m}, tables " + ", ".join(
        f"{n}: n={k} c={c} {b / 2**30:.3f} GiB" for n, k, c, b in info))
    assert all(c == 8 for _, _, c, _ in info), "window width differs from pick_table_c's 8"

    # phase 5: the main path, counted
    assert native.available(), "native LC evaluator did not build"
    prng = random.Random(0)
    wit = [(prng.randrange(host.p), prng.randrange(host.p)) for _ in range(B_PROOFS)]
    circuits = [MiMCDemo(constants, xl, xr) for xl, xr in wit]
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    proofs = bp.prove_batch(circuits)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    counts = dict(fk.launch_counts)
    log(f"prove_batch B={B_PROOFS}: {prove_s:.3f} s, launches {counts}")
    W = -(-255 // 8) + 1
    assert counts["rns_fold_window"] == 4 * W, counts
    assert counts["rns_fold_window_g2"] == W, counts
    pvk = prepare_verifying_key(engine, params.vk)
    t0 = time.perf_counter()
    for (xl, xr), proof in zip(wit, proofs):
        verify_proof(engine, pvk, proof, [mimc(host, xl, xr, constants)])
    verify_s = time.perf_counter() - t0
    print(f"verified {len(proofs)}/{B_PROOFS} proofs ({verify_s:.3f} s, host pairing)", flush=True)

    # phase 6: timings
    args = bp.encode_circuits(circuits)
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bp.step(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step_s = statistics.median(steps)
    windows = time_fold_windows(bp, rng)
    print(json.dumps({
        "setup_s": setup_s, "prover_build_s": build_s, "prove_batch_s": prove_s,
        "step_s": step_s, "steps_s": steps, "proofs_per_s": B_PROOFS / step_s,
        "verify_all_s": verify_s, "B": B_PROOFS, "m": bp.m,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "k3": checks["rns_mul_many"],
    }), flush=True)
    kernels = []
    for name in ("rns_fold_window", "rns_fold_window_g2"):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max(checks[name]["max_abs_err"], windows[name]["max_abs_err"]),
            "ms": windows[name]["ms"], "plain_ms": windows[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
