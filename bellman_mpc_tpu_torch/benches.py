"""Criterion-style micro-benchmark suite.

Copy of bellman_mpc_tpu/benches.py on the port, at the reference's sizes
and seeds.  It ports the reference's bench harnesses:
  * `bench_batch_verify` — batched vs unbatched verification sweep over
    n in {8, 16, ..., 64} (bellman/src/batch.rs:15-94),
  * `bench_multiexp` — the G1 multiexp of `bench_parts` at 2^16 points
    (bellman/src/slow.rs:14-44),
plus the device benches of the NTT and the batched pairing, and
`bench_scaling`, the weak scaling of the sharded table MSM over meshes.

Every bench takes the device it runs on, the first CUDA card by default,
and first makes one limb multiply there, so that the CUDA context and the
kernel library are up before any clock starts: where the reference warms
a bench up to compile its XLA programs, eager PyTorch compiles nothing.
Each JSON line carries the reference's keys and the device's name.

Run: python -m bellman_mpc_tpu_torch.benches [--quick] [names]
With no names four benches run (batch_verify, multiexp, ntt, pairing);
`scaling` runs only when it is named, as in the reference.  Results print
as JSON lines to stdout (one per measurement).
"""

from __future__ import annotations

import json
import random
import sys
import time
from typing import Optional, Sequence

import torch

DEFAULT_BENCHES = ("batch_verify", "multiexp", "ntt", "pairing")


def _device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _emit(name: str, value: float, unit: str, device, **extra) -> None:
    print(json.dumps({"bench": name, "value": round(value, 4), "unit": unit, **extra,
                      "device": _device_name(device)}), flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _warm(device) -> None:
    """One limb multiply on `device`: starts the CUDA context and builds or
    loads the kernel library (K4) before a bench reads its clock."""
    from .fields.bls12_381 import fr

    x = fr.encode([1], device=device)
    fr.mul(x, x)
    _sync(device)


def bench_batch_verify(quick: bool = False, device="cuda:0") -> None:
    """batch.rs:15-94: amortized verify cost, batched vs unbatched.

    The reference makes its items with sequential proofs; here one rns
    BatchProver proves them, at most 16 per step.  The proofs are the same
    192 bytes (the batch proof equals the sequential one), and proof
    creation is not what this bench times."""
    from .groth16 import (
        Bls12Engine,
        generate_random_parameters,
        prepare_verifying_key,
        verify_proof,
    )
    from .groth16.verifier_batch import BatchVerifier
    from .models import MiMCDemo, mimc, mimc_constants
    from .parallel.batch_prover import BatchProver

    _warm(device)
    engine = Bls12Engine(device)
    host = engine.fr_host
    rounds = 20 if quick else 322
    constants = mimc_constants(host, seed=1, rounds=rounds)
    params = generate_random_parameters(engine, MiMCDemo(constants))
    pvk = prepare_verifying_key(engine, params.vk)

    rng = random.Random(2)
    sizes = [8] if quick else [8, 16, 32, 64]
    max_n = max(sizes)
    wit = [(rng.randrange(host.p), rng.randrange(host.p)) for _ in range(max_n)]
    bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    proofs = []
    for i in range(0, max_n, 16):
        proofs += bp.prove_batch([MiMCDemo(constants, xl, xr) for xl, xr in wit[i:i + 16]])
    del bp
    items = [(proof, [mimc(host, xl, xr, constants)]) for proof, (xl, xr) in zip(proofs, wit)]

    t0 = time.perf_counter()
    verify_proof(engine, pvk, items[0][0], items[0][1])
    _emit("verify_single", time.perf_counter() - t0, "s/proof", device)

    for n in sizes:
        bv = BatchVerifier()
        for it in items[:n]:
            bv.queue(it)
        t0 = time.perf_counter()
        bv.verify(engine, params.vk, random.Random(3))
        dt = time.perf_counter() - t0
        _emit("batch_verify", dt / n, "s/proof", device, n=n, total_s=round(dt, 3))


def bench_multiexp(quick: bool = False, device="cuda:0") -> None:
    """slow.rs:14-44: G1 multiexp throughput."""
    from .curves import host as chost
    from .curves.device import g1_device
    from .fields.bls12_381 import R
    from .ops.msm import msm_pippenger_host

    _warm(device)
    rng = random.Random(4)
    log_n = 10 if quick else 16
    n = 1 << log_n
    base = chost.G1.generator
    # distinct small multiples are enough for a throughput bench
    bases = [chost.G1.mul(base, k + 1) for k in range(64)] * (n // 64)
    scalars = [rng.randrange(R) for _ in range(n)]

    t0 = time.perf_counter()
    msm_pippenger_host(g1_device, bases, scalars, device, c=8)
    dt = time.perf_counter() - t0
    _emit("multiexp_g1", n / dt, "points/s", device, n=n, total_s=round(dt, 3))


def bench_ntt(quick: bool = False, device="cuda:0") -> None:
    from .fields.bls12_381 import fr, fr_host
    from .ops.domain import EvaluationDomain

    _warm(device)
    rng = random.Random(5)
    log_n = 10 if quick else 18
    n = 1 << log_n
    d = EvaluationDomain.from_coeffs(
        fr, fr_host, [rng.randrange(fr_host.p) for _ in range(n)], device
    )
    d.fft()  # warm
    _sync(device)
    t0 = time.perf_counter()
    iters = 5
    for _ in range(iters):
        d.fft()
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    _emit("ntt_fr", n * log_n / 2 / dt, "butterflies/s", device, n=n, total_s=round(dt, 4))


def bench_pairing(quick: bool = False, device="cuda:0") -> None:
    from .curves import host as chost
    from .ops.pairing import pairing_batch

    _warm(device)
    n = 8 if quick else 128
    g1s = [chost.G1.mul(chost.G1.generator, k + 1) for k in range(n)]
    g2s = [chost.G2.mul(chost.G2.generator, k + 2) for k in range(n)]
    t0 = time.perf_counter()
    pairing_batch(g1s, g2s, device)
    dt = time.perf_counter() - t0
    _emit("pairing_batch", n / dt, "pairings/s", device, n=n, total_s=round(dt, 3))


def bench_scaling(quick: bool = False, devices: Optional[Sequence] = None) -> None:
    """Weak scaling of the sharded table MSM over mesh sizes (SURVEY §2.6).

    The per-shard base count n_per is fixed and the problem grows with the
    mesh (N = d * n_per), so ideal scaling is a constant time; efficiency_time
    = t(1) / t(d), efficiency_rate = rate(d) / rate(1).  The kernel is the
    table strategy's signed-affine gather MSM sharded over "model"
    (parallel/sharded.sharded_msm_table_affine), on (1, d) meshes for d in
    1, 2, 4, 8 up to len(devices); `devices` defaults to the CUDA devices
    (one card gives the d = 1 line) and may repeat a device, whose shards
    then share it, so the lines measure no multi-card scaling.  The
    reference's sizes, seeds and keys; `compile_s` is the first call's time
    (eager PyTorch compiles nothing)."""
    from .curves import host as chost
    from .curves.device import g1_device, scalars_to_bits
    from .fields.bls12_381 import R
    from .ops.msm import digits_from_bits, signed_digits, window_tables_affine
    from .parallel.mesh import make_mesh
    from .parallel.sharded import sharded_msm_table_affine

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("bench_scaling: no CUDA device; pass devices=")
    devices = [torch.device(x) for x in devices]
    lead = devices[0]
    _warm(lead)
    rng = random.Random(7)
    n_per = 64 if quick else 128  # bases per shard (weak scaling)
    c = 4
    B = 2
    sizes = [d for d in (1, 2, 4, 8) if d <= len(devices)]
    n_max = n_per * max(sizes)
    bases = [chost.G1.mul(chost.G1.generator, k + 1) for k in range(64)] * (n_max // 64)
    tables_all = window_tables_affine(g1_device.ops, g1_device.encode_points(bases, lead), c)
    scalars = [[rng.randrange(R) for _ in range(n_max)] for _ in range(B)]
    bits_all = torch.stack([scalars_to_bits(s, 255, lead) for s in scalars], dim=1)
    sd_all = signed_digits(digits_from_bits(bits_all, c), c)

    def sync():
        for dev in set(devices):
            _sync(dev)

    t1 = rate1 = None
    for d in sizes:
        n = n_per * d
        tables = tuple(t[..., :n] for t in tables_all)
        sd = sd_all[..., :n]
        mesh = make_mesh(d, shape=(1, d), devices=devices[:d])
        sync()
        t0 = time.perf_counter()
        sharded_msm_table_affine(mesh, g1_device.ops, tables, sd)
        sync()
        warm = time.perf_counter() - t0
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            sharded_msm_table_affine(mesh, g1_device.ops, tables, sd)
        sync()
        dt = (time.perf_counter() - t0) / iters
        rate = B * n / dt
        if t1 is None:
            t1, rate1 = dt, rate
        _emit("sharded_table_msm_weak_scaling", rate, "points/s", lead,
              devices=d, n_total=n, n_per_device=n_per, time_s=round(dt, 4),
              efficiency_time=round(t1 / dt, 3), efficiency_rate=round(rate / rate1, 3),
              compile_s=round(warm, 2))


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    quick = "--quick" in argv
    only = [a for a in argv if not a.startswith("-")]
    benches = {
        "batch_verify": bench_batch_verify,
        "multiexp": bench_multiexp,
        "ntt": bench_ntt,
        "pairing": bench_pairing,
        "scaling": bench_scaling,
    }
    for name, fn in benches.items():
        if name not in (only or DEFAULT_BENCHES):
            continue
        print(f"# {name}", file=sys.stderr, flush=True)
        fn(quick)


if __name__ == "__main__":
    main()
