#!/usr/bin/env python3
"""Where the time of the port's device pairing goes, on one CUDA card.

    python3 scripts/profile_torch_pairing.py [--n-eq 2048] [--device cpu]

Times the device part of pairing_product_is_one on 4 and 18 terms (buckets
8 and 32) and of pairing_eq_batch on --n-eq equations (the Miller loops,
the product, the final exponentiation and the is-one test, on inputs
encoded beforehand), and reports per call:
  * wall_s: one eager call, host clock ending in a synchronize;
  * aten_ops: the PyTorch operator calls of one eager call (counted by a
    dispatch mode; torch.profiler's event lists of a call this long take
    tens of GiB of host memory);
  * k4_launches: the port's own count;
  * device_s: the same call captured once in a CUDA graph and replayed
    (CUDA events, mean of 3 replays): the device's busy time without the
    host's launch gaps;
  * idle_share: 1 - device_s / wall_s.
Prints one JSON line with the card's name and power limit.  --device cpu
rehearses the script (no device times).
Imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bellman_mpc_tpu_torch.curves.host import G1, G2  # noqa: E402
from bellman_mpc_tpu_torch.fields.bls12_381 import R  # noqa: E402
from bellman_mpc_tpu_torch.groth16 import Bls12Engine  # noqa: E402
from bellman_mpc_tpu_torch.ops import kernel_lib as kl  # noqa: E402
from bellman_mpc_tpu_torch.ops import pairing as dp  # noqa: E402
from bellman_mpc_tpu_torch.ops import tower as tw  # noqa: E402


class OpCounter(TorchDispatchMode):
    """Counts the aten operator calls made under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def measure(fn, device) -> dict:
    """wall_s, aten_ops, k4_launches of one eager fn(); device_s and
    idle_share from a CUDA graph of it on a card.  fn returns a bool
    tensor of per-lane answers; returns (measurements, answers)."""
    fn()  # first call: constants reach the device's caches
    sync(device)
    kl.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    res = {"wall_s": time.perf_counter() - t0, "k4_launches": kl.launch_counts["mont_mul"]}
    with OpCounter() as ops:
        fn()
    res["aten_ops"] = ops.n
    if device.type == "cuda":
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got = fn()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, out), "the graph replay disagrees with the eager call"
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            g.replay()
        stop.record()
        torch.cuda.synchronize()
        res["device_s"] = start.elapsed_time(stop) / 3e3
        res["idle_share"] = 1 - res["device_s"] / res["wall_s"]
        del g
    return res, out.cpu()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-eq", type=int, default=2048)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_torch_pairing: no CUDA device available", file=sys.stderr)
        return 1
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True).stdout.strip()
    engine = Bls12Engine(device)
    rng = random.Random(5)
    n = args.n_eq
    sa = [rng.randrange(1, R) for _ in range(n)]
    sb = [rng.randrange(1, R) for _ in range(n)]
    a1_a2 = engine.g1.batch_mul(G1.generator, sa + [a * b % R for a, b in zip(sa, sb)])
    a1, neg_a2 = a1_a2[:n], [G1.neg(p) for p in a1_a2[n:]]
    b1 = engine.g2.batch_mul(G2.generator, sb)
    g2 = [G2.generator] * n
    out = {"card": card, "torch": torch.__version__}
    for terms in (4, 18):
        k = terms // 2
        m = dp._bucket(terms)
        enc = dp.encode_pairs(a1[:k] + neg_a2[:k], b1[:k] + g2[:k], m, device)

        def product_is_one():
            ml = dp.miller_loop_batch(*enc)
            return tw.fp12_is_one(dp.final_exp_eq_batch(dp._fp12_batch_product(ml)))

        res, ok = measure(product_is_one, device)
        assert bool(ok[0]), "a product of true equations is not one"
        out[f"product_is_one_bucket_{m}"] = res
    m = dp._bucket(n)
    enc1, enc2 = dp.encode_pairs(a1, b1, m, device), dp.encode_pairs(neg_a2, g2, m, device)

    def eq_batch():
        ml = tw.fp12_mul(dp.miller_loop_batch(*enc1), dp.miller_loop_batch(*enc2))
        return tw.fp12_is_one(dp.final_exp_eq_batch(ml))

    res, eqs = measure(eq_batch, device)
    assert bool(eqs[:n].all()), "a true equation failed"
    out[f"eq_batch_{n}"] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
