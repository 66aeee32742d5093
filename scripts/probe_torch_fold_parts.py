"""Where the port's fold kernels K1 (bmt_fold_g1) and K2 (bmt_fold_g2)
spend their time.

Builds variants of bellman_mpc_tpu_torch/csrc/fold_kernels.cu with one part
of the RNS multiply or one launch parameter replaced, all in parallel, and
times each variant's K1 and K2 at one wave of their persistent blocks and
at the main path's lanes (K1 16384, K2 8192; CUDA events over 50 direct
launches), in ROUNDS rounds that take the variants in turn, and prints each
time's median and range over the rounds.  It says whether each output
equals the unmodified kernel's and prints ptxas's report for both kernels.
Variants whose output differs are timing probes only: the time they save is
what the replaced part costs.

    python3 scripts/probe_torch_fold_parts.py     # one CUDA card and nvcc

Imports nothing of JAX and nothing of the JAX package.
"""

import ctypes
import random
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "bellman_mpc_tpu_torch" / "csrc" / "fold_kernels.cu"

DMMA = '''  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));'''
ONE_CHAIN = "#pragma unroll\n  for (int k = 0; k < EXT_KSTEPS; ++k) dmma(c0, c1, w[k * FRAG], b[4 * k]);"
EXT1 = "    for (int i = warp; i < N * EXT_TILES; i += TC_WARPS) ext1_tile(i / EXT_TILES, i % EXT_TILES);"
EXT2 = "    for (int i = warp; i < N * EXT_TILES; i += TC_WARPS) ext2_tile(i / EXT_TILES, i % EXT_TILES);"
BOUNDS = "__global__ void __launch_bounds__(TC_THREADS, 2) fold_kernel"
WAVE = "    w.blocks = sms * (per_sm > 0 ? per_sm : 1);"
NMAX = "constexpr int NMAX = 6;"

# name -> (what it shows, [(text in the source, replacement)])
VARIANTS = {
    "as built": ("the kernel itself", []),
    "two chains": ("two accumulation chains per tile (even and odd k-steps) instead of one (exact)",
                   [(ONE_CHAIN, "  double o0 = 0.0, o1 = 0.0;\n#pragma unroll\n"
                                "  for (int k = 0; k < EXT_KSTEPS; k += 2) dmma(c0, c1, w[k * FRAG], b[4 * k]);\n"
                                "#pragma unroll\n"
                                "  for (int k = 1; k < EXT_KSTEPS; k += 2) dmma(o0, o1, w[k * FRAG], b[4 * k]);\n"
                                "  c0 += o0;\n  c1 += o1;")]),
    "dfma for mma": ("each m8n8k4 step replaced by two double FMAs: the cost of the tensor-core instruction",
                     [(DMMA, "  c0 = fma(a, b, c0);\n  c1 = fma(a, b, c1);")]),
    "no mma": ("each extension tile's loads and products replaced by one shared load; the epilogues still run",
               [("    ext_tile(s->W[0], s->xi[j], w, lane, c0, c1);", "    c0 = c1 = s->xi[j][0][lane & 7];"),
                ("    ext_tile(s->W[1], s->xi2[j], w, lane, c0, c1);", "    c0 = c1 = s->xi2[j][0][lane & 7];")]),
    "no extensions": ("no extension work at all: channelwise stages, barriers, loads and stores",
                      [(EXT1, ""), (EXT2, "")]),
    "1 block/SM": ("K1 and K2 under __launch_bounds__(640, 1): registers without a cap, in a grid of one "
                   "block per SM",
                   [(BOUNDS, BOUNDS.replace("2)", "1)")), (WAVE, "    w.blocks = sms;")]),
    "1 block/SM, capped": ("the kernels as built (48-register cap) in a grid of one block per SM: beside "
                           "\"1 block/SM\", what the cap's spills cost at equal occupancy",
                           [(WAVE, "    w.blocks = sms;")]),
    "3 blocks/SM": ("K1 and K2 under __launch_bounds__(640, 3): at most 32 registers, three blocks per SM",
                    [(BOUNDS, BOUNDS.replace("2)", "3)"))]),
    "batches of 9": ("NMAX = 9: K2's products in batches of 9 (three Karatsuba triples, 12 barriers per "
                     "window) instead of 6, and 100356 bytes of shared memory per block (exact)",
                     [(NMAX, NMAX.replace("6", "9"))]),
}
KERNELS = {"K1": "G1Ops", "K2": "G2Ops"}  # name -> fold_kernel<Ops>
ROUNDS = 7


def build(name: str, src: str, tmp: Path):
    from bellman_mpc_tpu_torch.ops.kernel_lib import nvcc_command

    text = src
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: its source text is no longer in fold_kernels.cu")
        text = text.replace(old, new)
    stem = re.sub(r"\W+", "_", name)  # nvcc takes only plain file names
    cu, so = tmp / f"{stem}.cu", tmp / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run(nvcc_command(cu, so, shared=True), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name!r}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    report = {}
    for kern, ops in KERNELS.items():
        at = next(i for i, line in enumerate(lines) if "Compiling" in line and "fold_kernel" in line and ops in line)
        report[kern] = " ".join(line.split(":", 1)[-1].strip() for line in lines[at + 2 : at + 4])
    return so, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_fold_parts: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bellman_mpc_tpu_torch.curves import rns_point as rpt
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk
    from bellman_mpc_tpu_torch.ops.kernel_lib import bind, stream

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip())
    src = SRC.read_text()
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: build(n, src, Path(d)), VARIANTS)))
        dev = torch.device("cuda", 0)
        f = rpt.default_rns_field()
        rng = random.Random(1)
        consts, wf = fk._kernel_consts(f, dev), fk._ext_fragments(f, dev)

        def tile(lanes, shape, zero_cols=()):
            t = fk.rns_pad_rows(f, f.encode([rng.randrange(f.p) for _ in range(lanes)], device=dev).res)
            t[:, list(zero_cols)] = 0
            return t.reshape(shape).contiguous()

        # kernel -> its entry point, the main path's lanes, and inputs at those lanes
        # (K2's points are (80, 2, lanes)): accumulator, table point, signs, K*p rows
        cases = {}
        for kern, entry, lanes, g2 in (("K1", "bmt_fold_g1", 16384, False), ("K2", "bmt_fold_g2", 8192, True)):
            shape, n_el = ((fk.PAD_C, 2, lanes), 2 * lanes) if g2 else ((fk.PAD_C, lanes), lanes)
            ins = [tile(n_el, shape) for _ in range(3)] + [tile(n_el, shape, [0]), tile(n_el, shape, [0])]
            sg = torch.tensor([rng.randrange(2) for _ in range(lanes)], dtype=torch.int32, device=dev)
            kp = fk._kp_rows(f, fk.fold_schedule(f, 12, 37, fk.G2_CAP if g2 else fk.G1_CAP, g2), dev)
            cases[kern] = (entry, lanes, ins, sg, kp)
        libs = {name: bind(ctypes.CDLL(str(so)), ("bmt_fold_g1", "bmt_fold_g2", "bmt_fold_g1_wave_lanes",
                                                  "bmt_fold_g2_wave_lanes"))
                for name, (so, _) in built.items()}
        # (variant, kernel, lanes) -> ms in each round; kernel -> the unmodified kernel's output;
        # (variant, kernel) -> whether the variant's output equals it
        times, ref, same = {}, {}, {}
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                for kern, (entry, lanes, ins, sg, kp) in cases.items():
                    outs = [torch.empty_like(ins[0]) for _ in range(3)]
                    for n in (getattr(lib, f"{entry}_wave_lanes")(), lanes):
                        args = ([t.data_ptr() for t in ins] + [sg.data_ptr()] + [o.data_ptr() for o in outs]
                                + [kp.data_ptr(), consts.data_ptr(), wf.data_ptr(), n, 12, stream(dev)])
                        launch = lambda: getattr(lib, entry)(*args)
                        assert launch() == 0, f"{name}: {entry} launch failed"
                        torch.cuda.synchronize()
                        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(50):
                            launch()
                        stop.record()
                        torch.cuda.synchronize()
                        times.setdefault((name, kern, n), []).append(start.elapsed_time(stop) / 50)
                    # the last launch ran at the main path's lanes; "as built" runs first
                    ref.setdefault(kern, outs)
                    same[(name, kern)] = all(torch.equal(a, b) for a, b in zip(outs, ref[kern]))
        for name, (_, report) in built.items():
            print(f"{name:18s} ({VARIANTS[name][0]})")
            for kern in KERNELS:
                line = []
                for (v, k, n), ts in times.items():
                    if v == name and k == kern:
                        line.append(f"{statistics.median(ts):.5f} ms ({min(ts):.5f}-{max(ts):.5f}) at {n} lanes")
                print(f"  {kern}: {'; '.join(line)}; output {'equal to' if same[(name, kern)] else 'differs from'}"
                      f" the kernel's; ptxas: {report[kern]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
