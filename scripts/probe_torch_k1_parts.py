"""Where the port's K1 (bmt_fold_g1, csrc/fold_kernels.cu) spends its time.

Builds variants of bellman_mpc_tpu_torch/csrc/fold_kernels.cu with one part
of the tensor-core multiply replaced, times each variant's bmt_fold_g1 at
one wave of persistent blocks and at the main path's 16384 lanes (CUDA
events over 50 direct launches), and says whether its output equals the
unmodified kernel's.  Variants whose output differs are timing probes
only: the time they save is what the replaced part costs.

    python3 scripts/probe_torch_k1_parts.py     # one CUDA card and nvcc

Imports nothing of JAX and nothing of the JAX package.
"""

import ctypes
import random
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
BOUNDS = "__global__ void __launch_bounds__(TC_THREADS, 2) fold_g1_kernel"

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
    "1 block/SM": ("__launch_bounds__(640, 1): registers unconstrained, one block per SM",
                   [(BOUNDS, BOUNDS.replace("2)", "1)"))]),
    "3 blocks/SM": ("__launch_bounds__(640, 3): at most 32 registers, three blocks per SM",
                    [(BOUNDS, BOUNDS.replace("2)", "3)"))]),
}


def build(name: str, src: str, tmp: Path):
    from bellman_mpc_tpu_torch.ops.kernel_lib import nvcc_command

    text = src
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: its source text is no longer in fold_kernels.cu")
        text = text.replace(old, new)
    stem = name.replace(" ", "_").replace("/", "_")
    cu, so = tmp / f"{stem}.cu", tmp / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run(nvcc_command(cu, so, shared=True), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name!r}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    at = next(i for i, line in enumerate(lines) if "fold_g1_kernel" in line and "Compiling" in line)
    report = " ".join(line.split(":", 1)[-1].strip() for line in lines[at + 2 : at + 4])
    return so, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_k1_parts: no CUDA device available", file=sys.stderr)
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
        lanes = 16384

        def tile(zero_cols=()):
            t = fk.rns_pad_rows(f, f.encode([rng.randrange(f.p) for _ in range(lanes)], device=dev).res)
            t[:, list(zero_cols)] = 0
            return t.contiguous()

        ins = [tile() for _ in range(3)] + [tile([0]), tile([0])]
        sg = torch.tensor([rng.randrange(2) for _ in range(lanes)], dtype=torch.int32, device=dev)
        outs = [torch.empty_like(ins[0]) for _ in range(3)]
        kp = fk._kp_rows(f, fk.fold_schedule(f, 12, 37, fk.G1_CAP, False), dev)
        consts, wf = fk._kernel_consts(f, dev), fk._ext_fragments(f, dev)
        ref = None
        for name, (so, report) in built.items():
            lib = bind(ctypes.CDLL(str(so)), ("bmt_fold_g1", "bmt_fold_g1_wave_lanes"))
            times = {}
            for n in (lib.bmt_fold_g1_wave_lanes(), lanes):
                args = ([t.data_ptr() for t in ins] + [sg.data_ptr()] + [o.data_ptr() for o in outs]
                        + [kp.data_ptr(), consts.data_ptr(), wf.data_ptr(), n, 12, stream(dev)])
                launch = lambda: lib.bmt_fold_g1(*args)
                assert launch() == 0, f"{name}: launch failed"
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    launch()
                stop.record()
                torch.cuda.synchronize()
                times[n] = start.elapsed_time(stop) / 50
            got = [o.clone() for o in outs]
            ref = got if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            wave, full = times
            print(f"{name:14s} {times[wave]:.5f} ms at {wave} lanes, {times[full]:.5f} ms at {full} lanes; "
                  f"output {'equal to' if same else 'differs from'} the kernel's; ptxas: {report}")
            print(f"{'':14s} ({VARIANTS[name][0]})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
