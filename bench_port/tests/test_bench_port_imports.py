"""Nothing the benchmark runs imports JAX or the JAX package, and a run
without a card, or without the program, fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys

BENCH = __import__("conftest").BENCH
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bellman_mpc_tpu")

IMPORT_ALL = r"""
import importlib.util, json, sys
from pathlib import Path
bench = Path(sys.argv[1])
sys.path[:0] = [str(bench.parent), str(bench)]
import run, faults, roofline, tracing
import reference.groth16, reference.bls12_381
for sub in ("configs", "metrics"):
    for f in sorted((bench / sub).glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"m_{sub}_{f.stem}", f)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
for sub in ("configs", "traffic"):
    for f in sorted((bench / sub).glob("*.json")):
        json.loads(f.read_text())
cell = run.Cell("mimc322.b256")
cell.program.circuits(cell.config, [None])  # imports the port
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_no_jax_is_imported():
    """Every file of run.py, configs/, metrics/ and traffic/, and the port
    through a configuration, loaded in a fresh interpreter: no module whose
    top-level name is exactly one of the forbidden (bellman_mpc_tpu_torch
    begins with bellman_mpc_tpu and is allowed)."""
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(BENCH)], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bellman_mpc_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    import run

    sys.modules.setdefault("bellman_mpc_tpu_torch_probe", sys)
    try:
        assert "bellman_mpc_tpu_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["bellman_mpc_tpu_torch_probe"]


def test_run_without_a_card_fails_without_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "mimc322.b256", "--seed",
                          str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_without_the_program_fails_without_result(tmp_path):
    """A directory that holds only BENCHMARK.json and bench_port/: the run
    fails (here for want of the card, on the card for want of the port)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "sha256-block.b16", "--seed", "5",
                          "--seconds", "1", "--trace", "1"], capture_output=True, text=True, env=_env(),
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    prog = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, 'bench_port'); import run; "
                           "c = run.Cell('mimc322.b256'); c.program.circuits(c.config, [None])"],
                          capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert prog.returncode != 0 and "bellman_mpc_tpu_torch" in prog.stderr
