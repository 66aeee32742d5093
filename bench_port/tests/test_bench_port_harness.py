"""The harness is data: a configuration, a traffic mix and a metric added
as files are found by name, and every cell names files that exist."""

import json
import shutil
import subprocess
import sys

BENCH = __import__("conftest").BENCH
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_names_files_that_exist():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        c = configs[w["config"]]
        assert (ROOT / c["file"]).exists()
        assert c["file"] == f"bench_port/configs/{w['config']}.json"
        for suffix in (".py", "_ref.py"):
            assert (BENCH / "configs" / f"{w['config']}{suffix}").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "bench_port"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    cfg = json.loads((b / "configs" / "mimc322.json").read_text())
    cfg.update(name="mimc-tiny", rounds=4)
    (b / "configs" / "mimc-tiny.json").write_text(json.dumps(cfg))
    for suffix in (".py", "_ref.py"):
        shutil.copy(b / "configs" / f"mimc322{suffix}", b / "configs" / f"mimc-tiny{suffix}")
    (b / "traffic" / "closed-b2-pool2.json").write_text(json.dumps({"loop": "closed", "in_flight": 1,
                                                                    "batch": 2, "pool": 2}))
    (b / "metrics" / "witness_s.py").write_text("def read(ctx):\n    return ctx['spans']['encode_s']\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "mimc-tiny.b2", "config": "mimc-tiny", "traffic": "closed-b2-pool2",
                              "chips": 1, "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "witness_s", "unit": "s", "better": "lower", "source": "host_clock",
                              "layer": "host synthesis", "moves": "setup_s", "workloads": ["mimc-tiny.b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == data for p, data in before.items())  # no file that was there changed

    probe = ("import sys; sys.path.insert(0, 'bench_port'); import run; c = run.Cell('mimc-tiny.b2'); "
             "print(c.config['rounds'], c.batch, c.pool, sorted(c.readers), "
             "c.readers['witness_s'].read({'spans': {'encode_s': 1.5}}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:3] == ["4", "2", "2"] and "'witness_s']" in out.stdout and "1.5" in out.stdout
    run = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "mimc-tiny.b2", "--seed", "9",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=120)
    assert run.returncode != 0 and "no CUDA device" in run.stderr  # found every file, then looked for the card
    missing = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "mimc-tiny.b3", "--seed", "9",
                              "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                             timeout=120)
    assert missing.returncode != 0 and "no workload" in missing.stderr
