"""The benchmark's harness on the CPU: what it imports, that BENCHMARK.json
keeps to its contract's names and shapes, that a cell, a configuration,
a traffic mix and a metric are found by name from new files alone, and
that it refuses to run without a card."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "e4s2024_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported_tops(path: Path) -> set:
    """Top-level names of every absolute import in a Python file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_under_perfbench_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & BANNED, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "e4s2024_torch" not in imported_tops(path), path


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    from perfbench import harness

    monkeypatch.setitem(sys.modules, "e4s2024_torch_extra", sys.modules["os"])
    assert harness.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["os"])
    assert harness.banned_loaded() == ["jax"]


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(_one_line(w) for w in b["command"])
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} == ({"name", "unit", "better", "bound", "source"}
                                          if m in b["end_to_end"] else
                                          {"name", "unit", "better", "source", "layer", "moves"})
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: w for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
    for m in b["per_layer"]:
        assert _one_line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        name = m["name"]
        assert (BENCH / "metrics" / f"{name}.py").is_file() or \
            (BENCH / "metrics" / f"{name.split('.')[0]}.py").is_file()


def test_a_new_cell_config_traffic_and_metric_are_found_from_files_alone(tmp_path):
    """A throwaway cell in a copy of the benchmark: new files and new
    entries in BENCHMARK.json, no edit of a file that exists. It runs on
    the CPU at a tiny size and reports its new per-layer metric."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "e4s-rgi-1024.json").read_text())
    cfg["swap"].update(out_size=64, remaining_layer_idx=7, encoder_num_units=[1, 1, 1, 1])
    (tmp_path / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/traffic/tiny_pairs.json").write_text(json.dumps(
        {"generator": "aligned_pairs", "pool": 2, "batch": 1, "block": 8, "base": 200,
         "noise": 55}))
    (tmp_path / "perfbench/workloads/tiny.swap.json").write_text(json.dumps(
        {"driver": "swap_aligned", "warm_calls": 1, "trace_calls": 1,
         "limits": {"image_mad": 0.5, "mask_mismatch": 0.01, "style_gap": 0.01}}))
    (tmp_path / "perfbench/metrics/calls_in_window.py").write_text(
        "def read(r):\n    return float(r.calls)\n")
    b["configs"].append({"name": "tiny", "source": "test", "file": "perfbench/configs/tiny.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny.swap", "config": "tiny", "traffic": "tiny_pairs",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "calls_in_window.swap", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "entry point",
                           "moves": "swap_ms_p95", "workloads": ["tiny.swap"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    script = f"""
import json, sys, time
sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(2)
from pathlib import Path
from perfbench import harness
assert harness.HERE == Path({str(tmp_path)!r}) / "perfbench"
root = Path({str(tmp_path)!r})
bench = harness.load_json(root / "BENCHMARK.json")
cell, config, traffic, workload = harness.cell_files(root, bench, "tiny.swap")
ctx = harness.Context(config=config, traffic=traffic, workload=workload,
                      seed=2 ** 31 + 99, device=torch.device("cpu"), t_start=time.perf_counter())
drv = harness.load_module(harness.HERE / "drivers" / "swap_aligned.py", "drv")
out = harness.run_cell(ctx, drv.Driver, 0.5, False)
line = harness.result_line(bench, "tiny.swap", 1, out[0], out[1], out[2], ctx.setup_split,
                           out[3], True)
print(json.dumps(line))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["calls_in_window.swap"]["value"] >= 1
    assert list(line)[-1] == "checks" and set(line["checks"]) == {
        "image_mad", "mask_mismatch", "style_gap"}
    assert list(line["setup_split_s"]) == ["imports", "traffic", "weights", "program", "warm"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    env = dict(os.environ, HOME=str(tmp_path))
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "rgi.swap_b1",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "rgi.swap_b1",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
