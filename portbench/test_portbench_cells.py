"""The harness end to end on the CPU, at tiny sizes: each driver against
the reference, the result line's keys, and a configuration, traffic mix
and metric added as files only."""
from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import ROOT, TINY, TRAFFIC, tiny_cell

CELLS = [tiny_cell(name, t) for name in TINY for t in TRAFFIC]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, traced=False, seed=2 ** 33 + 7, **kw):
    return harness.run(root, cell, seed, 0.3, traced, device="cpu",
                       log=io.StringIO(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_driver_matches_reference(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["answers_compared"]["value"] >= 1
    assert out["checks"]["fval_err"]["value"] < 1e-5
    assert set(out["metrics"]) >= {"items_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny_root, traced):
    out = _run(tiny_root, CELLS[0], traced)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(out) == want
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)  # one JSON line


def test_new_files_need_no_edit(tiny_root, tmp_path):
    """A configuration, a traffic mix and a metric, each a new file plus
    its entry in BENCHMARK.json, run with no other change."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "threesieves-tiny.json").read_text())
    cfg.update(name="threesieves-wide", d=24, total_sessions=3,
               items_per_ingest=144)
    (pb / "configs" / "threesieves-wide.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "tumbling.json").read_text())
    tr.update(components=2, drift_std=0.0, pool=2)
    (pb / "traffic" / "two-clusters.json").write_text(json.dumps(tr))
    (pb / "metrics" / "items_per_ingest.py").write_text(
        "def read(ctx):\n    return ctx['items'] / ctx['ingests']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        bench["configs"][0], name="threesieves-wide",
        file="portbench/configs/threesieves-wide.json"))
    bench["workloads"].append({"name": "threesieves-wide.two-clusters",
                               "config": "threesieves-wide",
                               "traffic": "two-clusters", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({
        "name": "items_per_ingest", "unit": "items", "better": "higher",
        "bound": 0.01, "source": "host_clock",
        "workloads": ["threesieves-wide.two-clusters"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, "threesieves-wide.two-clusters")
    assert out["correct"], out["checks"]
    assert out["metrics"]["items_per_ingest"]["value"] == 3 * 48


def test_run_without_card_prints_nothing(no_card):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "threesieves-pod256.tumbling", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "threesieves-pod256.tumbling", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout == ""


def test_no_jax_and_no_reference_package(tiny_root):
    """A whole run imports neither JAX nor the JAX package ``repro``
    (top-level module names compared whole)."""
    code = (
        "import sys, io\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench import harness, control\n"
        f"out = harness.run({str(tiny_root)!r}, {CELLS[1]!r}, 5, 0.2, True,"
        " device='cpu', log=io.StringIO())\n"
        "print(harness.forbidden_loaded(), out['correct'])\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[] True"
