"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
at a temporary root, with tiny configurations added as new files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
ROOT = PB.parent

TINY = {
    "threesieves-tiny": ("threesieves-pod256", {
        "K": 8, "d": 16, "total_sessions": 6, "chunk_per_session": 64,
        "items_per_ingest": 288, "data_scale": 0.0625,
        "pod": {"T": 10, "eps": 0.05, "lengthscale": 0.25},
        "session_cycles": [
            {"values": [
                {"K": 3, "T": 5, "eps": 0.05, "lengthscale": 0.125},
                {"K": 5, "T": 10, "eps": 0.05, "lengthscale": 0.25},
                {"K": 8, "T": 20, "eps": 0.02, "lengthscale": 0.25}]},
            {"values": [{"kernel_kind": "rbf"},
                                    {"kernel_kind": "rbf"},
                                    {"kernel_kind": "linear_norm"}]}]}),
    "sievestreampp-tiny": ("sievestreampp-pod64", {
        "K": 8, "d": 16, "total_sessions": 4, "chunk_per_session": 64,
        "items_per_ingest": 160, "data_scale": 0.25,
        "pod": {"eps": 0.1, "lengthscale": 2.0},
        "session_cycles": [
            {"values": [{"K": 3}, {"K": 8}]},
            {"values": [{"eps": 0.1}]},
            {"values": [{"lengthscale": 2.0},
                                    {"lengthscale": 3.0}]},
            {"values": [{"kernel_kind": "rbf"}] * 3
             + [{"kernel_kind": "linear_norm"}]}]}),
}


TRAFFIC = ("tumbling", "steady")


def tiny_cell(config: str, traffic: str = "tumbling") -> str:
    return f"{config}.{traffic}"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """BENCHMARK.json and the benchmark's data files under a temporary
    root, plus one tiny configuration of each algorithm and a cell each,
    added as files and entries only."""
    root = tmp_path_factory.mktemp("bench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    dst = root / bench["paths"][0]
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(PB / sub, dst / sub)
    for name, (like, changes) in TINY.items():
        cfg = json.loads((PB / "configs" / f"{like}.json").read_text())
        cfg.update(changes, name=name)
        (dst / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        entry = next(c for c in bench["configs"] if c["name"] == like)
        bench["configs"].append(dict(entry, name=name,
                                     file=f"portbench/configs/{name}.json"))
        for traffic in TRAFFIC:
            cell = {"name": tiny_cell(name, traffic), "config": name,
                    "traffic": traffic, "chips": 1, "why": "a test cell"}
            bench["workloads"].append(cell)
            for m in bench["end_to_end"] + bench["per_layer"]:
                if any(w.startswith(like + ".")
                       for w in m.get("workloads", ())):
                    m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def no_card():
    """Skips where a CUDA card is present: the test checks what a run
    does without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
