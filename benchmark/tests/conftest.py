"""Fixtures of the benchmark's CPU tests: the harness on ``sys.path`` and
a throwaway copy of the benchmark's folder with small configurations.

Run from the root of a checkout: ``python -m pytest benchmark/tests -q``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

# each benchmark cell at a size the CPU runs in a second: 64 x 64 frames,
# small pools, a small sample
TINY = {"ct512.series": ("ct512", "series"),
        "cxr2048.series": ("cxr2048", "series"),
        "ct512.single": ("ct512", "single"),
        "ct512.autotune": ("ct512", "autotune")}


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark folder whose configurations are cut to
    64 x 64 and whose pools and samples are small; returns its spec path."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for name in ("ct512", "cxr2048"):
        p = root / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(rows=64, cols=64, frames_per_call=16)
        p.write_text(json.dumps(cfg))
    for name in ("series", "single", "autotune"):
        p = root / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(pool_mib=0, sample=12) if name == "series" else t.update(
            pool_files=8, sample=4)
        p.write_text(json.dumps(t))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root / "BENCHMARK.json"


@pytest.fixture
def cpu_run(tmp_path, monkeypatch):
    """``run(spec_path, workload, seed)`` -> the result of one CPU run of
    the cell, with a short window."""
    import time

    import torch

    from mdxbench import cell, spec

    def run(spec_path, workload, seed=20260001, seconds=0.3, trace=False):
        c = spec.load(spec_path, workload, spec_path.parent)
        root = tmp_path / f"run_{workload}_{seed}"
        root.mkdir()
        monkeypatch.setenv("MDX_DB_PATH", str(root / "runs.db"))
        result, notes = cell.run(c, seed, seconds, trace,
                                 torch.device("cpu"), str(root),
                                 time.perf_counter())
        return result, notes

    return run
