"""BENCHMARK.json against the contract's shapes, and the files it names."""

import json
import re

import pytest
from conftest import BENCH, REPO

from mdxbench import spec

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]]
                         + [w["name"] for w in SPEC["workloads"]]
                         + [m["name"] for m in METRICS]
                         + [w[k] for w in SPEC["workloads"]
                            for k in ("config", "traffic")])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found(w):
    cell = spec.load(REPO / "BENCHMARK.json", w["name"])
    assert cell.chips == 1
    assert cell.config["name"] == w["config"]
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        spec.reader(m["name"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((REPO / c["file"]).read_text())
    assert c["file"].startswith("benchmark/")
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_size_limit():
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_add_by_files_only(tiny, cpu_run):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries run with no edit to an existing file."""
    root = tiny.parent
    cfg = json.loads((root / "configs" / "ct512.json").read_text())
    cfg.update(name="mr48", rows=48, cols=48, frames_per_call=8)
    (root / "configs" / "mr48.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "series.json").read_text())
    mix["conditions"]["noise"]["share"] = 0.5
    (root / "traffic" / "noisy.json").write_text(json.dumps(mix))
    (root / "metrics" / "frames.total.py").write_text(
        "def read(r):\n    return float(r.frames) if r.frames else None\n")
    s = json.loads(tiny.read_text())
    s["configs"].append({"name": "mr48", "source": "x", "why": "x",
                         "file": "benchmark/configs/mr48.json",
                         "reduced": []})
    s["workloads"].append({"name": "mr48.noisy", "config": "mr48",
                           "traffic": "noisy", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "frames.total", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "frames_per_s",
                           "workloads": ["mr48.noisy"]})
    for m in s["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("mr48.noisy")
    tiny.write_text(json.dumps(s))
    result, _ = cpu_run(tiny, "mr48.noisy", trace=True)
    assert result["correct"], result
    assert result["metrics"]["frames.total"]["value"] > 0


QUIET = '''"""Entry kind ``quiet``: run_pipeline without artifacts."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "quiet_base", Path(__file__).with_name("single.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
SPANS, SYNCED = base.SPANS[:1], frozenset()
pool, targets, warmup = base.pool, base.targets, base.warmup
extra, answer, reference = base.extra, base.answer, base.reference


def call(cell, target, out_dir, dev):
    from mdx_torch.pipeline.runner import run_pipeline

    res = run_pipeline(target, out_dir, save_artifacts=False, device=dev)
    return [(target, res)], 1, res["phase_ms"]
'''


def test_add_entry_kind_by_files_only(tiny, cpu_run):
    """A new kind of call: an entry module, a mix naming it and a cell,
    added as new files and entries, with no edit to an existing file."""
    root = tiny.parent
    (root / "entries" / "quiet.py").write_text(QUIET)
    mix = json.loads((root / "traffic" / "single.json").read_text())
    mix["entry"] = "quiet"
    (root / "traffic" / "quiet.json").write_text(json.dumps(mix))
    s = json.loads(tiny.read_text())
    s["workloads"].append({"name": "ct512.quiet", "config": "ct512",
                           "traffic": "quiet", "chips": 1, "why": "x"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "ct512.single" in m.get("workloads", ()):
            m["workloads"].append("ct512.quiet")
    tiny.write_text(json.dumps(s))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    result, notes = cpu_run(tiny, "ct512.quiet", trace=True)
    assert result["correct"], notes
    assert result["metrics"]["runner.run_ms_p50"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
