"""The cell ``ct512.series.d4`` on the CPU at the tiny size, on two ranks
of the program's rank pool (this process and one spawned gloo rank):
sound, it is correct and every metric of the cell that needs no card
reads a number; with the packed results altered where the calling
process reads them, it is not correct.  (A monkeypatch reaches the
calling process only, not the spawned rank.)"""

import json

import pytest

CELL = "ct512.series.d4"
RANK_METRICS = ["ranks.decode_ms_per_frame", "ranks.qa_ms_per_frame",
                "ranks.idle_share", "runner.parent_ms_per_frame",
                "ranks.starts_per_call", "ranks.peak_gib"]


def test_cell_files_found():
    """The cell's files by name, as ``test_mdxbench_spec`` checks the
    one-chip cells; the one cell on four chips that the benchmark may
    have."""
    from conftest import REPO
    from mdxbench import spec

    s = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = spec.load(REPO / "BENCHMARK.json", CELL)
    assert cell.chips == 4 and cell.config["name"] == "ct512.d4"
    assert [w["name"] for w in s["workloads"] if w["chips"] != 1] == [CELL]
    assert [w["name"] for w in s["workloads"]
            if w["config"] == "ct512.d4"] == [CELL]
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"peak_gib", "setup_s"}
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        RANK_METRICS + ["runner.frames_per_s"])
    for m in cell.per_layer:
        assert m["moves"] in e2e
        spec.reader(m["name"])


@pytest.fixture
def tiny_d4(tiny):
    """The tiny benchmark with ``ct512.d4`` cut to 64 x 64, 16 frames a
    call, a pool of one study, a sample of 12, and the cell on 2 ranks."""
    root = tiny.parent
    p = root / "configs" / "ct512.d4.json"
    cfg = json.loads(p.read_text())
    cfg.update(rows=64, cols=64, frames_per_call=16)
    p.write_text(json.dumps(cfg))
    p = root / "traffic" / "series_d4.json"
    mix = json.loads(p.read_text())
    mix.update(pool_mib=0, sample=12)
    p.write_text(json.dumps(mix))
    s = json.loads(tiny.read_text())
    for w in s["workloads"]:
        if w["name"] == CELL:
            w["chips"] = 2
    tiny.write_text(json.dumps(s))
    yield tiny
    from mdx_torch.parallel import pool

    pool.close()


def test_sound_run_is_correct_and_reads_every_metric(tiny_d4, cpu_run):
    result, notes = cpu_run(tiny_d4, CELL, seed=2**31 + 23, seconds=0.5)
    assert result["correct"], notes
    assert result["failed"] == 0 and result["attempted"] >= 1
    # peak_gib reads the card: none here
    assert set(result["metrics"]) == {"setup_s"}

    result, notes = cpu_run(tiny_d4, CELL, seed=2**31 + 24, seconds=0.5,
                            trace=True)
    assert result["correct"], notes
    got = result["metrics"]
    assert set(got) == set(RANK_METRICS) | {"runner.frames_per_s"}, notes
    assert got["runner.frames_per_s"]["value"] > 0
    for name in RANK_METRICS:
        assert isinstance(got[name]["value"], float), name
    # the pool was up from the warm-up call on
    assert got["ranks.starts_per_call"]["value"] == 0.0
    assert got["ranks.decode_ms_per_frame"]["value"] > 0
    assert got["ranks.qa_ms_per_frame"]["value"] > 0
    assert 0 <= got["ranks.idle_share"]["value"] < 100
    assert got["ranks.peak_gib"]["value"] == 0.0      # no card


def test_results_altered_in_the_parent_are_not_correct(tiny_d4, cpu_run,
                                                       monkeypatch):
    from mdx_torch.core.metrics import METRIC_KEYS
    from mdx_torch.pipeline import batch_runner

    orig = batch_runner._collect

    def altered(frames, packed, *a, **k):
        packed = packed.copy()
        packed[:len(METRIC_KEYS), ::4] *= 1.01
        return orig(frames, packed, *a, **k)

    monkeypatch.setattr(batch_runner, "_collect", altered)
    result, notes = cpu_run(tiny_d4, CELL, seed=2**31 + 25, seconds=0.3)
    assert not result["correct"], notes
