"""The port's spans and counters (``mdx_torch.telemetry``), on the CPU.

Off, a span is one shared no-op and a run records nothing; on, spans nest
and carry their thread; a directory batch records one ``decode.header``,
one ``decode.file`` a file and one ``stage``/``upload``/``launch``/
``fetch``/``collect`` a chunk; a run's host-sync counts repeat exactly and
name only the listed sites; a span mapped through the anchor lands on a ``torch.profiler``
range of the same interval; ``MDX_PROFILE_DIR`` writes one Chrome trace
a run, on every run path.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from mdx_torch import telemetry
from mdx_torch.io import write_synthetic_dicom
from mdx_torch.pipeline import batch_runner as PB
from mdx_torch.pipeline import runner as PR

SITES = {"enhance.noise_guard", "enhance.halo_guard", "tv.flags",
         "tv.plain_flags", "tuning.readback", "tuning.lanes",
         "tuning.upload", "agents.to_host", "runner.enhanced_copy",
         "runner.upload", "batch.fetch", "hist.bincount", "quantile.ranks",
         "filters.as_n", "phase.sync"}


@pytest.fixture(autouse=True)
def tracer(tmp_path, monkeypatch):
    """A fresh tracer, off, and a DB of the test's own."""
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    monkeypatch.delenv("MDX_PROFILE_DIR", raising=False)
    telemetry.reset()
    yield
    while telemetry.enabled():
        telemetry.disable()
    telemetry.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry")
    series = root / "series"
    series.mkdir()
    for i, kind in enumerate(("noisy", "phantom", "clipped", "noisy",
                              "low_contrast")):
        write_synthetic_dicom(str(series / f"f{i}.dcm"), kind=kind, size=64,
                              seed=i)
    one = write_synthetic_dicom(str(root / "noisy.dcm"), kind="noisy",
                                size=64, seed=7)
    return {"dir": str(series), "file": one}


def _names(snap) -> list[str]:
    return [s[0] for s in snap["spans"]]


def test_off_records_nothing(tmp_path, files):
    assert not telemetry.enabled()
    assert telemetry.span("a") is telemetry.span("b", frames=3)
    assert telemetry.count_sync("tv.flags") is telemetry.span("c")
    PR.run_pipeline(files["file"], str(tmp_path / "o"), device="cpu")
    snap = telemetry.snapshot()
    assert snap["spans"] == []
    assert snap["syncs"]          # the counters are always on


def test_spans_nest_and_carry_threads():
    telemetry.enable()
    with telemetry.span("outer", k=1):
        with telemetry.span("inner"):
            time.sleep(0.001)
        worker = threading.Thread(target=lambda: telemetry.span("w")
                                  .__enter__().__exit__(None, None, None))
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    telemetry.disable()
    assert not telemetry.enabled()
    spans = {s[0]: s for s in telemetry.snapshot()["spans"]}
    assert set(spans) == {"outer", "inner", "w"}
    outer, inner, w = spans["outer"], spans["inner"], spans["w"]
    assert outer[1] <= inner[1] < inner[2] <= outer[2]
    assert outer[4] == {"k": 1} and inner[4] == {}
    main = threading.main_thread().ident
    assert outer[3] == inner[3] == threading.get_ident() == main
    assert w[3] != main


def test_enable_nests():
    telemetry.enable()
    telemetry.enable()
    telemetry.disable()
    assert telemetry.enabled()
    telemetry.disable()
    assert not telemetry.enabled()


def test_batch_spans_per_file_and_chunk(tmp_path, files, monkeypatch):
    monkeypatch.setattr(PB, "CHUNK", 2)            # 5 frames: 3 chunks
    telemetry.enable()
    out = PB.run_pipeline_batch(files["dir"], str(tmp_path / "b"),
                                device="cpu")
    telemetry.disable()
    assert len(out["frames"]) == 5
    snap = telemetry.snapshot()
    names = _names(snap)
    counts = {n: names.count(n) for n in set(names)}
    assert counts["decode.file"] == 5
    for name in ("stage", "upload", "launch", "fetch", "collect", "db"):
        assert counts[name] == 3, name
    for name in ("batch", "decode", "decode.header", "bucket", "report"):
        assert counts[name] == 1, name
    main = snap["main_thread"]
    spans = snap["spans"]
    assert all(s[3] != main for s in spans if s[0] == "decode.file")
    assert all(s[3] == main for s in spans if s[0] != "decode.file")
    assert sum(s[4]["frames"] for s in spans if s[0] == "stage") == 5
    assert snap["staged"] == {"in_place": 5}
    batch = next(s for s in spans if s[0] == "batch")
    assert all(batch[1] <= s[1] <= s[2] <= batch[2] for s in spans)


@pytest.mark.parametrize("autotune", [False, True])
def test_sync_counts_repeat(tmp_path, files, autotune):
    counts = []
    for k in range(2):
        telemetry.reset()
        PR.run_pipeline(files["file"], str(tmp_path / f"o{k}"),
                        autotune=autotune, device="cpu")
        counts.append(telemetry.snapshot()["syncs"])
    assert counts[0] == counts[1]
    assert counts[0] and set(counts[0]) <= SITES
    assert counts[0]["agents.to_host"] >= 1
    if autotune:
        assert counts[0]["tuning.readback"] == 5


def test_anchor_lands_on_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    telemetry.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with telemetry.span("x"), record_function("x"):
            time.sleep(0.003)
    snap = telemetry.snapshot()
    telemetry.disable()
    (_, t0, t1, _, _), = [s for s in snap["spans"] if s[0] == "x"]
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "x"]
    start = ev.start_ns()
    end = start + ev.duration_ns()
    assert abs(telemetry.to_epoch_ns(snap, t0) - start) < 1_000_000
    assert abs(telemetry.to_epoch_ns(snap, t1) - end) < 1_000_000


@pytest.mark.parametrize("path", ["single", "autotune", "genai", "batch"])
def test_profile_dir_writes_a_trace_a_run(tmp_path, files, monkeypatch,
                                          path):
    from mdx_torch.genai import client as port_llm

    def down(model, payload):
        raise port_llm.LLMError("model call refused by the test")

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.setattr(port_llm, "_transport", down)
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv("MDX_PROFILE_DIR", str(prof_dir))
    for k in range(2):
        if path == "batch":
            PB.run_pipeline_batch(files["dir"], str(tmp_path / f"o{k}"),
                                  device="cpu")
        else:
            PR.run_pipeline(files["file"], str(tmp_path / f"o{k}"),
                            device="cpu", autotune=path == "autotune",
                            genai=path == "genai")
    assert not telemetry.enabled()
    written = sorted(os.listdir(prof_dir))
    assert len(written) == 2
    top = "batch" if path == "batch" else "run"
    for name in written:
        assert name.startswith(top + "_")
        assert name.endswith(f".{os.getpid()}.json")
        trace = json.loads((prof_dir / name).read_text())
        events = trace["traceEvents"]
        assert events and all(e["ph"] == "X" for e in events)
        assert all(isinstance(e["ts"], float) and e["dur"] >= 0
                   for e in events)
        names = {e["name"] for e in events}
        assert top in names
        assert ({"stage", "fetch", "decode.file"} if path == "batch" else
                {"decode", "normalize", "report", "db"}) <= names
        assert set(trace["otherData"]["syncs"]) <= SITES
        # the epoch clock: within a day of now
        assert np.isclose(min(e["ts"] for e in events) / 1e6, time.time(),
                          atol=86400)
