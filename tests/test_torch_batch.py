"""The port's batch runner against the JAX package's, on the CPU.

``run_pipeline_batch(device="cpu")`` against ``mdx.pipeline.batch_runner.
run_pipeline_batch`` on a 3-frame 12-bit series (explicit LE and RLE) and
on a directory of 12-bit CT files (two with a VOI window) and 8-bit
ultrasound files (one MONOCHROME1), raw and ``--window``: the same frames
in the same order, and on the 12-bit frames metrics, issue masks,
validation fields and scores within ``mdx_torch.parity`` (the 8-bit
frames: ``tests/test_torch_batch_8bit.py``).  Resume works across the two
packages on one DB, and the port's autotune batch, chunking and errors
are checked on their own.
"""

import os

import numpy as np
import pytest

from mdx.pipeline import batch_runner as JB
from mdx_torch import parity
from mdx_torch.io import write_dicom, write_synthetic_dicom
from mdx_torch.io.dicom import TS_RLE
from mdx_torch.pipeline import batch_runner as PB
from mdx_torch.pipeline import storage as PST


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    return tmp_path / "runs.db"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch")
    series = write_synthetic_dicom(str(root / "series.dcm"), kind="phantom",
                                   size=64, frames=3, seed=1)
    series_rle = write_synthetic_dicom(str(root / "series_rle.dcm"),
                                       kind="phantom", size=64, frames=3,
                                       seed=1, transfer_syntax=TS_RLE)
    mixed = root / "mixed"
    mixed.mkdir()
    rng = np.random.default_rng(5)
    for i, kind in enumerate(("noisy", "phantom", "noisy")):
        kw = ({"window_center": 30000.0 - 4000 * i, "window_width": 20000.0}
              if i < 2 else {})
        write_synthetic_dicom(str(mixed / f"ct{i}.dcm"), kind=kind, size=64,
                              seed=10 + i, **kw)
    for i in range(2):
        write_dicom(str(mixed / f"us{i}.dcm"),
                    rng.integers(0, 256, (48, 80)).astype(np.uint8),
                    modality="US",
                    photometric="MONOCHROME1" if i else "MONOCHROME2")
    (mixed / "notes.txt").write_text("not a DICOM")
    return {"series": series, "series_rle": series_rle, "mixed": str(mixed)}


def _keys(ctx):
    return [(f["source"], f["frame"]) for f in ctx["frames"]]


def _assert_frames_close(got, want):
    assert [(f["source"], f["frame"], f["shape"]) for f in got] == [
        (f["source"], f["frame"], f["shape"]) for f in want]
    hw = got[0]["shape"][0] * got[0]["shape"][1]
    bad = parity.breaches(parity.flatten_batch(got),
                          parity.flatten_batch(want), hw=hw)
    assert not bad, bad


@pytest.mark.parametrize("window", [False, True])
def test_series_matches_jax(tmp_path, db, inputs, window):
    want = JB.run_pipeline_batch(inputs["series"], str(tmp_path / "j"),
                                 window=window)
    got = PB.run_pipeline_batch(inputs["series"], str(tmp_path / "p"),
                                window=window, device="cpu")
    assert got["mesh"] == {"data": 1, "space": 1} and got["skipped"] == 0
    assert _keys(got) == [("series.dcm", f) for f in range(3)]
    _assert_frames_close(got["frames"], want["frames"])
    rle = PB.run_pipeline_batch(inputs["series_rle"], str(tmp_path / "r"),
                                window=window, device="cpu")
    for a, b in zip(rle["frames"], got["frames"]):
        assert {k: v for k, v in a.items() if k not in ("run_id", "source")
                } == {k: v for k, v in b.items()
                      if k not in ("run_id", "source")}
    report = (tmp_path / "p" / "batch_report.md").read_text()
    assert "Frames processed: **3**" in report


@pytest.mark.parametrize("window", [False, True])
def test_directory_matches_jax(tmp_path, db, inputs, window):
    want = JB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "j"),
                                 window=window)
    got = PB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "p"),
                                window=window, device="cpu")
    assert _keys(got) == _keys(want)
    assert sorted(_keys(got)) == [(f"{n}.dcm", 0) for n in
                                  ("ct0", "ct1", "ct2", "us0", "us1")]
    # the 8-bit frames: tests/test_torch_batch_8bit.py
    ct = [f for f in got["frames"] if f["source"].startswith("ct")]
    _assert_frames_close(ct, [f for f in want["frames"]
                              if f["source"].startswith("ct")])
    rows = PST.list_runs()
    assert sorted(r["input_filename"] for r in rows) == sorted(
        [f"{s}#frame{f}" for s, f in _keys(got)] * 2)


def test_resume_across_packages(tmp_path, db, inputs):
    JB.run_pipeline_batch(inputs["series"], str(tmp_path / "j"))
    got = PB.run_pipeline_batch(inputs["series"], str(tmp_path / "p"),
                                resume=True, device="cpu")
    assert got["skipped"] == 3 and got["frames"] == []
    PB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "p"),
                          device="cpu")
    want = JB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "j"),
                                 resume=True)
    assert want["skipped"] == 5 and want["frames"] == []
    again = PB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "p"),
                                  resume=True, device="cpu")
    assert again["skipped"] == 5 and again["frames"] == []


def test_chunks_give_the_same_records(tmp_path, db, inputs, monkeypatch):
    whole = PB.run_pipeline_batch(inputs["series"], str(tmp_path / "a"),
                                  device="cpu", save_artifacts=False)
    monkeypatch.setattr(PB, "CHUNK", 2)
    chunked = PB.run_pipeline_batch(inputs["series"], str(tmp_path / "b"),
                                    device="cpu", save_artifacts=False)
    strip = lambda fs: [{k: v for k, v in f.items() if k != "run_id"}  # noqa: E731
                        for f in fs]
    assert strip(chunked["frames"]) == strip(whole["frames"])
    assert not os.path.exists(tmp_path / "a")


@pytest.mark.parametrize("window", [False, True])
def test_autotune_batch_on_the_directory(tmp_path, db, inputs, window):
    got = PB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "p"),
                                window=window, autotune=True, device="cpu")
    assert sorted(_keys(got)) == [(f"{n}.dcm", 0) for n in
                                  ("ct0", "ct1", "ct2", "us0", "us1")]
    flat = parity.flatten_batch(got["frames"])
    for k, v in flat.items():
        assert v.dtype == bool or k.endswith("psnr") or np.isfinite(v).all(), k
    plain = PB.run_pipeline_batch(inputs["mixed"], str(tmp_path / "q"),
                                  window=window, device="cpu")
    # the sweep starts from the same detection as the issue-driven run
    by_key = {(f["source"], f["frame"]): f for f in plain["frames"]}
    for f in got["frames"]:
        assert f["issues"] == by_key[(f["source"], f["frame"])]["issues"]
        assert f["metrics"] == by_key[(f["source"], f["frame"])]["metrics"]


def test_errors(tmp_path, db):
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="No DICOM inputs"):
        PB.run_pipeline_batch(str(tmp_path / "empty"), str(tmp_path / "o"),
                              device="cpu")
