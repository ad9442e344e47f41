"""The rank pool (``mdx_torch.parallel.pool``) under ``run_pipeline_batch``
at n_data = 2, on the CPU: rank 0 is this process, rank 1 a spawned
process (gloo).

One pool serves the module: rank 1 starts once and every run reuses it.
Held here: two runs start the rank once; the records equal n_data = 1's
bit for bit (``run_id`` aside) on a multi-frame series split by frame
ranges and on a mixed directory (two buckets, windowed), with this
process reading its own share alone; a resumed run skips every frame and
reads, starts and calls nothing; a rank that raises gives the caller its
traceback and the pool serves the next run, as after a rank function that
cannot be pickled, which raises at once; a killed rank is replaced on the
next run; the rank's spans come back tagged with its rank while
tracing is on; the primer at n_data = 2 runs every chunk on both ranks
of the pool in one call and leaves the pool to the next run; ``close``
leaves no rank alive.
"""

import multiprocessing
import os
import pickle

import numpy as np
import pytest
import torch

from mdx_torch import telemetry
from mdx_torch.io import write_dicom, write_synthetic_dicom
from mdx_torch.io.dicom import DicomError
from mdx_torch.parallel import launch, pool
from mdx_torch.pipeline import batch_runner as PR

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    """The module's pool of two gloo ranks, stopped at the module's end."""
    pool.close()
    yield pool.get(2, "cpu")
    pool.close()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rank_pool")
    series = write_synthetic_dicom(str(root / "series.dcm"), kind="phantom",
                                   size=64, frames=5, seed=3)
    mixed = root / "mixed"
    mixed.mkdir()
    rng = np.random.default_rng(7)
    for i, kind in enumerate(("noisy", "phantom", "clipped", "noisy")):
        kw = ({"window_center": 30000.0 - 4000 * i, "window_width": 20000.0}
              if i < 3 else {})
        write_synthetic_dicom(str(mixed / f"ct{i}.dcm"), kind=kind, size=64,
                              seed=20 + i, **kw)
    for i in range(3):
        write_dicom(str(mixed / f"us{i}.dcm"),
                    rng.integers(0, 256, (48, 80)).astype(np.uint8),
                    modality="US",
                    photometric="MONOCHROME1" if i else "MONOCHROME2")
    return {"series": series, "mixed": str(mixed)}


@pytest.fixture(autouse=True)
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    monkeypatch.delenv("MDX_PROFILE_DIR", raising=False)


def _strip(frames):
    return [{k: v for k, v in f.items() if k != "run_id"} for f in frames]


def _reads_nothing(monkeypatch):
    """Every way this process could read a pixel value raises."""
    def refuse(*a, **kw):
        raise AssertionError("the parent read pixel data")

    for name in ("_collect_inputs_raw", "read_frame_into", "load_frames_raw",
                 "_decode_raw", "load_series", "load_dicom"):
        monkeypatch.setattr(PR, name, refuse)
    monkeypatch.setattr(launch, "run", refuse)


def test_two_runs_start_the_ranks_once(ranks, inputs, tmp_path):
    pool.close()
    starts = telemetry.RANKS.get("starts", 0)
    a = PR.run_pipeline_batch(inputs["mixed"], str(tmp_path / "a"),
                              device="cpu", n_data=2)
    first = pool._POOL
    b = PR.run_pipeline_batch(inputs["mixed"], str(tmp_path / "b"),
                              device="cpu", n_data=2)
    assert telemetry.RANKS.get("starts", 0) - starts == 1
    assert a["launch"]["starts"] == 1 and b["launch"]["starts"] == 0
    assert pool._POOL is first and first.alive()
    assert b["launch"]["backend"] == "gloo" and b["launch"]["n_data"] == 2
    assert sum(b["launch"]["rank_frames"]) == len(b["frames"]) == 7
    assert b["launch"]["threads"] >= 2
    assert _strip(a["frames"]) == _strip(b["frames"])


@pytest.mark.parametrize("which,window,chunk", [("series", False, 2),
                                                ("series", True, 64),
                                                ("mixed", True, 2)])
def test_records_equal_one_rank(ranks, inputs, tmp_path, monkeypatch, which,
                                window, chunk):
    monkeypatch.setattr(PR, "CHUNK", chunk)
    path = inputs[which]
    one = PR.run_pipeline_batch(path, str(tmp_path / "one"), window=window,
                                device="cpu", n_data=1, save_artifacts=False)
    staged, real = [], PR._collect_inputs_raw

    def mine(*a, **kw):
        staged.append((kw["names"], kw["frames"]))
        return real(*a, **kw)

    monkeypatch.setattr(PR, "_collect_inputs_raw", mine)
    monkeypatch.setattr(launch, "run", None)
    two = PR.run_pipeline_batch(path, str(tmp_path / "two"), window=window,
                                device="cpu", n_data=2)
    assert two["launch"]["starts"] == 0
    assert _strip(two["frames"]) == _strip(one["frames"])
    # this process staged share 0 alone: the first half of the files, or
    # of the frames (a series is split by frame ranges)
    n = len(one["frames"])
    assert two["launch"]["rank_frames"] == [(n + 1) // 2, n // 2]
    if which == "series":
        assert staged == [(None, (0, (n + 1) // 2))]
    else:
        names = sorted(os.listdir(path))
        assert staged == [(names[:(n + 1) // 2], None)]
    rows = (tmp_path / "two" / "batch_report.md").read_text()
    assert f"Frames processed: **{len(one['frames'])}**" in rows


def test_resume_starts_and_calls_nothing(ranks, inputs, tmp_path,
                                         monkeypatch):
    for path in (inputs["series"], inputs["mixed"]):
        first = PR.run_pipeline_batch(path, str(tmp_path / "o"),
                                      device="cpu", n_data=2)
        counts = dict(telemetry.RANKS)
        with monkeypatch.context() as m:
            _reads_nothing(m)
            again = PR.run_pipeline_batch(path, str(tmp_path / "o"),
                                          resume=True, device="cpu",
                                          n_data=2)
        assert telemetry.RANKS == counts and again["launch"] is None
        assert again["frames"] == []
        assert again["skipped"] == len(first["frames"])


def test_partly_resumed_series_runs_the_rest(ranks, inputs, tmp_path,
                                             monkeypatch):
    """A series whose first frames are in the DB: the rest is split, and
    their records equal n_data = 1's."""
    monkeypatch.setattr(PR, "CHUNK", 2)
    path = inputs["series"]
    label = os.path.basename(path)
    want = PR.run_pipeline_batch(path, str(tmp_path / "w"), device="cpu",
                                 n_data=1, save_artifacts=False)["frames"]
    monkeypatch.setattr(PR, "_completed_frames",
                        lambda: {f"{label}#frame0", f"{label}#frame1"})
    got = PR.run_pipeline_batch(path, str(tmp_path / "g"), resume=True,
                                device="cpu", n_data=2)
    assert got["skipped"] == 2 and got["launch"]["rank_frames"] == [2, 1]
    assert _strip(got["frames"]) == _strip(want[2:])


def test_rank_that_raises_gives_its_traceback(ranks, inputs, tmp_path):
    p = pool.get(2, "cpu")
    starts = telemetry.RANKS.get("starts", 0)
    kw = dict(input_path=str(tmp_path / "missing.dcm"), window=False,
              done=set(), chunk_n=2, threads=2, trace=False)
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as err:
        p.call(PR.stage_block, [({"names": []},), ({"frames": (0, 1)},)],
               **kw)
    assert "Traceback" in str(err.value) and "DicomError" in str(err.value)
    # rank 0's own error is raised as it is, once rank 1 has replied
    with pytest.raises(DicomError):
        p.call(PR.stage_block, [({"frames": (0, 1)},), ({"names": []},)],
               **kw)
    res = PR.run_pipeline_batch(inputs["series"], str(tmp_path / "o"),
                                device="cpu", n_data=2)
    assert pool._POOL is p and res["launch"]["starts"] == 0
    assert telemetry.RANKS.get("starts", 0) == starts
    assert len(res["frames"]) == 5


def test_unpicklable_call_raises_at_once(ranks, inputs, tmp_path):
    """A rank function that cannot be pickled raises in the caller before
    anything is sent (a queue would drop it and leave the call waiting),
    and the pool serves the next run."""
    p = pool.get(2, "cpu")
    with pytest.raises((AttributeError, TypeError, pickle.PicklingError)):
        p.call(lambda share, **kw: share, [(0,), (1,)])
    res = PR.run_pipeline_batch(inputs["series"], str(tmp_path / "o"),
                                device="cpu", n_data=2)
    assert pool._POOL is p and res["launch"]["starts"] == 0
    assert len(res["frames"]) == 5


def test_killed_rank_is_replaced(ranks, inputs, tmp_path):
    p = pool.get(2, "cpu")
    old = list(p.pids)
    p._procs[0].kill()
    p._procs[0].join(timeout=10)
    assert not p.alive()
    res = PR.run_pipeline_batch(inputs["series"], str(tmp_path / "o"),
                                device="cpu", n_data=2)
    assert res["launch"]["starts"] == 1 and len(res["frames"]) == 5
    fresh = pool._POOL
    assert fresh is not p and fresh.alive()
    assert fresh.pids[0] == old[0] == os.getpid()
    assert fresh.pids[1] != old[1]


def test_rank_spans_come_back_tagged(ranks, inputs, tmp_path):
    pool.get(2, "cpu")
    telemetry.reset()
    telemetry.enable()
    try:
        PR.run_pipeline_batch(inputs["mixed"], str(tmp_path / "o"),
                              device="cpu", n_data=2)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    stages = {"decode.header", "decode.file", "upload", "launch", "fetch"}
    mine = {s[0] for s in snap["spans"] if "rank" not in s[4]}
    assert {"batch", "list", "ranks.dispatch", "ranks.wait",
            "collect"} | stages <= mine
    theirs = [s for s in snap["spans"] if s[4].get("rank") == 1]
    assert stages <= {s[0] for s in theirs}
    # one clock for both processes: the rank's spans lie between this
    # process's dispatch and the end of its wait
    (sent,) = [s for s in snap["spans"] if s[0] == "ranks.dispatch"]
    (wait,) = [s for s in snap["spans"] if s[0] == "ranks.wait"]
    assert all(sent[1] <= s[1] <= s[2] <= wait[2] for s in theirs)
    assert snap["ranks"] == {"calls": 1}
    trace = telemetry.chrome_trace(snap)
    assert {e["pid"] for e in trace["traceEvents"]} == set(
        pool._POOL.pids)


def test_prime_warms_the_pool_batch_runs_on(ranks, inputs, tmp_path,
                                            monkeypatch):
    from mdx_torch.pipeline import prime as PP

    p = pool.get(2, "cpu")
    starts = telemetry.RANKS.get("starts", 0)
    calls, real = [], pool.RankPool.call

    def spy(self, fn, args, **kw):
        out = real(self, fn, args, **kw)
        calls.append((fn, args, kw, out))
        return out

    monkeypatch.setattr(pool.RankPool, "call", spy)
    monkeypatch.setattr(launch, "run", None)
    n = PP.prime([(32, 32)], chunk=3, dtypes=("uint16", "float32"),
                 n_data=2, device="cpu")
    # the single pass + uint16 × 2 window modes + float32 unwindowed
    assert n == 4
    ((fn, args, kw, ran),) = calls
    assert fn is PP.prime_chunks and kw == {"n": 3}
    assert args == [([(32, 32, "uint16", False), (32, 32, "uint16", True),
                      (32, 32, "float32", False)],)] * 2
    # both ranks ran all three chunks at 3 frames each
    assert [[frames for frames, _ in r] for r in ran] == [[3, 3, 3]] * 2
    assert telemetry.RANKS.get("starts", 0) == starts
    res = PR.run_pipeline_batch(inputs["series"], str(tmp_path / "o"),
                                device="cpu", n_data=2)
    assert pool._POOL is p and res["launch"]["starts"] == 0
    assert len(res["frames"]) == 5


def test_close_leaves_no_rank(ranks):
    p = pool.get(2, "cpu")
    pids = list(p.pids[1:])
    pool.close()
    assert pool._POOL is None and not p.alive()
    alive = {c.pid for c in multiprocessing.active_children()}
    assert not alive & set(pids)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
