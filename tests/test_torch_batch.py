"""The port's batch runner against the JAX package's, on the CPU.

``run_pipeline_batch(device="cpu")`` against ``mdx.pipeline.batch_runner.
run_pipeline_batch`` on a 3-frame 12-bit series (explicit LE and RLE) and
on a directory of 12-bit CT files (two with a VOI window) and 8-bit
ultrasound files (one MONOCHROME1), raw and ``--window``: the same frames
in the same order, and on the 12-bit frames metrics, issue masks,
validation fields and scores within ``mdx_torch.parity`` (the 8-bit
frames: ``tests/test_torch_batch_8bit.py``).  Resume works across the two
packages on one DB, and the port's autotune batch, chunking and errors
are checked on their own.  The staging of the deterministic path: each
file's frame in its chunk's upload buffer equals ``load_frames_raw``'s,
file by file and syntax by syntax, whether read in place or copied; the
files that are not read in place decode on the decode threads; the
header read leaves the pixels in the file; a file that fails is skipped
and its chunk compacted; resume reads no done frame; chunks are pinned
within the budget; and the records equal those of the stacked frames.
"""

import logging
import os
import struct

import numpy as np
import pytest

from mdx.pipeline import batch_runner as JB
from mdx_torch import parity, telemetry
from mdx_torch.io import normalize_image, write_dicom, write_synthetic_dicom
from mdx_torch.io.dicom import (TS_EXPLICIT_BE, TS_EXPLICIT_LE, TS_JPEG_LS,
                                TS_RLE, DicomError, load_frames_raw)
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


def _crafted(path, pix: np.ndarray, ts: str, *, samples: int = 1,
             photometric: str = "MONOCHROME2") -> str:
    """A single-frame file in a layout the writers do not produce
    (explicit big-endian, or interleaved RGB)."""
    e = ">" if ts == TS_EXPLICIT_BE else "<"

    def el(group, elem, vr, value: bytes, order=e) -> bytes:
        value += b"\x00" * (len(value) % 2)
        if vr in (b"OB", b"OW"):
            return struct.pack(order + "HH2sHI", group, elem, vr, 0,
                               len(value)) + value
        return struct.pack(order + "HH2sH", group, elem, vr,
                           len(value)) + value

    us = lambda v: struct.pack(e + "H", v)  # noqa: E731
    bits = pix.dtype.itemsize * 8
    body = b"".join([
        el(0x0008, 0x0060, b"CS", b"CT"),
        el(0x0028, 0x0002, b"US", us(samples)),
        el(0x0028, 0x0004, b"CS", photometric.encode()),
        el(0x0028, 0x0010, b"US", us(pix.shape[0])),
        el(0x0028, 0x0011, b"US", us(pix.shape[1])),
        el(0x0028, 0x0100, b"US", us(bits)),
        el(0x0028, 0x0101, b"US", us(bits)),
        el(0x0028, 0x0103, b"US", us(int(pix.dtype.kind == "i"))),
        el(0x7FE0, 0x0010, b"OW" if bits == 16 else b"OB",
           pix.astype(pix.dtype.newbyteorder(e)).tobytes())])
    meta = el(0x0002, 0x0010, b"UI", ts.encode(), "<")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM"
                + el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)),
                     "<") + meta + body)
    return str(path)


def _case_file(path, kind: str, rng) -> bool:
    """Write the case's file → whether its frame is read in place."""
    u16 = rng.integers(0, 4096, (64, 64)).astype(np.uint16)
    if kind in ("le_uint16", "le_int16", "le_uint8"):
        pix = {"le_uint16": u16,
               "le_int16": (u16.astype(np.int16) - 2048),
               "le_uint8": (u16 >> 4).astype(np.uint8)}[kind]
        write_dicom(path, pix, rescale_slope=0.5, rescale_intercept=-7.0,
                    photometric="MONOCHROME1" if kind == "le_int16"
                    else "MONOCHROME2")
        return True
    if kind == "explicit_be":
        _crafted(path, u16, TS_EXPLICIT_BE)
    elif kind in ("rle", "jpeg_ls"):
        write_dicom(path, u16, transfer_syntax={"rle": TS_RLE,
                                                "jpeg_ls": TS_JPEG_LS}[kind])
    elif kind == "multiframe":
        write_dicom(path, rng.integers(0, 4096, (3, 64, 64)).astype(
            np.uint16))
    elif kind == "int8":
        write_dicom(path, rng.integers(-128, 128, (64, 64)).astype(np.int8))
    else:   # rgb
        _crafted(path, rng.integers(0, 256, (64, 64, 3)).astype(np.uint8),
                 TS_EXPLICIT_LE, samples=3, photometric="RGB")
    return False


def _expected(path, window: bool):
    """``load_frames_raw``'s frame as the runner stages it: int8 widened,
    a stack's middle frame, float32 fallbacks min-max normalised."""
    frames, desc, meta = load_frames_raw(path, window=window)
    if frames.dtype == np.int8:
        frames = frames.astype(np.int16)
    frame = frames[frames.shape[0] // 2]
    if desc is None and not window:
        frame = normalize_image(frame)
    return frame, desc, meta


def _staged(buckets) -> dict:
    """label → (frame, descriptor, metadata, its chunk's tensor)."""
    return {e[0]: (e[2], e[4], e[3], x) for _h, _w, chunks in buckets
            for entries, x in chunks for e in entries}


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("kind", ["le_uint16", "le_int16", "le_uint8",
                                  "explicit_be", "rle", "jpeg_ls",
                                  "multiframe", "int8", "rgb"])
def test_staged_frames_equal_load_frames_raw(tmp_path, kind, window):
    rng = np.random.default_rng(11)
    for name in ("a", "c"):
        write_synthetic_dicom(str(tmp_path / f"{name}.dcm"), kind="phantom",
                              size=64, seed=ord(name), window_center=900.0,
                              window_width=1800.0)
    in_place = _case_file(str(tmp_path / "b.dcm"), kind, rng)
    telemetry.reset()
    buckets, n_files, skipped = PB._collect_inputs_raw(
        str(tmp_path), window=window)
    assert (n_files, skipped) == (3, 0)
    assert telemetry.STAGED == {"in_place": 2 + in_place,
                                **({} if in_place else {"copied": 1})}
    staged = _staged(buckets)
    assert sorted(staged) == ["a.dcm", "b.dcm", "c.dcm"]
    for label, (frame, desc, meta, x) in staged.items():
        want, want_desc, want_meta = _expected(str(tmp_path / label), window)
        assert frame.dtype == want.dtype and np.array_equal(frame, want)
        assert desc == want_desc and meta == want_meta
        # the frame is a slot of its chunk's buffer, not a copy beside it
        assert np.shares_memory(frame, x.numpy())
    for _h, _w, chunks in buckets:
        for entries, x in chunks:
            assert x.shape[0] == len(entries)
            assert not x.is_pinned()


def test_failed_files_are_skipped_and_their_chunk_compacted(
        tmp_path, monkeypatch, caplog):
    for name in "abcde":
        write_synthetic_dicom(str(tmp_path / f"{name}.dcm"), kind="noisy",
                              size=64, seed=ord(name))
    (tmp_path / "b.dcm").write_bytes(b"not a DICOM at all")
    read = PB.read_frame_into

    def flaky(path, ds, out):
        if path.endswith("d.dcm"):      # fails after its header was read
            raise DicomError("Truncated DICOM stream.")
        read(path, ds, out)

    monkeypatch.setattr(PB, "read_frame_into", flaky)
    with caplog.at_level(logging.WARNING, logger=PB.__name__):
        buckets, n_files, skipped = PB._collect_inputs_raw(str(tmp_path),
                                                           chunk_n=2)
    warned = [r.getMessage() for r in caplog.records]
    assert [m.split(":")[0] for m in warned] == ["Skipping b.dcm",
                                                 "Skipping d.dcm"]
    assert (n_files, skipped) == (3, 0)
    (_h, _w, chunks), = buckets
    # chunks [a, c], [d, e] before the pixel pass; [d, e] compacted to [e]
    assert [[e[0] for e in entries] for entries, _ in chunks] == [
        ["a.dcm", "c.dcm"], ["e.dcm"]]
    for entries, x in chunks:
        assert x.shape[0] == len(entries)
        for i, e in enumerate(entries):
            assert np.shares_memory(e[2], x.numpy()[i])
            assert np.array_equal(
                e[2], load_frames_raw(str(tmp_path / e[0]))[0][0])


def test_resume_reads_no_done_frame(tmp_path, monkeypatch):
    for i, name in enumerate("abcd"):
        if name == "c":
            write_dicom(str(tmp_path / "c.dcm"), np.arange(
                64 * 64, dtype=np.uint16).reshape(64, 64),
                transfer_syntax=TS_RLE)
        else:
            write_synthetic_dicom(str(tmp_path / f"{name}.dcm"),
                                  kind="noisy", size=64, seed=i)
    reads = []
    real_read, real_decode = PB.read_frame_into, PB._decode_raw
    monkeypatch.setattr(PB, "read_frame_into", lambda path, ds, out: (
        reads.append(os.path.basename(path)), real_read(path, ds, out)))
    monkeypatch.setattr(PB, "_decode_raw", lambda path, name, window: (
        reads.append(name), real_decode(path, name, window))[1])
    telemetry.reset()
    buckets, n_files, skipped = PB._collect_inputs_raw(
        str(tmp_path), done={"a.dcm#frame0", "c.dcm#frame0"})
    assert (n_files, skipped) == (4, 2)
    assert sorted(reads) == ["b.dcm", "d.dcm"]
    assert sorted(_staged(buckets)) == ["b.dcm", "d.dcm"]
    assert telemetry.STAGED == {"in_place": 2}
    reads.clear()
    _buckets, _n, skipped = PB._collect_inputs_raw(
        str(tmp_path), done={f"{n}.dcm#frame0" for n in "abcd"})
    assert skipped == 4 and reads == [] and _buckets == []


def test_records_equal_the_stacked_frames(tmp_path, db):
    """The staged buffers give each frame the record its decoded frames
    give when stacked and uploaded as numpy arrays."""
    rng = np.random.default_rng(3)
    for name, kind in (("a", "le_uint16"), ("b", "explicit_be"),
                       ("c", "rle"), ("d", "int8"), ("e", "le_uint16")):
        _case_file(str(tmp_path / f"{name}.dcm"), kind, rng)
    got = PB.run_pipeline_batch(str(tmp_path), str(tmp_path / "o"),
                                device="cpu", save_artifacts=False)
    by_dtype: dict = {}
    for name in "abcde":
        frame, desc, _ = _expected(str(tmp_path / f"{name}.dcm"), False)
        by_dtype.setdefault(str(frame.dtype), []).append(
            (f"{name}.dcm", frame, desc))
    want = {}
    for _kind, group in sorted(by_dtype.items()):
        packed = PB._Fetch(PB._device_qa(
            np.stack([g[1] for g in group]),
            PB._ingest_params([g[2] for g in group], False), PB.resolve_device(
                "cpu"), False), None).result()
        for i, (label, _f, _d) in enumerate(group):
            want[label] = packed[:, i]
    recs = []
    PB._collect([(label, 0, None, {}, None) for label in want],
                np.stack([want[k] for k in want], axis=1), 64, 64, recs,
                False)
    strip = lambda r: {k: v for k, v in r.items() if k != "run_id"}  # noqa: E731
    assert ([strip(r) for r in got["frames"]]
            == [strip(r) for r in recs])


def test_coded_files_decode_on_the_pool_threads(tmp_path, monkeypatch):
    """Files that are not read in place are decoded on the decode threads,
    not on the thread of the header pass, and copied into their slots."""
    import threading

    rng = np.random.default_rng(5)
    kinds = ("rle", "jpeg_ls", "rle", "le_uint16", "explicit_be", "int8")
    for i, kind in enumerate(kinds):
        _case_file(str(tmp_path / f"{i}.dcm"), kind, rng)
    threads, real = [], PB._decode_raw

    def spy(path, name, window):
        threads.append(threading.get_ident())
        return real(path, name, window)

    monkeypatch.setattr(PB, "_decode_raw", spy)
    telemetry.reset()
    buckets, n_files, skipped = PB._collect_inputs_raw(str(tmp_path))
    assert (n_files, skipped) == (6, 0)
    assert len(threads) == 5
    assert threading.main_thread().ident not in threads
    assert telemetry.STAGED == {"in_place": 1, "copied": 5}
    for label, (frame, desc, _meta, _x) in _staged(buckets).items():
        want, want_desc, _ = _expected(str(tmp_path / label), False)
        assert np.array_equal(frame, want) and desc == want_desc


@pytest.mark.parametrize("ts", [TS_EXPLICIT_LE, TS_RLE, TS_JPEG_LS])
def test_header_read_leaves_the_pixels_in_the_file(tmp_path, ts):
    """``read_dataset(path, pixels=False)`` keeps every attribute and no
    pixel value: a native value's place is recorded, an encapsulated
    value's items are skipped; a file cut inside its pixel value fails."""
    from mdx_torch.io.dicom import read_dataset

    path = str(tmp_path / "a.dcm")
    write_dicom(path, np.random.default_rng(2).integers(
        0, 4096, (64, 64)).astype(np.uint16), transfer_syntax=ts)
    full, head = read_dataset(path), read_dataset(path, pixels=False)
    assert head.attrs == full.attrs
    assert head.transfer_syntax == full.transfer_syntax == ts
    assert head.pixel_bytes == b"" and head.fragments is None
    data = open(path, "rb").read()
    if ts == TS_EXPLICIT_LE:
        assert (head.pixel_offset, head.pixel_length) == (
            len(data) - len(full.pixel_bytes), len(full.pixel_bytes))
    else:
        assert head.pixel_offset == -1 and full.fragments
    cut = tmp_path / "cut.dcm"
    cut.write_bytes(data[:len(data) - 40])
    with pytest.raises(DicomError, match="Truncated"):
        read_dataset(str(cut), pixels=False)


@pytest.mark.parametrize("budget,pinned", [(32768, [2, 2]), (24576, [2, 1]),
                                           (0, [])])
def test_chunks_are_pinned_within_the_budget(tmp_path, monkeypatch, budget,
                                             pinned):
    """With ``pin``, a chunk's buffer is pinned while the pinned sum stays
    within ``_PIN_BYTES`` (here chunks of 2, 2 and 1 64² uint16 frames:
    16, 16 and 8 KiB); without ``pin`` none is.  The frames of each chunk
    are those ``load_frames_raw`` reads, pinned or not."""
    import torch

    for name in "abcde":
        write_synthetic_dicom(str(tmp_path / f"{name}.dcm"), kind="noisy",
                              size=64, seed=ord(name))
    asked, empty = [], torch.empty

    def spy(shape, *, pin_memory=False, **kwargs):
        if pin_memory:          # this build has no pinned memory
            asked.append(shape[0])
        return empty(shape, **kwargs)

    monkeypatch.setattr(PB, "_PIN_BYTES", budget)
    monkeypatch.setattr(torch, "empty", spy)
    buckets, _n, _s = PB._collect_inputs_raw(str(tmp_path), chunk_n=2,
                                             pin=True)
    assert asked == pinned
    for label, (frame, _d, _m, _x) in _staged(buckets).items():
        assert np.array_equal(
            frame, load_frames_raw(str(tmp_path / label))[0][0])
    asked.clear()
    PB._collect_inputs_raw(str(tmp_path), chunk_n=2)
    assert asked == []
