"""The port's reader and writer on JPEG Lossless (``.4.57``, ``.4.70``),
JPEG-LS (``.4.80``, ``.4.81``) and JPEG 2000 (``.4.90``, ``.4.91``) files,
against the JAX package's on the same files, and the port's CLI on such
files.

* ``load_dicom``, ``load_series`` and ``load_frames_raw`` (and
  ``decode_pixels``) equal to JAX's, bit for bit, on files written by JAX's
  writer: single and multi-frame, uint8, uint16 and int16, frames that span
  fragments, fragment counts that differ from the frame count, ``.4.57``
  and ``.4.81`` by UID rewrite; the same ``DicomError`` messages for a
  container too narrow, 32-bit containers, corrupt frames, frame shapes and
  groupings that disagree with the dataset;
* frames decoded on threads equal to frames decoded serially, RLE frames
  through the same pool;
* the writer: ``.4.91``, ``.4.57`` and ``.4.81`` refused with their UID
  by both packages (the byte-equal files of ``.4.70``, ``.4.80`` and
  ``.4.90`` are in ``tests/test_torch_io.py``);
* ``main(["--input", f], device="cpu")`` on a 64^2 ``.4.70`` and ``.4.90``
  slice and, with ``--batch``, a 3-frame ``.4.80`` and ``.4.90`` series:
  rc 0, records equal to its explicit-LE twin's run and to JAX's
  ``main.py`` within ``parity``; and on the committed ``.4.91`` fixture
  (``tests/torch_fixtures/j2k/``, a YBR_ICT file): rc 0, the report and
  records as JAX's.

JPEG 2000 frames from Pillow's encoder (9/7, colour, JP2, grouping) are in
``tests/test_torch_jpeg2k.py``.

The JAX reader sends a modality rescale to its C++ loop, which differs from
numpy's by one ulp (ROADMAP Queue 3); the comparisons run its numpy body,
as ``tests/test_torch_io.py`` does.
"""

import re
import struct
from pathlib import Path

import numpy as np
import pytest

import main as jax_main
from mdx.io import dicom as JD
from mdx.io import dicom_write as JW
from mdx.io import jpegls as JS
from mdx_torch import __main__ as cli
from mdx_torch import parity
from mdx_torch.io import dicom as PD
from mdx_torch.io import dicom_write as PW
from mdx_torch.io import native

SYNTAXES = {"jpeg_ll": JD.TS_JPEG_LL_SV1, "jpeg_ls": JD.TS_JPEG_LS,
            "j2k": JD.TS_J2K_LOSSLESS}
# the host entry point each syntax decodes through
DECODE_CALL = {"jpeg_ll": "jpegll_diffs", "jpeg_ls": "jpegls_decode",
               "j2k": "jpeg2k_t1_block"}


@pytest.fixture
def _jax_numpy_rescale(monkeypatch):
    """Route the JAX reader's rescale to its numpy body."""
    from mdx.io import native as jax_native

    def refuse(*a, **k):
        raise jax_native.NativeUnavailable("numpy body under test")

    monkeypatch.setattr(jax_native, "rescale_f32", refuse)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _assert_reads_equal(path: str):
    for window in (False, True):
        for load in ("load_dicom", "load_series", "load_frames_raw"):
            _same(getattr(PD, load)(path, window=window),
                  getattr(JD, load)(path, window=window))
    _same(PD.decode_pixels(PD.read_dataset(path)),
          JD.decode_pixels(JD.read_dataset(path)))


def _pixels(case: str):
    rng = np.random.default_rng(len(case))
    if case == "u8":
        return rng.integers(0, 256, (3, 24, 20)).astype(np.uint8), {}
    if case == "u16":
        return rng.integers(0, 65536, (24, 20)).astype(np.uint16), {}
    if case == "int16_full":
        pix = rng.integers(-32768, 32768, (2, 20, 24)).astype(np.int16)
        pix[0, 0, :4] = [-32768, 32767, -1, 0]
        return pix, {"rescale_slope": 1.0, "rescale_intercept": 0.0}
    # 12-bit CT with a window, MONOCHROME1, several frames
    y, x = np.mgrid[0:32, 0:32]
    ct = (2048 + 1000 * np.sin(x / 5.0) * np.cos(y / 7.0)
          + rng.normal(0, 20, (4, 32, 32)))
    return (np.clip(ct, 0, 4095).astype(np.uint16),
            {"rescale_slope": 1.0, "rescale_intercept": -1024.0,
             "window_center": 40.0, "window_width": 400.0,
             "photometric": "MONOCHROME1"})


@pytest.mark.parametrize("case", ["u8", "u16", "int16_full", "ct_series"])
@pytest.mark.parametrize("syntax", sorted(SYNTAXES))
def test_reader_matches_jax(tmp_path, _jax_numpy_rescale, syntax, case):
    pix, kw = _pixels(case)
    path = JW.write_dicom(str(tmp_path / "f.dcm"), pix,
                          transfer_syntax=SYNTAXES[syntax], **kw)
    native.reset_calls()
    PD.decode_pixels(PD.read_dataset(path))
    once = native.CALLS[DECODE_CALL[syntax]]  # JPEG 2000: one a code-block
    if syntax != "j2k":
        assert once == (pix.shape[0] if pix.ndim == 3 else 1)
    native.reset_calls()
    _assert_reads_equal(path)
    assert native.CALLS[DECODE_CALL[syntax]] == 7 * once > 0
    twin = JW.write_dicom(str(tmp_path / "le.dcm"), pix, **kw)
    _same(PD.load_frames_raw(path), PD.load_frames_raw(twin))


_PIXEL_TAG = struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)


def _with_fragments(src: str, dst: str, frags: list) -> str:
    """``src`` with its encapsulated pixel data replaced by ``frags`` (each
    of even length, as PS3.5 A.4 asks)."""
    raw = open(src, "rb").read()
    i = raw.index(_PIXEL_TAG) + len(_PIXEL_TAG)
    items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
    for f in frags:
        assert len(f) % 2 == 0
        items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f)
    items.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    with open(dst, "wb") as fh:
        fh.write(raw[:i] + b"".join(items))
    return dst


def _split(frag: bytes, at: int) -> list:
    at -= at % 2
    return [frag[:at], frag[at:]]


@pytest.mark.parametrize("layout", ["single_spanning", "grouped_on_soi",
                                    "all_in_one_frame"])
@pytest.mark.parametrize("syntax", sorted(SYNTAXES))
def test_fragments_that_are_not_frames(tmp_path, _jax_numpy_rescale, syntax,
                                       layout):
    rng = np.random.default_rng(4)
    frames = 1 if layout != "grouped_on_soi" else 3
    pix = rng.integers(0, 4096, (frames, 24, 24)).astype(np.uint16)
    src = JW.write_dicom(str(tmp_path / "src.dcm"), pix[0] if frames == 1
                         else pix, transfer_syntax=SYNTAXES[syntax])
    frags = JD.read_dataset(src).fragments
    if layout == "grouped_on_soi":            # 3 frames in 5 fragments
        new = _split(frags[0], 50) + [frags[1]] + _split(frags[2], 21)
    elif layout == "single_spanning":
        new = _split(frags[0], 37) + [b""]
        new = [new[0], new[1][:20], new[1][20:]]
    else:                                     # one frame, many small pieces
        new = [frags[0][k:k + 16] for k in range(0, len(frags[0]), 16)]
    path = _with_fragments(src, str(tmp_path / "f.dcm"), new)
    assert len(PD.read_dataset(path).fragments) == len(new) != frames
    _assert_reads_equal(path)
    got = PD.decode_pixels(PD.read_dataset(path))
    assert np.array_equal(got.reshape(pix.shape), pix)


@pytest.mark.parametrize("uid,near", [(JD.TS_JPEG_LL, 0),
                                      (JD.TS_JPEG_LS_NEAR, 2)])
def test_process14_and_near_lossless_by_uid_rewrite(tmp_path,
                                                    _jax_numpy_rescale, uid,
                                                    near):
    rng = np.random.default_rng(21)
    pix = rng.integers(0, 4096, (2, 24, 28)).astype(np.uint16)
    base = JD.TS_JPEG_LL_SV1 if uid == JD.TS_JPEG_LL else JD.TS_JPEG_LS
    src = JW.write_dicom(str(tmp_path / "src.dcm"), pix,
                         transfer_syntax=base)
    if near:                                  # the frames coded at NEAR 2
        frags = []
        for f in pix:
            frag = JS.encode(f, precision=16, near=near)
            frags.append(frag + b"\x00" * (len(frag) % 2))
        src = _with_fragments(src, str(tmp_path / "near.dcm"), frags)
    raw = open(src, "rb").read()
    assert len(uid) == len(base)
    path = str(tmp_path / "f.dcm")
    with open(path, "wb") as fh:
        fh.write(raw.replace(base.encode(), uid.encode()))
    assert PD.read_dataset(path).transfer_syntax == uid
    _assert_reads_equal(path)
    got = PD.decode_pixels(PD.read_dataset(path)).astype(np.int64)
    assert np.abs(got - pix).max() <= near


def _dataset_pair(tmp_path, syntax, pix):
    path = JW.write_dicom(str(tmp_path / "e.dcm"), pix,
                          transfer_syntax=SYNTAXES[syntax])
    return PD.read_dataset(path), JD.read_dataset(path)


def _decode_raises_same(p_ds, j_ds, match):
    with pytest.raises(JD.DicomError) as je:
        JD.decode_pixels(j_ds)
    with pytest.raises(PD.DicomError) as pe:
        PD.decode_pixels(p_ds)
    assert str(pe.value) == str(je.value)
    assert re.search(match, str(pe.value)), str(pe.value)


@pytest.mark.parametrize("syntax", sorted(SYNTAXES))
@pytest.mark.parametrize("defect,match", [
    ("bits8", "out of range for BitsAllocated=8"),
    ("bits32", "at most 16 bits"),
    ("corrupt", "Corrupt JPEG"),
    ("rows", r"frame is \(24, 20, 1\), dataset says \(25, 20, 1\)"),
    ("frames", "groups into 3 codestreams, NumberOfFrames says 2"),
    ("truncated_frame", "Corrupt JPEG")])
def test_decode_errors_same(tmp_path, syntax, defect, match):
    rng = np.random.default_rng(7)
    pix = rng.integers(300, 4096, (3, 24, 20)).astype(np.uint16)
    p_ds, j_ds = _dataset_pair(tmp_path, syntax, pix)
    if syntax == "j2k" and defect == "bits8":   # J2K checks the depth first
        match = "16-bit JPEG 2000 codestream in a 8-bit container"
    for ds in (p_ds, j_ds):
        if defect == "bits8":
            ds.attrs["BitsAllocated"] = 8
        elif defect == "bits32":
            ds.attrs["BitsAllocated"] = 32
        elif defect == "corrupt":
            f = ds.fragments
            ds.fragments = [f[0], f[1][:len(f[1]) // 2] + b"\xff\xd9", f[2]]
        elif defect == "rows":
            ds.attrs["Rows"] = 25
        elif defect == "frames":
            ds.attrs["NumberOfFrames"] = 2
        else:
            ds.fragments = [ds.fragments[0], ds.fragments[1][:30],
                            ds.fragments[2]]
    _decode_raises_same(p_ds, j_ds, match)


@pytest.mark.parametrize("syntax", sorted(SYNTAXES) + ["rle"])
def test_threads_match_serial(tmp_path, monkeypatch, syntax):
    rng = np.random.default_rng(21)
    pix = rng.integers(0, 4096, (6, 24, 24)).astype(np.uint16)
    ts = SYNTAXES.get(syntax, JD.TS_RLE)
    path = PW.write_dicom(str(tmp_path / "mf.dcm"), pix, transfer_syntax=ts)
    seen = []
    real = PD._map_frames
    monkeypatch.setattr(PD, "_map_frames",
                        lambda fn, items: seen.append(len(items))
                        or real(fn, items))
    monkeypatch.setenv("MDX_IO_THREADS", "1")
    serial = PD.decode_pixels(PD.read_dataset(path))
    monkeypatch.setenv("MDX_IO_THREADS", "4")
    threaded = PD.decode_pixels(PD.read_dataset(path))
    assert seen == [6, 6]
    assert np.array_equal(serial, threaded) and np.array_equal(threaded, pix)
    ds = PD.read_dataset(path)
    ds.fragments = list(ds.fragments)
    ds.fragments[2] = ds.fragments[2][:30]
    with pytest.raises(PD.DicomError, match="Corrupt"):
        PD.decode_pixels(ds)


@pytest.mark.parametrize("ts", [JD.TS_J2K, JD.TS_JPEG_LL,
                                JD.TS_JPEG_LS_NEAR])
def test_writer_refuses_what_it_does_not_write(tmp_path, ts):
    pix = np.arange(64, dtype=np.uint16).reshape(8, 8)
    for writer in (PW, JW):               # both refuse, naming the UID
        with pytest.raises(ValueError, match=re.escape(ts)):
            writer.write_dicom(str(tmp_path / "w.dcm"), pix,
                               transfer_syntax=ts)


@pytest.mark.parametrize("syntax", sorted(SYNTAXES))
@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_signed_frames_written_and_read_as_jax(tmp_path, _jax_numpy_rescale,
                                               syntax, dtype):
    info = np.iinfo(dtype)
    pix = np.random.default_rng(9).integers(
        info.min, int(info.max) + 1, (2, 12, 18)).astype(dtype)
    pix[0, 0, :2] = [info.min, info.max]
    a = JW.write_dicom(str(tmp_path / "j.dcm"), pix,
                       transfer_syntax=SYNTAXES[syntax])
    b = PW.write_dicom(str(tmp_path / "p.dcm"), pix,
                       transfer_syntax=SYNTAXES[syntax])
    assert open(a, "rb").read() == open(b, "rb").read()
    _assert_reads_equal(b)
    assert np.array_equal(PD.decode_pixels(PD.read_dataset(b)), pix)


# --------------------------------------------------------------- the CLI --


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    monkeypatch.delenv("MDX_TV_MODE", raising=False)
    return tmp_path / "runs.db"


_RECORD = ("status", "issues", "metrics_before", "metrics_after",
           "validation", "applied_ops", "metadata_summary")


def _runs(since: int = 0) -> list[dict]:
    from mdx_torch.pipeline import storage

    rows = [storage.get_run(r["run_id"])
            for r in storage.list_runs(limit=1000)]
    rows.sort(key=lambda r: (r["created_at"], r["input_filename"]))
    return rows[since:]


def _rows_tree(rows: list[dict]) -> dict:
    mb = {k: np.array([r["metrics_before"][k] for r in rows])
          for k in rows[0]["metrics_before"]}
    tree = {"stats": mb, "validation": {"metrics_before": mb}}
    if rows[0]["metrics_after"]:
        tree["validation"]["metrics_after"] = {
            k: np.array([r["metrics_after"][k] for r in rows])
            for k in rows[0]["metrics_after"]}
    return parity.flatten(tree)


@pytest.mark.parametrize("syntax,flags", [("jpeg_ll", []),
                                          ("jpeg_ls", ["--batch"]),
                                          ("j2k", []), ("j2k", ["--batch"])])
def test_cli_on_compressed_files(tmp_path, db, capsys, _jax_numpy_rescale,
                                 syntax, flags):
    from mdx_torch.io import write_synthetic_dicom

    frames = 3 if "--batch" in flags else 1
    kw = dict(kind="noisy" if frames == 1 else "phantom", size=64,
              frames=frames, seed=4)
    (tmp_path / "comp").mkdir()
    (tmp_path / "le").mkdir()
    comp = write_synthetic_dicom(str(tmp_path / "comp" / "x.dcm"),
                                 transfer_syntax=SYNTAXES[syntax], **kw)
    twin = write_synthetic_dicom(str(tmp_path / "le" / "x.dcm"), **kw)
    out = str(tmp_path / "out")
    argv = lambda f: ["--input", f, "--output", out, "--no-show", *flags]  # noqa: E731
    native.reset_calls()
    assert cli.main(argv(comp), device="cpu") == 0
    text_p = capsys.readouterr().out
    assert native.CALLS[DECODE_CALL[syntax]] >= frames
    assert cli.main(argv(twin), device="cpu") == 0
    text_twin = capsys.readouterr().out
    port, port_twin = _runs()[:frames], _runs(frames)[:frames]
    assert len(port_twin) == frames
    for a, b in zip(port, port_twin):
        for k in _RECORD:
            assert a[k] == b[k], k
    assert text_p.replace(str(tmp_path / "comp"),
                          str(tmp_path / "le")) == text_twin
    assert jax_main.main(argv(comp)) == 0
    text_j = capsys.readouterr().out
    text_j = text_j.replace("one compiled program", "one batched pass")
    assert parity._NUMBER.sub("#", text_p) == parity._NUMBER.sub("#", text_j)
    jax_rows = _runs(2 * frames)
    assert [r["issues"] for r in jax_rows] == [r["issues"] for r in port]
    assert not parity.breaches(_rows_tree(port), _rows_tree(jax_rows),
                               hw=64 * 64)


def test_cli_on_lossy_j2k_fixture(tmp_path, db, capsys, _jax_numpy_rescale):
    """A ``.4.91`` YBR_ICT file of the committed 9/7 fixture: the port's CLI
    exits 0 with JAX's report and records.  On this file no op changes the
    noise: the port's ``noise_change`` is -0.0 and JAX's a float32 residue
    below zero, so the reports print "+-0.0%" and "-0.0%"; the mask takes a
    number's sign prefix with it, and the records hold the numbers."""
    fixture = Path(__file__).resolve().parent / "torch_fixtures" / "j2k"
    stream = (fixture / "rgb_ict_tiled.j2k").read_bytes()
    path = PW.write_codestreams(str(tmp_path / "x.dcm"), [stream], 96, 80,
                                transfer_syntax=JD.TS_J2K, bits=8, samples=3,
                                photometric="YBR_ICT")
    argv = ["--input", path, "--output", str(tmp_path / "out"), "--no-show"]
    native.reset_calls()
    assert cli.main(argv, device="cpu") == 0
    text_p = capsys.readouterr().out
    assert native.CALLS["jpeg2k_t1_block"] > 0
    assert jax_main.main(argv) == 0
    text_j = capsys.readouterr().out
    text_j = text_j.replace("one compiled program", "one batched pass")
    signed = re.compile(r"[+-]*\d+(?:\.\d+)?")
    assert signed.sub("#", text_p) == signed.sub("#", text_j)
    port, jax_rows = _runs()[:1], _runs(1)
    assert [r["issues"] for r in jax_rows] == [r["issues"] for r in port]
    assert not parity.breaches(_rows_tree(port), _rows_tree(jax_rows),
                               hw=96 * 80)
