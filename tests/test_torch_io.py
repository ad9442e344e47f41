"""The port's host I/O (``mdx_torch.io``) against the JAX package's
(``mdx.io``) on the same files and arguments.

* reader: ``load_dicom``, ``load_series``, ``load_frames_raw`` and its
  descriptor bit for bit, on files of every syntax the port reads, 8- and
  16-bit, signed, MONOCHROME1, rescale, window, multi-frame and RGB;
* writer: byte-equal files for the same arguments, JPEG Lossless and
  JPEG-LS included; RLE frames byte-equal and round-tripping; DCT JPEG and
  JPEG 2000 refused with their UID;
* normalisation, the markdown report (string-equal on the same contexts)
  and the PNG (decoded here with ``zlib`` alone).

The JAX package sends a modality rescale to its C++ ``rescale_f32`` where
``native/libmdxio.so`` is built; that loop is compiled into fused
multiply-adds and differs from the numpy body by one ulp for slopes whose
product rounds (ROADMAP Queue 3).  The reader comparisons therefore run
JAX's numpy body (``_jax_numpy_rescale``), and one test bounds the native
difference.
"""

import re
import struct
import zlib

import numpy as np
import pytest

from mdx.io import dicom as JD
from mdx.io import dicom_write as JW
from mdx.io import normalize as JN
from mdx.io import report as JR
from mdx.io import rle as JRLE
from mdx.pipeline import agents as JA
from mdx.pipeline import schemas as JS
from mdx_torch.core import schemas as PS
from mdx_torch.io import dicom as PD
from mdx_torch.io import dicom_write as PW
from mdx_torch.io import normalize as PN
from mdx_torch.io import report as PR
from mdx_torch.io import rle as PRLE
from mdx_torch.io import visuals as PV
from mdx_torch.pipeline import agents as PA

SYNTAXES = {"explicit_le": JD.TS_EXPLICIT_LE, "deflated": JD.TS_DEFLATED_LE,
            "rle": JD.TS_RLE, "jpeg_ll": JD.TS_JPEG_LL_SV1,
            "jpeg_ls": JD.TS_JPEG_LS}


@pytest.fixture
def _jax_numpy_rescale(monkeypatch):
    """Route the JAX reader's rescale to its numpy body."""
    from mdx.io import native

    def refuse(*a, **k):
        raise native.NativeUnavailable("numpy body under test")

    monkeypatch.setattr(native, "rescale_f32", refuse)


def _pixels(case: str, rng) -> tuple[np.ndarray, dict]:
    """(pixels, write_dicom kwargs) of one reader case."""
    if case == "u8":
        return rng.integers(0, 256, (40, 56)).astype(np.uint8), {}
    if case == "u16":
        return rng.integers(0, 65536, (40, 56)).astype(np.uint16), {}
    if case == "signed":
        return (rng.integers(-3000, 3000, (40, 56)).astype(np.int16),
                {"rescale_slope": 1.0, "rescale_intercept": 0.0})
    if case == "mono1":
        return (rng.integers(0, 4096, (40, 56)).astype(np.uint16),
                {"photometric": "MONOCHROME1"})
    if case == "rescale":
        # a CT-like 16-bit file with a slope whose products round
        return (rng.integers(0, 4096, (40, 56)).astype(np.uint16),
                {"rescale_slope": 0.3, "rescale_intercept": -1024.5})
    if case == "window":
        return (rng.integers(0, 4096, (40, 56)).astype(np.uint16),
                {"rescale_slope": 1.0, "rescale_intercept": -1024.0,
                 "window_center": 40.0, "window_width": 400.0})
    if case == "window_mono1":
        return (rng.integers(0, 4096, (40, 56)).astype(np.uint16),
                {"photometric": "MONOCHROME1", "window_center": 2000.0,
                 "window_width": 1500.0})
    if case == "multiframe":
        return (rng.integers(0, 4096, (3, 32, 24)).astype(np.uint16),
                {"rescale_slope": 2.5, "rescale_intercept": -1000.0,
                 "photometric": "MONOCHROME1"})
    raise ValueError(case)


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
        _same(PD.load_dicom(path, window=window),
              JD.load_dicom(path, window=window))
        _same(PD.load_series(path, window=window),
              JD.load_series(path, window=window))
        _same(PD.load_frames_raw(path, window=window),
              JD.load_frames_raw(path, window=window))


@pytest.mark.parametrize("case", ["u8", "u16", "signed", "mono1", "rescale",
                                  "window", "window_mono1", "multiframe"])
@pytest.mark.parametrize("syntax", sorted(SYNTAXES))
def test_reader_matches_jax(tmp_path, _jax_numpy_rescale, syntax, case):
    pix, kw = _pixels(case, np.random.default_rng(len(case)))
    path = str(tmp_path / f"{case}.dcm")
    JW.write_dicom(path, pix, transfer_syntax=SYNTAXES[syntax], **kw)
    _assert_reads_equal(path)


def _el(group, elem, vr, value: bytes, *, explicit=True, big=False):
    if len(value) % 2:
        value += b" " if vr in (b"CS", b"DS", b"IS", b"LO") else b"\x00"
    e = ">" if big else "<"
    if not explicit:
        return struct.pack(e + "HHI", group, elem, len(value)) + value
    if vr in (b"OB", b"OW", b"SQ", b"UN"):
        return struct.pack(e + "HH2sHI", group, elem, vr, 0,
                           len(value)) + value
    return struct.pack(e + "HH2sH", group, elem, vr, len(value)) + value


def _crafted(path, pix: np.ndarray, ts: str | None, *, samples=1,
             planar=None, photometric="MONOCHROME2", rescale=None):
    """A file of a syntax the writers do not produce: implicit LE,
    explicit BE, or (``ts=None``) a headerless implicit-LE dataset."""
    explicit = ts not in (JD.TS_IMPLICIT_LE, None)
    big = ts == JD.TS_EXPLICIT_BE
    e = ">" if big else "<"
    frames = pix.shape[0] if pix.ndim == (4 if samples > 1 else 3) else 1
    rows, cols = pix.shape[-3:-1] if samples > 1 else pix.shape[-2:]
    bits = pix.dtype.itemsize * 8
    el = lambda g, m, vr, v: _el(g, m, vr, v, explicit=explicit, big=big)  # noqa: E731
    body = [el(0x0008, 0x0060, b"CS", b"MR"),
            el(0x0018, 0x0015, b"CS", b"HEAD"),
            el(0x0028, 0x0002, b"US", struct.pack(e + "H", samples)),
            el(0x0028, 0x0004, b"CS", photometric.encode())]
    if planar is not None:
        body.append(el(0x0028, 0x0006, b"US", struct.pack(e + "H", planar)))
    if frames > 1:
        body.append(el(0x0028, 0x0008, b"IS", str(frames).encode()))
    body += [el(0x0028, 0x0010, b"US", struct.pack(e + "H", rows)),
             el(0x0028, 0x0011, b"US", struct.pack(e + "H", cols)),
             el(0x0028, 0x0100, b"US", struct.pack(e + "H", bits)),
             el(0x0028, 0x0101, b"US", struct.pack(e + "H", bits)),
             el(0x0028, 0x0103, b"US", struct.pack(
                 e + "H", 1 if pix.dtype.kind == "i" else 0))]
    if rescale:
        body += [el(0x0028, 0x1052, b"DS", f"{rescale[1]:g}".encode()),
                 el(0x0028, 0x1053, b"DS", f"{rescale[0]:g}".encode())]
    data = pix
    if planar == 1:
        data = np.moveaxis(pix, -1, -3)
    body.append(el(0x7FE0, 0x0010, b"OW" if bits == 16 else b"OB",
                   np.ascontiguousarray(data).astype(
                       data.dtype.newbyteorder(e)).tobytes()))
    body = b"".join(body)
    if ts is None:
        blob = body
    else:
        meta_el = _el(0x0002, 0x0010, b"UI", ts.encode())
        blob = (b"\x00" * 128 + b"DICM"
                + _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_el)))
                + meta_el + body)
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


@pytest.mark.parametrize("kind", ["implicit_le", "explicit_be", "headerless",
                                  "rgb", "rgb_planar_frames", "big_signed"])
def test_reader_matches_jax_crafted(tmp_path, _jax_numpy_rescale, kind):
    rng = np.random.default_rng(7)
    p = tmp_path / f"{kind}.dcm"
    if kind == "implicit_le":
        path = _crafted(p, rng.integers(0, 65536, (2, 24, 40)).astype(
            np.uint16), JD.TS_IMPLICIT_LE, rescale=(0.5, -100.0))
    elif kind == "explicit_be":
        path = _crafted(p, rng.integers(0, 65536, (24, 40)).astype(
            np.uint16), JD.TS_EXPLICIT_BE, photometric="MONOCHROME1")
    elif kind == "headerless":
        path = _crafted(p, rng.integers(0, 256, (24, 40)).astype(np.uint8),
                        None)
    elif kind == "rgb":
        path = _crafted(p, rng.integers(0, 256, (24, 40, 3)).astype(
            np.uint8), JD.TS_EXPLICIT_LE, samples=3, planar=0,
            photometric="RGB")
    elif kind == "rgb_planar_frames":
        path = _crafted(p, rng.integers(0, 256, (2, 24, 40, 3)).astype(
            np.uint8), JD.TS_EXPLICIT_LE, samples=3, planar=1,
            photometric="RGB")
    else:
        path = _crafted(p, rng.integers(-30000, 30000, (24, 40)).astype(
            np.int16), JD.TS_EXPLICIT_BE, rescale=(0.3, -1024.5))
    _assert_reads_equal(path)


def test_native_rescale_is_within_one_ulp_of_the_port():
    """The JAX package's C++ rescale (fused multiply-add: one rounding)
    against the port's numpy body (multiply, then add: two) on a 16-bit
    CT-like frame: equal where slope × value is exact in float32, else
    apart by at most the product's rounding (half an ulp of it) and the
    sum's (an ulp of the result)."""
    from mdx.io import native

    if not native.available():
        pytest.skip("the JAX package's native library is not built here")
    raw = np.random.default_rng(0).integers(0, 4096, (64, 64)).astype(
        np.uint16)
    for slope, icpt in ((1.0, -1024.0), (0.5, -1024.0), (0.3, -1024.5)):
        ds = PD.DicomDataset(attrs={"RescaleSlope": slope,
                                    "RescaleIntercept": icpt})
        port = PD._rescale(raw, ds)
        nat = native.rescale_f32(raw, slope, icpt)
        prod = raw.astype(np.float32) * np.float32(slope)
        diff = np.abs(port.astype(np.float64) - nat)
        if slope in (1.0, 0.5):
            assert not diff.any()
        else:
            bound = np.spacing(np.abs(prod)) / 2 + np.spacing(np.abs(nat))
            assert diff.any() and (diff <= bound).all()


@pytest.mark.parametrize("syntax", sorted(SYNTAXES))
@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16"])
def test_writer_byte_equal_to_jax(tmp_path, syntax, dtype):
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    pix = rng.integers(info.min, info.max, (2, 20, 33)).astype(dtype)
    pix[:, :5] = pix[:, :1]          # runs for PackBits
    kw = dict(modality="US", body_part="ABDOMEN", photometric="MONOCHROME1",
              rescale_slope=0.25, rescale_intercept=-7.5, window_center=12.5,
              window_width=300.0, transfer_syntax=SYNTAXES[syntax])
    for arr in (pix, pix[0]):
        a = JW.write_dicom(str(tmp_path / "j.dcm"), arr, **kw)
        b = PW.write_dicom(str(tmp_path / "p.dcm"), arr, **kw)
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("kind", ["noisy", "low_contrast", "clipped",
                                  "phantom", "clean"])
def test_synthetic_writer_byte_equal_to_jax(tmp_path, kind):
    for ts in SYNTAXES.values():
        a = JW.write_synthetic_dicom(str(tmp_path / "j.dcm"), kind=kind,
                                     size=32, frames=2, seed=5,
                                     transfer_syntax=ts)
        b = PW.write_synthetic_dicom(str(tmp_path / "p.dcm"), kind=kind,
                                     size=32, frames=2, seed=5,
                                     transfer_syntax=ts)
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("ts", [JD.TS_J2K_LOSSLESS, JD.TS_J2K,
                                JD.TS_JPEG_BASELINE])
def test_jpeg_family_is_refused_with_its_uid(tmp_path, ts):
    """The syntaxes the port does not decode yet; JAX's writer writes only
    .4.90 of them, so .4.91 and .4.50 are that file with its UID rewritten
    (all three UIDs are 22 characters)."""
    pix = np.arange(16 * 16, dtype=np.uint16).reshape(16, 16)
    j2k = JW.write_dicom(str(tmp_path / "j.dcm"), pix,
                         transfer_syntax=JD.TS_J2K_LOSSLESS)
    assert JD.load_dicom(j2k)[0].shape == (16, 16)
    path = str(tmp_path / "t.dcm")
    with open(path, "wb") as f:
        f.write(open(j2k, "rb").read().replace(
            JD.TS_J2K_LOSSLESS.encode(), ts.encode()))
    assert JD.read_dataset(path).transfer_syntax == ts
    for load in (PD.load_dicom, PD.load_series, PD.load_frames_raw):
        with pytest.raises(PD.CodecNotPorted,
                           match=re.escape(ts) + r".*not yet in mdx_torch"):
            load(path)
    with pytest.raises(ValueError, match=re.escape(ts)):
        PW.write_dicom(str(tmp_path / "p.dcm"), pix, transfer_syntax=ts)


@pytest.mark.parametrize("shape,dtype", [((17, 23), "uint8"),
                                         ((40, 56), "uint16"),
                                         ((12, 9, 3), "uint8"),
                                         ((31, 30), "int16")])
def test_rle_frames_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(11)
    info = np.iinfo(dtype)
    frame = rng.integers(info.min, info.max, shape).astype(dtype)
    frame[3:9] = frame[3]            # replicate runs
    frame.reshape(-1)[:200] = 0
    frag = PRLE.encode_frame(frame)
    assert frag == JRLE.encode_frame(frame)
    samples = shape[2] if len(shape) == 3 else 1
    out = PRLE.decode_frame(frag, shape[0], shape[1], samples,
                            frame.dtype.itemsize)
    assert np.array_equal(out, JRLE.decode_frame(
        frag, shape[0], shape[1], samples, frame.dtype.itemsize))
    assert np.array_equal(out.view(dtype).reshape(shape), frame)


def test_packbits_equal_to_both_jax_encoders():
    rng = np.random.default_rng(0)
    cases = [b"", b"a", b"aa", b"aaa", b"ab", b"aab", b"abbb", bytes(300),
             bytes(range(256)) * 3, b"ab" * 200 + b"c" * 130]
    cases += [bytes(rng.integers(0, int(rng.integers(1, 5)),
                                 int(rng.integers(0, 700))).astype(np.uint8))
              for _ in range(200)]
    for data in cases:
        enc = PRLE.packbits_encode(data)
        assert enc == JRLE._packbits_encode_py(data)
        assert enc == JRLE.packbits_encode(data)      # native where built
        assert PRLE.packbits_decode(enc, len(data)) == data
    with pytest.raises(PRLE.RleError):
        PRLE.packbits_decode(b"\x05ab", 6)


def test_normalize_equal_to_jax():
    rng = np.random.default_rng(2)
    x = (rng.random((3, 40, 56)) * 4000 - 1000).astype(np.float32)
    x[1] = 7.0
    for a, b in ((PN.normalize_image(x[0]), JN.normalize_image(x[0])),
                 (PN.normalize_image(x[1]), JN.normalize_image(x[1])),
                 (PN.normalize_batch(x), JN.normalize_batch(x)),
                 (PN.window_level(x[0], 40.0, 400.0),
                  JN.window_level(x[0], 40.0, 400.0)),
                 (PN.window_level(x[0], 40.0, 0.5),
                  JN.window_level(x[0], 40.0, 0.5))):
        _same(a, b)
    for arr in (x[0], x, rng.random((5, 6, 3)), rng.random((2, 3, 5, 6))):
        _same(np.asarray(PN.to_grayscale(arr)),
              np.asarray(JN.to_grayscale(arr)))


def _contexts(autotune: bool, no_issues: bool):
    """The same run as a JAX context and a port context."""
    rng = np.random.default_rng(int(autotune) + 2 * int(no_issues))
    from mdx.core.metrics import METRIC_KEYS

    mb = {k: float(np.float32(rng.random() * 10)) for k in METRIC_KEYS}
    ma = {k: float(np.float32(rng.random() * 10)) for k in METRIC_KEYS}
    v = {"ssim": np.float32([0.71234]), "psnr": np.float32([np.inf]),
         "quality_improvement": np.float32([-0.0125]),
         "meets_ssim": np.array([True]), "meets_psnr": np.array([True]),
         "meets_improvement": np.array([False]),
         "passes": np.array([False]), "niqe_before": np.float32([3.25]),
         "niqe_after": np.float32([3.5]),
         "niqe_improved": np.array([False]),
         "contrast_gain": np.float32([0.031]),
         "sharpness_gain": np.float32([-0.5]),
         "noise_change": np.float32([0.75])}
    issues = [] if no_issues else ["noise", "clipping_low"]
    out = []
    for A, S in ((JA, JS), (PA, PS)):
        ctx = {"run_id": "abc", "input_path": "/data/x.dcm",
               "metadata": {"Modality": "CT", "BodyPartExamined": "CHEST",
                            "StudyDescription": "é study"},
               "issues": issues, "recommendations": ["Apply CLAHE."],
               "applied_ops": [] if no_issues else ["CLAHE (clip=0.015)"],
               "metrics_before": mb, "metrics_after": ma,
               "validation": A.build_validation_result(v, issues),
               "visuals": {"before_after": "/out/x_before_after.png"}}
        ctx["notes"] = ctx["validation"].notes
        if autotune:
            plans = [S.EnhancementPlan(
                recommended_ops=["denoise", "clahe"],
                params=S.EnhancementParams(clahe_clip_limit=c, gamma=0.85),
                rationale=f"candidate {i}") for i, c in enumerate(
                    (0.005, 1e-5, 0.03))]
            ctx.update(genai_plan=plans[1], genai_model="on-device autotune",
                       autotune=True, genai_iterations=[
                           S.IterationRecord(iteration=i + 1, plan=p,
                                             score=-1.5 - i,
                                             metrics={"ssim": 0.9,
                                                      "psnr": 30.25,
                                                      "quality_improvement":
                                                      0.1},
                                             chosen=i == 1)
                           for i, p in enumerate(plans)])
        out.append(ctx)
    return out


@pytest.mark.parametrize("autotune", [False, True])
@pytest.mark.parametrize("no_issues", [False, True])
def test_report_string_equal_to_jax(autotune, no_issues):
    jctx, pctx = _contexts(autotune, no_issues)
    assert pctx["validation"].__dict__ == jctx["validation"].__dict__
    assert PR.build_markdown_report(pctx) == JR.build_markdown_report(jctx)
    # each builder on the other's context too
    assert PR.build_markdown_report(jctx) == JR.build_markdown_report(pctx)


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 0)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def test_png_decodes_to_the_expected_rows(tmp_path):
    rng = np.random.default_rng(4)
    before = rng.random((21, 30)).astype(np.float32) * 3 - 1
    after = np.full((21, 30), 0.25, np.float32)
    after[3, 4] = np.nan
    paths = PV.save_visuals(before, after, str(tmp_path), "x")
    assert paths == {"before_after": str(tmp_path / "x_before_after.png")}
    with open(paths["before_after"], "rb") as f:
        got = _decode_png(f.read())
    lo, hi = before.min(), before.max()
    want_left = np.clip(np.rint((before.astype(np.float64) - lo)
                                * (255.0 / (hi - lo))), 0, 255)
    assert got.shape == (21, 30 + 8 + 30)
    assert np.array_equal(got[:, :30], want_left.astype(np.uint8))
    assert (got[:, 30:38] == 255).all()
    assert (got[:, 38:] == 0).all()          # constant panel, NaN pixel
    assert np.array_equal(PV.read_png(paths["before_after"]), got)
    single = PV.save_single_image(before, str(tmp_path / "s" / "one.png"),
                                  title="ignored")
    assert np.array_equal(PV.read_png(single), got[:, :30])


@pytest.mark.parametrize("n", [0, 1, (1 << 20) - 1, 1 << 20,
                               3 * (1 << 20) + 17])
def test_png_deflate_pieces_make_one_zlib_stream(n):
    """The PNG's pieces, deflated apart, decode as one zlib stream."""
    data = np.random.default_rng(n).integers(0, 3, n).astype(np.uint8)
    assert zlib.decompress(PV._deflate(data.tobytes())) == data.tobytes()


def test_large_png_round_trips(tmp_path):
    img = np.random.default_rng(1).random((1100, 1000)).astype(np.float32)
    path = PV.save_single_image(img, str(tmp_path / "big.png"))
    with open(path, "rb") as f:
        assert np.array_equal(_decode_png(f.read()), PV.to_gray8(img))
