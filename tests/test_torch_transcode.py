"""The port's transcoder (``mdx_torch.io.transcode``) and its PackBits loops
(``mdx_torch.io.rle`` through ``mdx_torch.io.native``) against the JAX
package's ``mdx.io.transcode`` and ``mdx.io.rle`` on the same files and bytes.

* every source syntax the reader takes (implicit, explicit LE, deflated,
  RLE, ``.4.57``, ``.4.70``, ``.4.80``, ``.4.81``, ``.4.50``, ``.4.51``,
  ``.4.90``, ``.4.91``) times every target alias: the output file
  byte-equal to JAX's, and its pixels equal to the source's decode;
* private tags and undefined-length sequences survive byte for byte, an
  Implicit source converts (dictionary VRs, UN for the rest, undefined
  length sequences as UN), multi-frame and signed sources;
* colour: YBR_FULL_422 becomes YBR_FULL with PlanarConfiguration 0 (kept or
  inserted), planar RGB comes out interleaved, and the refusals (a colour
  source to a single-component codec, an unmappable photometric);
* the refusals, each with JAX's message: Explicit Big Endian sources,
  lossy and unwritable targets, unknown targets, no pixel data;
* ``python -m mdx_torch.io.transcode`` as a module CLI, its file and its
  printed line equal to JAX's;
* PackBits: the host loops against the Python bodies and JAX's (its C++
  loops and its Python bodies), the no-op control byte, padding, and each
  error.
"""

import importlib
import io
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mdx.io import dicom as JD
from mdx.io import dicom_write as JW
from mdx.io import rle as JR
from mdx_torch.io import dicom as PD
from mdx_torch.io import dicom_write as PW
from mdx_torch.io import jpeg2k, jpegls, native
from mdx_torch.io import rle as PR

# the modules (each package's ``io`` exports the function ``transcode``)
PT = importlib.import_module("mdx_torch.io.transcode")
JT = importlib.import_module("mdx.io.transcode")

ROOT = Path(__file__).resolve().parent.parent
DCT_FIXTURES = ROOT / "tests" / "torch_fixtures" / "jpegdct"


def _img16(seed=0, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    return np.clip(2048 + 500 * rng.normal(0, 1, shape), 0,
                   4095).astype(np.uint16)


def _gray8(seed=1, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    h, w = shape
    base = 128 + 40 * np.sin(np.arange(h * w).reshape(h, w) / 9.0)
    return np.clip(base + rng.normal(0, 8, shape), 0, 255).astype(np.uint8)


def _pil_jpeg(arr, mode, **kw) -> bytes:
    pil = pytest.importorskip("PIL.Image")
    b = io.BytesIO()
    pil.fromarray(arr, mode).save(b, "JPEG", **kw)
    return b.getvalue()


def _rewrite_uid(src: str, dst: str, uid_from: str, uid_to: str) -> str:
    """``src`` with its transfer syntax UID rewritten (22 characters both)."""
    assert len(uid_from) == len(uid_to)
    raw = open(src, "rb").read()
    with open(dst, "wb") as f:
        f.write(raw.replace(uid_from.encode(), uid_to.encode(), 1))
    return dst


def _implicit(elements) -> bytes:
    return b"".join(struct.pack("<HHI", g, e, len(v)) + v
                    for (g, e), v in elements)


def _implicit_source(path: str, img: np.ndarray) -> str:
    """A headerless Implicit-VR dataset with a private tag and an
    undefined-length sequence of one item."""
    rows, cols = img.shape
    inner = _implicit([((0x0008, 0x0060), b"MR")])
    seq = (struct.pack("<HHI", 0x0008, 0x1140, 0xFFFFFFFF)
           + struct.pack("<HHI", 0xFFFE, 0xE000, len(inner)) + inner
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    body = (_implicit([((0x0008, 0x0060), b"CT")]) + seq + _implicit([
        ((0x0009, 0x0011), b"private-imp "),
        ((0x0028, 0x0002), struct.pack("<H", 1)),
        ((0x0028, 0x0010), struct.pack("<H", rows)),
        ((0x0028, 0x0011), struct.pack("<H", cols)),
        ((0x0028, 0x0100), struct.pack("<H", 16)),
        ((0x0028, 0x0101), struct.pack("<H", 16)),
        ((0x0028, 0x0102), struct.pack("<H", 15)),
        ((0x0028, 0x0103), struct.pack("<H", 0)),
        ((0x7FE0, 0x0010), img.tobytes()),
    ]))
    open(path, "wb").write(body)
    return path


def _source(tmp_path, name: str) -> str:
    """One file of each source syntax, written by the port's writer (its
    files are byte-equal to JAX's writer's) or wrapped by
    ``write_codestreams``."""
    img = _img16()
    d = tmp_path / "src"
    d.mkdir(exist_ok=True)
    p = str(d / f"{name}.dcm")
    kw = {"rescale_slope": 1.0, "rescale_intercept": -1024.0}
    writable = {"explicit-le": PD.TS_EXPLICIT_LE, "deflated": PD.TS_DEFLATED_LE,
                "rle": PD.TS_RLE, "4.70": PD.TS_JPEG_LL_SV1,
                "4.80": PD.TS_JPEG_LS, "4.90": PD.TS_J2K_LOSSLESS}
    if name in writable:
        return PW.write_dicom(p, img, transfer_syntax=writable[name], **kw)
    if name == "implicit":
        return _implicit_source(p, img)
    if name == "4.57":
        return _rewrite_uid(_source(tmp_path, "4.70"), p,
                            PD.TS_JPEG_LL_SV1, PD.TS_JPEG_LL)
    if name == "4.81":
        return PW.write_codestreams(p, [jpegls.encode(img, precision=16,
                                                      near=2)], *img.shape,
                                    transfer_syntax=PD.TS_JPEG_LS_NEAR)
    if name == "4.91":
        return PW.write_codestreams(p, [jpeg2k.encode(img)], *img.shape,
                                    transfer_syntax=PD.TS_J2K)
    if name == "4.50":
        g = _gray8()
        return PW.write_codestreams(p, [_pil_jpeg(g, "L", quality=90),
                                        _pil_jpeg(g[::-1], "L", quality=70)],
                                    *g.shape, bits=8,
                                    transfer_syntax=PD.TS_JPEG_BASELINE)
    assert name == "4.51"
    return PW.write_codestreams(
        p, [(DCT_FIXTURES / "ct256_12bit.jpg").read_bytes()], 256, 256,
        transfer_syntax=PD.TS_JPEG_EXTENDED)


SOURCES = ("implicit", "explicit-le", "deflated", "rle", "4.57", "4.70",
           "4.80", "4.81", "4.50", "4.51", "4.90", "4.91")


def _both(src: str, tmp_path, target: str):
    """Transcode ``src`` with both packages: (port bytes, JAX bytes), or the
    two errors as (class name, message)."""
    out = []
    for pkg, name in ((PT, "p.dcm"), (JT, "j.dcm")):
        dst = str(tmp_path / name)
        try:
            assert pkg.transcode(src, dst, target) == dst
            out.append(open(dst, "rb").read())
        except Exception as e:          # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("target", sorted(PT.TARGET_ALIASES))
@pytest.mark.parametrize("src", SOURCES)
def test_every_source_to_every_target_byte_equal(tmp_path, src, target):
    sp = _source(tmp_path, src)
    port, jax = _both(sp, tmp_path, target)
    assert isinstance(port, bytes), port
    assert port == jax
    ds = PD.read_dataset(str(tmp_path / "p.dcm"))
    assert ds.transfer_syntax == PT.TARGET_ALIASES[target]
    want = PD.decode_pixels(PD.read_dataset(sp))
    got = PD.decode_pixels(ds)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if src != "4.50" and src != "4.51":
        assert ds.get("Modality") == "CT"


def test_aliases_and_uids_equal_jax():
    assert PT.TARGET_ALIASES == JT.TARGET_ALIASES
    assert PT._VR_DICT == JT._VR_DICT
    assert PT._LOSSY_TS == JT._LOSSY_TS


def test_multiframe_and_signed(tmp_path):
    rng = np.random.default_rng(1)
    pix = rng.integers(-1000, 3000, (3, 24, 24)).astype(np.int16)
    for ts in (PD.TS_EXPLICIT_LE, PD.TS_RLE):
        sp = PW.write_dicom(str(tmp_path / "s.dcm"), pix, signed=True,
                            transfer_syntax=ts)
        for target in ("jpeg-ls", "j2k", "rle", "deflated"):
            port, jax = _both(sp, tmp_path, target)
            assert isinstance(port, bytes) and port == jax
            np.testing.assert_array_equal(
                PD.decode_pixels(PD.read_dataset(str(tmp_path / "p.dcm"))),
                pix)


def _spliced(tmp_path, extra: bytes) -> str:
    sp = PW.write_dicom(str(tmp_path / "s.dcm"), _img16())
    raw = open(sp, "rb").read()
    i = raw.rfind(struct.pack("<HH", 0x7FE0, 0x0010))
    pp = str(tmp_path / "spliced.dcm")
    open(pp, "wb").write(raw[:i] + extra + raw[i:])
    return pp


def test_private_tag_and_sequence_survive(tmp_path):
    inner = (struct.pack("<HH", 0x0008, 0x0060) + b"CS"
             + struct.pack("<H", 2) + b"MR")
    seq = (struct.pack("<HH", 0x0008, 0x1140) + b"SQ\x00\x00"
           + struct.pack("<I", 0xFFFFFFFF)
           + struct.pack("<HHI", 0xFFFE, 0xE000, len(inner)) + inner
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    priv = (struct.pack("<HH", 0x0009, 0x0010) + b"LO"
            + struct.pack("<H", 6) + b"mdxpr ")
    pp = _spliced(tmp_path, seq + priv)
    for target in ("rle", "jpeg-ls", "explicit-le"):
        port, jax = _both(pp, tmp_path, target)
        assert port == jax and seq in port and priv in port


def test_implicit_source_converts(tmp_path):
    img = _img16(2, (16, 20))
    pp = _implicit_source(str(tmp_path / "imp.dcm"), img)
    port, jax = _both(pp, tmp_path, "jpeg-ll")
    assert port == jax
    assert struct.pack("<HH", 0x0008, 0x0060) + b"CS" in port
    assert struct.pack("<HH", 0x0009, 0x0011) + b"UN" in port
    # the undefined-length sequence became UN of undefined length
    assert (struct.pack("<HH", 0x0008, 0x1140) + b"UN\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF)) in port
    np.testing.assert_array_equal(
        PD.decode_pixels(PD.read_dataset(str(tmp_path / "p.dcm"))), img)


def _part10(body: bytes, ts: str) -> bytes:
    def m(elem, vr, val):
        return PT._explicit_el((0x0002, elem), vr, val)

    def txt(s):
        b = s.encode()
        return b + (b"\x00" if len(b) % 2 else b"")

    els = b"".join([
        m(0x0001, b"OB", b"\x00\x01"),
        m(0x0002, b"UI", txt("1.2.840.10008.5.1.4.1.1.6.1")),
        m(0x0003, b"UI", txt("1.2.3.4.5")),
        m(0x0010, b"UI", txt(ts)),
        m(0x0012, b"UI", txt("1.2.826.0.1.3680043.9.9999")),
    ])
    meta = m(0x0000, b"UL", struct.pack("<I", len(els))) + els
    return b"\x00" * 128 + b"DICM" + meta + body


def _ybr422(tmp_path, with_planar: bool, photometric=b"YBR_FULL_422") -> str:
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
    frag = _pil_jpeg(rgb, "RGB", quality=92, subsampling=1)
    frag += b"\x00" * (len(frag) % 2)
    el = PT._explicit_el
    body = b"".join([
        el((0x0008, 0x0060), b"CS", b"US"),
        el((0x0028, 0x0002), b"US", struct.pack("<H", 3)),
        el((0x0028, 0x0004), b"CS", photometric),
    ] + ([el((0x0028, 0x0006), b"US", struct.pack("<H", 1))]
         if with_planar else []) + [
        el((0x0028, 0x0010), b"US", struct.pack("<H", 32)),
        el((0x0028, 0x0011), b"US", struct.pack("<H", 40)),
        el((0x0028, 0x0100), b"US", struct.pack("<H", 8)),
        el((0x0028, 0x0101), b"US", struct.pack("<H", 8)),
        el((0x0028, 0x0103), b"US", struct.pack("<H", 0)),
    ]) + (struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
          + struct.pack("<HHI", 0xFFFE, 0xE000, 0)
          + struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
          + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    sp = str(tmp_path / "ybr.dcm")
    open(sp, "wb").write(_part10(body, PD.TS_JPEG_BASELINE))
    return sp


@pytest.mark.parametrize("target", sorted(PT.TARGET_ALIASES))
@pytest.mark.parametrize("with_planar", [True, False])
def test_ybr422_becomes_conformant(tmp_path, with_planar, target):
    sp = _ybr422(tmp_path, with_planar)
    port, jax = _both(sp, tmp_path, target)
    assert port == jax
    if target not in ("explicit-le", "deflated"):
        assert port == ("DicomError", "Color pixel data transcodes to "
                        "Explicit LE only (the lossless codecs here are "
                        "single-component).")
        return
    ds = PD.read_dataset(str(tmp_path / "p.dcm"))
    assert ds.get("PhotometricInterpretation") == "YBR_FULL"
    assert ds.get("PlanarConfiguration") == 0
    want = PD.decode_pixels(PD.read_dataset(sp))
    assert want.shape == (32, 40, 3)
    np.testing.assert_array_equal(PD.decode_pixels(ds), want)


def test_unmappable_colour_photometric_refused_alike(tmp_path):
    sp = _ybr422(tmp_path, False, b"YBR_PARTIAL_")
    port, jax = _both(sp, tmp_path, "explicit-le")
    assert port == jax and "conformantly" in port[1]


def test_planar_rgb_comes_out_interleaved(tmp_path):
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    el = PT._explicit_el
    body = b"".join([
        el((0x0028, 0x0002), b"US", struct.pack("<H", 3)),
        el((0x0028, 0x0004), b"CS", b"RGB "),
        el((0x0028, 0x0006), b"US", struct.pack("<H", 1)),
        el((0x0028, 0x0010), b"US", struct.pack("<H", 6)),
        el((0x0028, 0x0011), b"US", struct.pack("<H", 5)),
        el((0x0028, 0x0100), b"US", struct.pack("<H", 8)),
        el((0x0028, 0x0103), b"US", struct.pack("<H", 0)),
        el((0x7FE0, 0x0010), b"OB",
           np.ascontiguousarray(rgb.transpose(2, 0, 1)).tobytes()),
    ])
    sp = str(tmp_path / "planar.dcm")
    open(sp, "wb").write(_part10(body, PD.TS_EXPLICIT_LE))
    port, jax = _both(sp, tmp_path, "deflated")
    assert port == jax
    ds = PD.read_dataset(str(tmp_path / "p.dcm"))
    assert ds.get("PlanarConfiguration") == 0
    np.testing.assert_array_equal(PD.decode_pixels(ds), rgb)


@pytest.mark.parametrize("target", [
    PD.TS_JPEG_BASELINE, PD.TS_JPEG_EXTENDED, PD.TS_JPEG_LS_NEAR,
    PD.TS_JPEG_LL, PD.TS_J2K, "1.2.3.4", "jpeg", PD.TS_EXPLICIT_BE])
def test_targets_refused_alike(tmp_path, target):
    sp = PW.write_dicom(str(tmp_path / "s.dcm"), _img16())
    port, jax = _both(sp, tmp_path, target)
    assert port == jax and port[0] == "DicomError"
    assert ("lossy" in port[1]) == (target in (
        PD.TS_JPEG_BASELINE, PD.TS_JPEG_EXTENDED, PD.TS_JPEG_LS_NEAR,
        PD.TS_JPEG_LL, PD.TS_J2K))


@pytest.mark.parametrize("case", ["big_endian", "no_pixels",
                                  "no_pixel_element", "missing"])
def test_sources_refused_alike(tmp_path, case):
    if case == "big_endian":
        sp = _rewrite_uid(PW.write_dicom(str(tmp_path / "s.dcm"), _img16()),
                          str(tmp_path / "be.dcm"), PD.TS_EXPLICIT_LE,
                          PD.TS_EXPLICIT_BE)
    elif case == "no_pixels":
        sp = str(tmp_path / "np.dcm")
        open(sp, "wb").write(_implicit([((0x0008, 0x0060), b"CT")]))
    elif case == "no_pixel_element":
        # pixels the reader finds, but not as a top-level (7FE0,0010)
        sp = str(tmp_path / "npe.dcm")
        open(sp, "wb").write(_part10(PT._explicit_el(
            (0x0008, 0x0060), b"CS", b"CT"), PD.TS_EXPLICIT_LE))
    else:
        sp = str(tmp_path / "nope.dcm")
    port, jax = _both(sp, tmp_path, "rle")
    assert port == jax
    assert port[0] == ("FileNotFoundError" if case == "missing"
                       else "DicomError"), port


def test_module_cli(tmp_path):
    sp = PW.write_dicom(str(tmp_path / "s.dcm"), _img16(),
                        transfer_syntax=PD.TS_RLE)
    runs = []
    for mod, name in (("mdx_torch.io.transcode", "p.dcm"),
                      ("mdx.io.transcode", "j.dcm")):
        dp = str(tmp_path / name)
        r = subprocess.run([sys.executable, "-m", mod, sp, dp, "--to",
                            "jpeg-ls"], capture_output=True, text=True,
                           timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stderr
        runs.append((r.stdout.replace(dp, "DST"), open(dp, "rb").read()))
    assert runs[0] == runs[1]
    assert runs[0][0] == f"{sp} -> DST [{PD.TS_JPEG_LS}]\n"
    np.testing.assert_array_equal(
        PD.decode_pixels(PD.read_dataset(str(tmp_path / "p.dcm"))), _img16())
    bad = subprocess.run([sys.executable, "-m", "mdx_torch.io.transcode", sp,
                          str(tmp_path / "x.dcm"), "--to", "jpeg"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert bad.returncode == 2 and "invalid choice" in bad.stderr


def test_exported_from_io():
    from mdx_torch import io as pio

    assert pio.transcode is PT.transcode
    assert "transcode" in pio.__all__


# ------------------------------------------------------------------ PackBits --

def _packbits_cases():
    rng = np.random.default_rng(11)
    runs = bytes(np.repeat(rng.integers(0, 256, 60).astype(np.uint8),
                           rng.integers(1, 300, 60)))
    return {
        "empty": b"",
        "one": b"\x07",
        "two": b"\x07\x07",
        "three": b"\x07\x07\x07",
        "random": rng.integers(0, 256, 1000).astype(np.uint8).tobytes(),
        "runs": runs,
        "literal_129": bytes(range(129)),
        "run_129": b"\x05" * 129,
        "run_300": b"\x00" * 300,
        "mixed": b"ab" * 70 + b"c" * 5 + b"de" + b"f" * 130,
        "low_entropy": rng.integers(0, 3, 5000).astype(np.uint8).tobytes(),
    }


@pytest.mark.parametrize("case", sorted(_packbits_cases()))
def test_packbits_host_python_and_jax_equal(case):
    data = _packbits_cases()[case]
    native.reset_calls()
    enc = PR.packbits_encode(data)
    assert native.CALLS["packbits_encode"] == 1
    assert enc == PR._packbits_encode_py(data)
    assert enc == JR.packbits_encode(data) == JR._packbits_encode_py(data)
    padded = enc + b"\x00" * (len(enc) % 2)     # even-length segment
    dec = PR.packbits_decode(padded, len(data))
    assert native.CALLS["packbits_decode"] == 1
    assert dec == data == PR._packbits_decode_py(padded, len(data))
    assert dec == JR.packbits_decode(padded, len(data))


def _pb_outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 - compared below
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("stream,expected", [
    (b"\x80\x02abc\x80", 3),              # no-op control bytes
    (b"\x80\x80\xfd\x09", 4),             # no-ops, then a run of 4
    (b"\x02abc\x00\x00", 3),              # trailing pad ignored
    (b"\x02abcdef", 2),                   # output stops at expected
    (b"\xfdz", 2),                        # a run cut to expected
    (b"\x05abc", 6),                      # truncated literal
    (b"\x00a\xfd", 4),                    # truncated replicate
    (b"\x01ab", 5),                       # too short
    (b"", 0),
    (b"", 1),
])
def test_packbits_decode_edges_alike(monkeypatch, stream, expected):
    host = _pb_outcome(lambda: PR.packbits_decode(stream, expected))
    assert host == _pb_outcome(lambda: JR.packbits_decode(stream, expected))
    assert host == _pb_outcome(
        lambda: JR._packbits_decode_py(stream, expected))
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    native.reset_calls()
    assert host == _pb_outcome(lambda: PR.packbits_decode(stream, expected))
    assert native.CALLS["packbits_decode"] == 0


def test_rle_frames_through_both_paths_equal_jax(monkeypatch):
    rng = np.random.default_rng(12)
    frame = rng.integers(0, 4096, (40, 56)).astype(np.uint16)
    frame[5:20] = frame[5]
    host = PR.encode_frame(frame)
    assert host == JR.encode_frame(frame)
    back = PR.decode_frame(host, 40, 56, 1, 2)
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    native.reset_calls()
    assert PR.encode_frame(frame) == host
    np.testing.assert_array_equal(PR.decode_frame(host, 40, 56, 1, 2), back)
    assert set(native.CALLS.values()) == {0}
    np.testing.assert_array_equal(back.reshape(40, 56), frame)


def test_jax_writer_files_unchanged_by_the_host_loops(tmp_path):
    """An RLE file the port writes through its host loops is the file JAX
    writes."""
    pix = _img16(4, (3, 32, 24))
    a = PW.write_dicom(str(tmp_path / "p.dcm"), pix, transfer_syntax=PD.TS_RLE)
    b = JW.write_dicom(str(tmp_path / "j.dcm"), pix, transfer_syntax=JD.TS_RLE)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert os.path.getsize(a) > 64
