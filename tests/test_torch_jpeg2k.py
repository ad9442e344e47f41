"""The port's JPEG 2000 codec (``mdx_torch.io.jpeg2k``) and its host Tier-1
loops (``mdx_torch.io.native``) against the JAX package's ``mdx.io.jpeg2k``
(with ``native/libmdxio.so`` as its own tests build it) on the same streams.

Pillow's OpenJPEG binding makes the streams, as in
``tests/test_dicom_jpeg2k.py``; every image is made from a seed with numpy.

* decode: the port's pixels, precision and signedness equal to JAX's, bit
  for bit, over shapes, decomposition levels 1-6, code-block sizes, the five
  progression orders, quality layers, precincts, tiles, precincts with RPCL
  and tiles, the JP2 wrapper, 16-bit, signed, RGB RCT, 9/7 gray, 9/7 at a
  lossy rate, RGB ICT, rate-truncated reversible streams (also equal to
  OpenJPEG's decode) and a crafted segmentation-symbol stream; reversible
  streams also equal their source;
* encode: codestreams byte-equal to JAX's, each decoded back by both
  decoders and by OpenJPEG; a seeded image fuzz; the MQ coder's bytes;
* errors: the same class name and message for malformed, truncated and
  unsupported streams, and for random corruption;
* the host loops against the port's Python bodies (``MDX_NO_NATIVE=1``) at
  96 x 80: whole decodes, encoder block bytes, whole encodes, the
  segmentation-symbol error; the wrappers' input checks and ``CALLS``;
* the committed ``.4.91`` fixtures (``tests/torch_fixtures/j2k/``, made by
  :func:`make_fixtures`, which the card's machine cannot run: it has no
  Pillow): equal in both packages and within a stated bound of the pixels
  they were made from;
* DICOM files of Pillow streams: multi-frame, ``.4.91``, YBR_RCT and
  YBR_ICT colour reduced to luma, signedness and depth mismatches, a
  corrupt stream, JP2-wrapped frames in several fragments, and the grouping
  that splits a frame at a fragment starting FF 4F, each as JAX does it.

The port's codec and the JAX package's run the same NumPy float64 9/7
lifting, so irreversible decodes are held bit-equal too; no tolerance is
needed anywhere between the two packages.
"""

import io
import re
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest

from mdx.io import dicom as JD
from mdx.io import jpeg2k as J
from mdx.io import native as jax_native
from mdx_torch.io import dicom as PD
from mdx_torch.io import dicom_write as PW
from mdx_torch.io import jpeg2k as P
from mdx_torch.io import native

PIL = pytest.importorskip("PIL.Image")
from PIL import features as _pil_features  # noqa: E402

if not _pil_features.check("jpg_2000"):   # pragma: no cover
    pytest.skip("Pillow lacks OpenJPEG", allow_module_level=True)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "j2k"


def _enc(img: np.ndarray, mode: str = "L", **kw) -> bytes:
    b = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        PIL.fromarray(img, mode).save(b, "JPEG2000", **kw)
    return b.getvalue()


def _pil_dec(stream: bytes) -> np.ndarray:
    return np.asarray(PIL.open(io.BytesIO(stream)))


def _gray8(seed=0, shape=(70, 54)):
    rng = np.random.default_rng(seed)
    h, w = shape
    base = 128 + 60 * np.sin(np.arange(h * w).reshape(h, w) / 11.0)
    return np.clip(base + rng.normal(0, 20, shape), 0,
                   255).astype(np.uint8)


def _rgb(seed, shape=(70, 54)):
    g = _gray8(seed=seed, shape=shape)
    return np.stack([g, np.roll(g, 3, 1), 255 - g], -1)


def _gray16(seed, shape=(48, 40)):
    rng = np.random.default_rng(seed)
    h, w = shape
    return np.clip(2048 + 800 * np.sin(np.arange(h * w).reshape(h, w) / 7.0)
                   + rng.normal(0, 100, shape), 0, 4095).astype(np.uint16)


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_decode(stream: bytes) -> np.ndarray:
    """Decode in both packages: pixels, precision and signedness equal."""
    ja, jp, js = J.decode(stream)
    pa, pp, ps = P.decode(stream)
    _same_array(pa, ja)
    assert (pp, ps) == (jp, js)
    return pa


# ------------------------------------------------------------------ decode --

# (source, Pillow keywords); every one of them reversible, so the decode
# also equals its source
_LOSSLESS = {
    **{f"shape{h}x{w}": ((h, w), {}) for h, w in
       [(16, 16), (64, 80), (70, 54), (33, 47), (128, 96)]},
    **{f"levels{n}": ((70, 54), {"num_resolutions": n}) for n in
       (1, 2, 3, 6)},
    **{f"cb{a}x{b}": ((70, 54), {"codeblock_size": (a, b)}) for a, b in
       [(32, 32), (64, 16), (16, 64)]},
    **{f"prog_{p}": ((70, 54), {"progression": p}) for p in
       ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "layers": ((70, 54), {"quality_mode": "rates",
                          "quality_layers": [20, 5, 1]}),
    **{f"precinct{n}": ((70, 54), {"precinct_size": (n, n)}) for n in
       (128, 64)},
    **{f"tile{a}x{b}": ((70, 54), {"tile_size": (a, b)}) for a, b in
       [(32, 32), (16, 48), (64, 64)]},
    "rpcl_precincts_tiles": ((96, 80), {"precinct_size": (64, 64),
                                        "progression": "RPCL",
                                        "tile_size": (64, 64)}),
}


@pytest.mark.parametrize("case", sorted(_LOSSLESS))
def test_lossless_decode_equals_jax(case):
    shape, kw = _LOSSLESS[case]
    a = _gray8(seed=len(case), shape=shape)
    got = _same_decode(_enc(a, no_jp2=True, **kw))
    _same_array(got, a)


def test_jp2_wrapper_16bit_and_rct():
    a = _gray8(seed=10)
    _same_array(_same_decode(_enc(a)), a)                   # JP2 boxes
    a16 = _gray16(11)
    s = _enc(a16, "I;16", no_jp2=True)
    _same_array(_same_decode(s), a16)
    assert P.decode(s)[1:] == (16, False)
    rgb = _rgb(12)
    _same_array(_same_decode(_enc(rgb, "RGB", no_jp2=True)), rgb)


def test_signed_siz_flag():
    """SIZ's sign bit set: signed, no DC shift, int16 out."""
    a = _gray8(seed=30, shape=(40, 40))
    s = bytearray(_enc(a, no_jp2=True))
    ssiz = s.find(b"\xff\x51") + 4 + 36
    assert s[ssiz] == 7
    s[ssiz] = 0x87
    got = _same_decode(bytes(s))
    assert P.decode(bytes(s))[1:] == (8, True)
    _same_array(got, a.astype(np.int16) - 128)


@pytest.mark.parametrize("kind", ["gray97", "gray97_rate10", "rgb_ict"])
def test_irreversible_decode_equals_jax(kind):
    a = _rgb(22) if kind == "rgb_ict" else _gray8(seed=len(kind))
    kw = {"quality_mode": "rates", "quality_layers": [10]} \
        if kind == "gray97_rate10" else {}
    s = _enc(a, "RGB" if a.ndim == 3 else "L", no_jp2=True,
             irreversible=True, **kw)
    got = _same_decode(s)
    # OpenJPEG's float filter is another implementation: within 2
    assert np.abs(got.astype(int) - _pil_dec(s).astype(int)).max() <= 2


@pytest.mark.parametrize("rate", [20, 8, 3])
def test_truncated_reversible_streams(rate):
    """Rate-limited reversible streams stop mid-bitplane; both packages
    reconstruct them as OpenJPEG does, bit for bit."""
    a = _gray8(seed=13, shape=(96, 96))
    s = _enc(a, no_jp2=True, quality_mode="rates", quality_layers=[rate])
    _same_array(_same_decode(s), _pil_dec(s))


def _segsym_stream() -> bytes:
    """COD claims segmentation symbols the encoder never wrote."""
    s = bytearray(_enc(_gray8(seed=5, shape=(32, 32)), no_jp2=True))
    s[s.find(b"\xff\x52") + 4 + 8] |= 0x20
    return bytes(s)


def _raises_same(jax_fn, port_fn, match=None):
    with pytest.raises(Exception) as je:
        jax_fn()
    with pytest.raises(Exception) as pe:
        port_fn()
    j, p = je.value, pe.value
    assert (type(p).__name__, str(p)) == (type(j).__name__, str(j))
    if isinstance(j, J.Jpeg2kError):
        assert isinstance(p, P.Jpeg2kError)
    if isinstance(j, JD.DicomError):
        assert isinstance(p, PD.DicomError)
    if match:
        assert re.search(match, str(p)), str(p)


def test_segsym_mismatch_raises_alike():
    s = _segsym_stream()
    _raises_same(lambda: J.decode(s), lambda: P.decode(s), "Segmentation")


# ------------------------------------------------------------------ encode --


def _encode_case(case: str):
    rng = np.random.default_rng(len(case))
    if case == "noise8":
        return rng.integers(0, 256, (48, 40)).astype(np.uint8), {}
    if case == "noise16":
        return rng.integers(0, 65536, (48, 40)).astype(np.uint16), {}
    if case == "smooth":
        return _gray16(3, (64, 72)), {}
    if case == "signed":
        return rng.integers(-2048, 2048, (40, 56)).astype(np.int16), \
            {"signed": True}
    if case == "signed8":
        return rng.integers(-128, 128, (20, 24)).astype(np.int8), \
            {"signed": True}
    if case == "tiny":
        return rng.integers(0, 255, (5, 3)).astype(np.uint8), {}
    if case == "odd":
        return rng.integers(0, 255, (33, 47)).astype(np.uint8), {}
    if case == "flat":
        return np.full((64, 64), 200, np.uint8), {}
    if case == "zeros":
        return np.zeros((20, 28), np.uint8), {}
    if case == "cb4":
        return rng.integers(0, 255, (70, 54)).astype(np.uint8), {"cb": 4}
    if case == "levels0":
        return _gray8(seed=2), {"levels": 0}
    return _gray8(seed=3), {"levels": 8}                     # "levels8"


@pytest.mark.parametrize("case", ["noise8", "noise16", "smooth", "signed",
                                  "signed8", "tiny", "odd", "flat", "zeros",
                                  "cb4", "levels0", "levels8"])
def test_encode_byte_equal_and_round_trips(case):
    img, kw = _encode_case(case)
    s = J.encode(img, **kw)
    assert P.encode(img, **kw) == s
    got = _same_decode(s)
    assert np.array_equal(got.astype(np.int64), img.astype(np.int64))
    assert P.decode(s)[2] == bool(kw.get("signed"))
    if not kw.get("signed"):                  # an independent decoder
        assert np.array_equal(_pil_dec(s).astype(np.int64),
                              img.astype(np.int64))


def test_encode_fuzz():
    rng = np.random.default_rng(5)
    for _ in range(12):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 80))
        hi = 256 if rng.random() < 0.5 else 65536
        img = rng.integers(0, hi, (h, w)).astype(
            np.uint8 if hi == 256 else np.uint16)
        lv = int(rng.integers(0, 6))
        s = P.encode(img, levels=lv)
        assert s == J.encode(img, levels=lv), (h, w, hi, lv)
        _same_array(_same_decode(s), img)


def test_mq_coder_bytes_equal_and_round_trip():
    rng = np.random.default_rng(0)
    for _ in range(60):
        n = int(rng.integers(1, 400))
        ctxs = rng.integers(0, 19, n)
        bits = (rng.random(n) < rng.random()).astype(int)
        out = []
        for M in (J, P):
            enc, cx = M._MQEncoder(), M._fresh_contexts()
            for c, b in zip(ctxs, bits):
                enc.encode(cx[int(c)], int(b))
            out.append(enc.flush())
        assert out[0] == out[1]
        dec, cx = P._MQDecoder(out[1]), P._fresh_contexts()
        assert [dec.decode(cx[int(c)]) for c in ctxs] == list(bits)


@pytest.mark.parametrize("img", [np.zeros((4, 4, 2), np.uint8),
                                 np.zeros((0, 4), np.uint8)])
def test_bad_encode_input_raises_alike(img):
    _raises_same(lambda: J.encode(img), lambda: P.encode(img))


# ------------------------------------------------------------------ errors --


def _with_segment(stream: bytes, marker: int, body: bytes) -> bytes:
    i = stream.find(b"\xff\x5c")                  # before QCD
    return stream[:i] + struct.pack(">HH", marker, 2 + len(body)) + body \
        + stream[i:]


def _in_tile_header(stream: bytes, marker: int, body: bytes) -> bytes:
    """A marker segment after the first SOT, its Psot grown to hold it."""
    i = stream.find(b"\xff\x90")
    seg = struct.pack(">HH", marker, 2 + len(body)) + body
    psot = struct.unpack(">I", stream[i + 6:i + 10])[0]
    return stream[:i + 6] + struct.pack(">I", psot + len(seg)) \
        + stream[i + 10:i + 12] + seg + stream[i + 12:]


def _error_cases() -> dict:
    s = _enc(_gray8(seed=41), no_jp2=True)
    sub = bytearray(s)
    sub[sub.find(b"\xff\x51") + 4 + 37] = 2          # XRsiz = 2
    sig = bytes.fromhex("0000000c6a5020200d0a870a")
    return {
        "not_a_codestream": b"\x00" * 64,
        "four_bytes": b"\xff\x4f",
        "truncated": s[:len(s) // 3],
        "empty_jp2": sig + struct.pack(">I", 16) + b"ftypdata0000",
        "rgn": _with_segment(s, 0xFF5E, b"\x00\x00"),
        "poc": _with_segment(s, 0xFF5F, b"\x00\x00"),
        "ppm": _with_segment(s, 0xFF60, b"\x00\x00"),
        "ppt": _in_tile_header(s, 0xFF61, b"\x00\x00"),
        "tile_cod": _in_tile_header(s, 0xFF52, b"\x00" * 10),
        "tile_poc": _in_tile_header(s, 0xFF5F, b"\x00\x00"),
        "subsampled": bytes(sub),
        "truncated_coc": _with_segment(s, 0xFF53, b"\x00\x00\x00"),
        "truncated_qcc": _with_segment(s, 0xFF5D, b"\x00\x00\x00"),
    }


@pytest.mark.parametrize("case", sorted(_error_cases()))
def test_errors_same(case):
    s = _error_cases()[case]
    _raises_same(lambda: J.decode(s), lambda: P.decode(s))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 - compared below
        return (type(e).__name__, str(e))


def _same_outcome(a, b):
    assert a[0] == b[0], (a[0], b[0], a[1] if a[0] != "ok" else "",
                          b[1] if b[0] != "ok" else "")
    if a[0] == "ok":
        for x, y in zip(a[1][1:], b[1][1:]):
            assert x == y
        _same_array(a[1][0], b[1][0])
    else:
        assert a == b


def test_corrupted_streams_fail_alike():
    """Random byte corruption: the same pixels or the same error, never an
    error of another class."""
    rng = np.random.default_rng(1)
    a = ((np.arange(48 * 40) * 37) % 251).astype(np.uint8).reshape(48, 40)
    streams = [_enc(a, no_jp2=True),
               _enc(a, no_jp2=True, tile_size=(16, 16),
                    quality_mode="rates", quality_layers=[8, 2])]
    kinds = set()
    for trial in range(120):
        t = bytearray(streams[trial % 2])
        for _ in range(rng.integers(1, 5)):
            t[rng.integers(0, len(t))] = rng.integers(0, 256)
        t = bytes(t)
        j, p = _outcome(lambda: J.decode(t)), _outcome(lambda: P.decode(t))
        _same_outcome(j, p)
        assert p[0] in ("ok", "Jpeg2kError"), p
        kinds.add(p[0])
    assert kinds == {"ok", "Jpeg2kError"}


# -------------------------------------------- host loops vs Python bodies --


def _parity_stream(kind: str) -> bytes:
    g = _gray8(seed=len(kind), shape=(96, 80))
    if kind == "plain":
        return _enc(g, no_jp2=True)
    if kind == "lossy97":
        return _enc(g, no_jp2=True, irreversible=True,
                    quality_mode="rates", quality_layers=[8])
    if kind == "layers":
        return _enc(g, no_jp2=True, quality_mode="rates",
                    quality_layers=[20, 5, 1])
    if kind == "truncated":
        return _enc(g, no_jp2=True, quality_mode="rates",
                    quality_layers=[4])
    if kind == "tiles":
        return _enc(g, no_jp2=True, tile_size=(32, 32))
    if kind == "rgb":
        return _enc(_rgb(7, (96, 80)), "RGB", no_jp2=True)
    return _enc(g.astype(np.uint16) * 16, "I;16", no_jp2=True)   # "bit16"


@pytest.mark.parametrize("kind", ["plain", "lossy97", "layers", "truncated",
                                  "tiles", "rgb", "bit16"])
def test_host_decode_equals_python(monkeypatch, kind):
    s = _parity_stream(kind)
    native.reset_calls()
    host = P.decode(s)
    assert native.CALLS["jpeg2k_t1_block"] > 0
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    native.reset_calls()
    py = P.decode(s)
    assert set(native.CALLS.values()) == {0}
    _same_array(host[0], py[0])
    assert host[1:] == py[1:]
    _same_array(host[0], J.decode(s)[0])


def _block(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "noise8":
        v = rng.integers(-255, 256, (64, 64))
    elif case == "noise16":
        v = rng.integers(-65535, 65536, (64, 64))
    elif case == "smooth":
        v = (20 * np.sin(np.arange(64 * 64).reshape(64, 64) / 97.0)
             ).astype(int)
    elif case == "sparse":
        v = np.zeros((64, 64), int)
        idx = rng.integers(0, 64, (2, 30))
        v[idx[0], idx[1]] = rng.integers(-1000, 1000, 30)
    elif case == "allzero":
        v = np.zeros((32, 32), int)
    else:                                                  # "thin"
        v = rng.integers(-100, 100, (64, 3))
    return v.astype(np.int64)


@pytest.mark.parametrize("case", ["noise8", "noise16", "smooth", "sparse",
                                  "allzero", "thin"])
def test_host_block_encode_equals_python(case):
    v = _block(case)
    for btype in (0, 1, 2, 3):
        py = P._t1_encode_block(v, btype)
        assert native.jpeg2k_t1_encode(v, btype) == py, btype
        assert jax_native.jpeg2k_t1_encode(v, btype) == py, btype


def test_host_encode_and_segsym_equal_python(monkeypatch):
    img = _gray8(seed=88, shape=(70, 54))
    host = P.encode(img)
    seg = _segsym_stream()
    host_err = _outcome(lambda: P.decode(seg))
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    native.reset_calls()
    assert P.encode(img) == host
    assert _outcome(lambda: P.decode(seg)) == host_err
    assert host_err[0] == "Jpeg2kError" and "Segmentation" in host_err[1]
    assert set(native.CALLS.values()) == {0}


def test_host_fuzz_equals_python(monkeypatch):
    """Seeded corruption of a 48 x 40 stream: host loops and Python bodies
    give the same pixels or the same error."""
    rng = np.random.default_rng(3)
    s = _enc(_gray8(seed=4, shape=(48, 40)), no_jp2=True, tile_size=(24, 24))
    cases = []
    for _ in range(16):
        t = bytearray(s)
        for _ in range(rng.integers(1, 4)):
            t[rng.integers(len(s) // 4, len(t))] = rng.integers(0, 256)
        cases.append(bytes(t))
    host = [_outcome(lambda: P.decode(t)) for t in cases]
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    for t, h in zip(cases, host):
        _same_outcome(h, _outcome(lambda: P.decode(t)))


def test_host_wrappers_check_their_inputs():
    native.reset_calls()
    with pytest.raises(ValueError, match="axes"):
        native.jpeg2k_t1_encode(np.zeros((4, 4, 2), np.int64), 0)
    with pytest.raises(ValueError, match="band type 4"):
        native.jpeg2k_t1_encode(np.zeros((4, 4), np.int64), 4)
    with pytest.raises(ValueError, match="0 x 4"):
        native.jpeg2k_t1_encode(np.zeros((0, 4), np.int64), 0)
    with pytest.raises(ValueError, match="31 bits"):
        native.jpeg2k_t1_encode(np.full((4, 4), 1 << 30, np.int64), 0)
    with pytest.raises(ValueError, match="3 x 0"):
        native.jpeg2k_t1_block([(b"\x00", 1)], 0, 9, 0, 1, 0, 3, 0)
    assert set(native.CALLS.values()) == {0}
    # a block with no coding pass is zeros without a call, as in JAX
    _same_array(native.jpeg2k_t1_block([(b"\x00", 1)], 0, 9, 9, 1, 5, 3, 0),
                np.zeros((3, 5), np.int32))
    assert set(native.CALLS.values()) == {0}


def test_calls_count_both_entry_points():
    img = _gray8(seed=1, shape=(70, 54))
    native.reset_calls()
    s = P.encode(img, levels=1, cb=5)     # 4 bands of 35 x 27: 2 x 1 blocks
    assert native.CALLS["jpeg2k_t1_encode"] == 8
    assert native.CALLS["jpeg2k_t1_block"] == 0
    P.decode(s)
    assert native.CALLS["jpeg2k_t1_block"] == 8


# ------------------------------------------------------- .4.91 fixtures --


def _ct_slice(seed=0, n=512) -> np.ndarray:
    """A 12-bit CT-like slice: body, an organ, a bone, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / n - 0.5
    r = np.hypot(x, y * 1.2)
    img = np.where(r < 0.42, 1040.0, 24.0)
    img += np.where(np.hypot(x - 0.12, y) < 0.08, 300.0, 0.0)
    img += np.where(np.hypot(x + 0.15, y + 0.1) < 0.05, 1800.0, 0.0)
    img += np.where((r > 0.40) & (r < 0.42), 1500.0, 0.0)
    img += rng.normal(0, 12, (n, n))
    return np.clip(img, 0, 4095).astype(np.uint16)


# name → (source pixels, Pillow keywords, max |error|, RMS error bound)
FIXTURE_SPECS = {
    "ct512_97.j2k": (
        lambda: _ct_slice(), dict(mode="I;16", irreversible=True,
                                  quality_mode="rates",
                                  quality_layers=[20]), 64, 12.0),
    "rgb_ict_tiled.j2k": (
        lambda: _rgb(5, (96, 80)),
        dict(mode="RGB", irreversible=True, tile_size=(48, 48),
             quality_mode="rates", quality_layers=[20, 5],
             progression="RPCL"), 80, 16.0),
}


def make_fixtures(out_dir) -> dict:
    """Write the ``.4.91`` fixtures: irreversible 9/7 codestreams that
    Pillow's OpenJPEG makes from seeded pixels (no encoder of either
    package writes 9/7).  ``python -c "from tests.test_torch_jpeg2k import
    make_fixtures; make_fixtures('tests/torch_fixtures/j2k')"`` from the
    repo root remakes them."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    made = {}
    for name, (source, kw, _, _) in FIXTURE_SPECS.items():
        kw = dict(kw)
        made[name] = _enc(source(), kw.pop("mode"), no_jp2=True, **kw)
        (out / name).write_bytes(made[name])
    return made


def _within_bounds(name: str, stream: bytes):
    source, _, max_err, rms = FIXTURE_SPECS[name]
    got = _same_decode(stream)
    src = source()
    assert got.shape == src.shape and got.dtype == src.dtype
    e = got.astype(np.float64) - src
    assert np.abs(e).max() <= max_err
    assert np.sqrt((e ** 2).mean()) <= rms


@pytest.mark.parametrize("name", sorted(FIXTURE_SPECS))
def test_committed_fixture_decodes_alike_within_its_bound(name):
    assert sum((FIXTURES / n).stat().st_size for n in FIXTURE_SPECS) \
        < 256 * 1024
    stream = (FIXTURES / name).read_bytes()
    assert J.decode(stream)[1:] == ((16, False) if name.startswith("ct")
                                    else (8, False))
    _within_bounds(name, stream)


def test_make_fixtures_remakes_them(tmp_path):
    for name, stream in make_fixtures(tmp_path).items():
        assert (tmp_path / name).read_bytes() == stream
        _within_bounds(name, stream)


# ------------------------------------------------------------------ DICOM --


def _file(tmp_path, name, streams, rows, cols, ts=JD.TS_J2K_LOSSLESS,
          **kw) -> str:
    return PW.write_codestreams(str(tmp_path / name), streams, rows, cols,
                                transfer_syntax=ts, **kw)


def _reads_equal(path: str):
    for load in ("load_dicom", "load_series", "load_frames_raw"):
        a, b = getattr(PD, load)(path), getattr(JD, load)(path)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                _same_array(x, y)
            else:
                assert x == y
    got = PD.decode_pixels(PD.read_dataset(path))
    _same_array(got, JD.decode_pixels(JD.read_dataset(path)))
    return got


def test_dicom_multiframe(tmp_path):
    frames = [_gray8(seed=60 + i, shape=(32, 40)) for i in range(3)]
    p = _file(tmp_path, "m.dcm", [_enc(f, no_jp2=True) for f in frames],
              32, 40, bits=8)
    _same_array(_reads_equal(p), np.stack(frames))
    a16 = _gray16(50, (48, 64))
    p = _file(tmp_path, "g.dcm", [_enc(a16, "I;16", no_jp2=True)], 48, 64)
    _same_array(_reads_equal(p), a16)


def test_dicom_lossy_91(tmp_path):
    a = _gray8(seed=61, shape=(32, 40))
    s = _enc(a, no_jp2=True, irreversible=True, quality_mode="rates",
             quality_layers=[8])
    p = _file(tmp_path, "l.dcm", [s], 32, 40, JD.TS_J2K, bits=8)
    assert PD.read_dataset(p).transfer_syntax == JD.TS_J2K
    got = _reads_equal(p)
    assert np.abs(got.astype(int) - _pil_dec(s).astype(int)).max() <= 2


@pytest.mark.parametrize("photometric,ts", [("YBR_RCT", JD.TS_J2K_LOSSLESS),
                                            ("YBR_ICT", JD.TS_J2K)])
def test_dicom_colour_reduces_to_luma(tmp_path, photometric, ts):
    rgb = _rgb(62, (32, 40))
    s = _enc(rgb, "RGB", no_jp2=True, irreversible=photometric == "YBR_ICT")
    p = _file(tmp_path, "c.dcm", [s], 32, 40, ts, bits=8, samples=3,
              photometric=photometric)
    _reads_equal(p)
    img, _ = PD.load_dicom(p)
    assert img.ndim == 2
    if photometric == "YBR_RCT":          # RGB after the inverse RCT
        from mdx_torch.io.normalize import to_grayscale

        np.testing.assert_allclose(img, to_grayscale(rgb.astype(np.float32)),
                                   atol=1e-5)


@pytest.mark.parametrize("defect,match", [
    ("signed", "signedness disagrees"),
    ("corrupt", "Corrupt JPEG 2000 pixel data"),
    ("depth", "16-bit JPEG 2000 codestream in a 8-bit container"),
    ("shape", r"frame is \(16, 16, 1\), dataset says \(16, 18, 1\)")])
def test_dicom_errors_same(tmp_path, defect, match):
    a = _gray8(seed=63, shape=(16, 16))
    s = _enc(a, no_jp2=True)
    kw = dict(bits=8)
    cols = 16
    if defect == "signed":
        kw["signed"] = True
    elif defect == "corrupt":
        s = b"\xff\x4f\xff\x51" + b"\x00" * 10
    elif defect == "depth":
        s = _enc(a.astype(np.uint16) * 200, "I;16", no_jp2=True)
    else:
        cols = 18
    p = _file(tmp_path, "e.dcm", [s], 16, cols, **kw)
    _raises_same(lambda: JD.decode_pixels(JD.read_dataset(p)),
                 lambda: PD.decode_pixels(PD.read_dataset(p)), match)


def test_jp2_wrapped_frames_in_several_fragments(tmp_path):
    frames = [_gray8(seed=70 + i, shape=(24, 32)) for i in range(2)]
    streams = [_enc(f) for f in frames]           # JP2 boxes
    frags = []
    for s in streams:
        frags += [s[:36], s[36:]]
    for M in (JD, PD):
        assert M._group_frame_streams(frags, 2, "JPEG 2000",
                                      kind="jpeg2k") == streams
    p = _file(tmp_path, "w.dcm", frags, 24, 32, bits=8)
    ds_p, ds_j = PD.read_dataset(p), JD.read_dataset(p)
    for ds in (ds_p, ds_j):
        ds.attrs["NumberOfFrames"] = 2
    _same_array(PD.decode_pixels(ds_p), JD.decode_pixels(ds_j))
    _same_array(PD.decode_pixels(ds_p), np.stack(frames))


def test_fragment_starting_ff4f_splits_a_frame_as_in_jax(tmp_path):
    """A continuation fragment that happens to begin FF 4F is taken for a
    frame start by both packages' grouping (FF 4F can occur inside J2K
    packet data): the frame is split and the counts disagree.  The port
    keeps JAX's behaviour (ROADMAP Queue 1)."""
    frames = [_gray8(seed=80 + i, shape=(24, 24)) for i in range(2)]
    s0, s1 = (_enc(f, no_jp2=True) for f in frames)
    frags = [s0[:40], b"\xff\x4f" + s0[40:], s1]    # not a valid stream
    for M in (JD, PD):
        with pytest.raises(M.DicomError,
                           match="groups into 3 codestreams, "
                                 "NumberOfFrames says 2"):
            M._group_frame_streams(frags, 2, "JPEG 2000", kind="jpeg2k")
    p = _file(tmp_path, "f.dcm", [s0, s1], 24, 24, bits=8)
    ds_p, ds_j = PD.read_dataset(p), JD.read_dataset(p)
    for ds in (ds_p, ds_j):
        ds.fragments = list(frags)
    _raises_same(lambda: JD.decode_pixels(ds_j),
                 lambda: PD.decode_pixels(ds_p), "groups into 3")
    # JPEG-family grouping does not split there
    for M in (JD, PD):
        assert M._group_frame_streams(
            [b"\xff\xd8\x01\x01", b"\xff\x4f\x02\x02", b"\xff\xd8\x03\x03"],
            2, "JPEG-LS", kind="jpeg") == [
            b"\xff\xd8\x01\x01\xff\x4f\x02\x02", b"\xff\xd8\x03\x03"]
