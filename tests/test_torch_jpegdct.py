"""The port's DCT JPEG decoder (``mdx_torch.io.jpegdct``, ``.4.50``/``.4.51``)
and its host segment loops (``mdx_torch.io.native``) against the JAX
package's ``mdx.io.jpegdct`` (with ``native/libmdxio.so`` as its own tests
build it) on the same streams.

Pillow's libjpeg makes the 8-bit streams, as in
``tests/test_dicom_jpegdct.py``; 12-bit streams come from a copy of that
file's test-only SOF1 encoder (q = 1).  Every image is made from a seed with
numpy.

* decode: the port's pixels and precision equal to JAX's, bit for bit, over
  qualities, shapes (odd ones too), 4:4:4, 4:2:2 and 4:2:0, progressive
  grayscale and colour, restart intervals (sequential and progressive),
  high-frequency content, 12-bit streams and hand-built known-answer
  blocks; the IDCT basis and zigzag order equal to JAX's;
* the host loops against the Python loops (``MDX_NO_NATIVE=1``) at 128^2
  and below, sequential and progressive, and the error taxonomy of each
  return code: the same message as JAX's loop of the same kind;
* errors: the same class and message as JAX's for malformed, truncated and
  unsupported streams and for random corruption (the port names its own
  modules where JAX's message names ``mdx.io``);
* DICOM: ``.4.50``/``.4.51`` files (``write_codestreams``) read as JAX
  reads them: a grayscale frame, a multi-frame file, frames spanning
  fragments, the YBR Y-plane path, corrupt streams, the signed-container
  refusal, a 12-bit stream in an 8-bit container, a frame of the wrong
  shape, and SOFs named for the wrong codec;
* the committed fixtures (``tests/torch_fixtures/jpegdct/``, made by
  :func:`make_fixtures`, which the card's machine cannot run: it has no
  Pillow): equal in both packages and within a stated bound of the pixels
  they were made from.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest

from mdx.io import dicom as JD
from mdx.io import jpegdct as J
from mdx_torch.io import dicom as PD
from mdx_torch.io import dicom_write as PW
from mdx_torch.io import jpegdct as P
from mdx_torch.io import native

PIL = pytest.importorskip("PIL.Image")

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "jpegdct"


def _pil(arr: np.ndarray, mode: str, **kw) -> bytes:
    b = io.BytesIO()
    PIL.fromarray(arr, mode).save(b, "JPEG", **kw)
    return b.getvalue()


def _gray(seed=0, shape=(64, 80)):
    rng = np.random.default_rng(seed)
    h, w = shape
    base = 128 + 40 * np.sin(np.arange(h * w).reshape(h, w) / 9.0)
    return np.clip(base + rng.normal(0, 8, shape), 0, 255).astype(np.uint8)


def _rgb(seed=3, shape=(64, 80)):
    g = _gray(seed=seed, shape=shape)
    return np.stack([g, np.roll(g, 5, 0), 255 - g], axis=-1)


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_decode(stream: bytes) -> np.ndarray:
    ja, jp = J.decode(stream)
    pa, pp = P.decode(stream)
    _same_array(pa, ja)
    assert pp == jp
    return pa


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 - compared below
        return (type(e).__name__, str(e).replace("mdx_torch.io", "mdx.io"))


def _same_outcome(a, b):
    assert a[0] == b[0], (a, b) if "ok" not in (a[0], b[0]) else (a[0], b[0])
    if a[0] == "ok":
        _same_array(a[1][0], b[1][0])
        assert a[1][1] == b[1][1]
    else:
        assert a == b


# ------------------------------------------------------- the 12-bit encoder --


def _encode_sequential_12bit(img: np.ndarray) -> bytes:
    """Test-only SOF1 12-bit encoder (a copy of the one in
    ``tests/test_dicom_jpegdct.py``): forward 8×8 DCT, q=1, one shared
    Huffman table pair of 8-bit codes covering every category.  No 12-bit
    encoder exists in an installable package."""
    h, w = img.shape
    assert h % 8 == 0 and w % 8 == 0
    by, bx = h // 8, w // 8
    shifted = img.astype(np.float64) - 2048.0
    blocks = shifted.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    coefs = np.einsum("ux,ijxy,vy->ijuv", P._IDCT_C * 2, blocks,
                      P._IDCT_C * 2) / 4.0
    zz = np.take(np.round(coefs).reshape(by, bx, 64), P._ZIGZAG,
                 axis=2).astype(np.int64)

    def _canonical(symbols):
        counts = [0] * 16
        counts[7] = len(symbols)
        return bytes(counts), bytes(symbols), {
            s: (i, 8) for i, s in enumerate(symbols)}

    dc_counts, dc_vals, dc_code = _canonical(list(range(16)))
    ac_syms = sorted({0x00, 0xF0} | {
        (r << 4) | s for r in range(16) for s in range(1, 15)})
    ac_counts, ac_vals, ac_code = _canonical(ac_syms)
    bits: list = []

    def put(code, n):
        for i in range(n - 1, -1, -1):
            bits.append((code >> i) & 1)

    pred = 0
    for yb in range(by):
        for xb in range(bx):
            blk = zz[yb, xb]
            diff = int(blk[0]) - pred
            pred = int(blk[0])
            t = abs(diff).bit_length()
            put(*dc_code[t])
            if t:
                put(diff if diff >= 0 else diff + (1 << t) - 1, t)
            k = 1
            while k < 64:
                run = 0
                while k < 64 and blk[k] == 0:
                    run += 1
                    k += 1
                if k == 64:
                    put(*ac_code[0x00])
                    break
                while run > 15:
                    put(*ac_code[0xF0])
                    run -= 16
                v = int(blk[k])
                s = abs(v).bit_length()
                put(*ac_code[(run << 4) | s])
                put(v if v >= 0 else v + (1 << s) - 1, s)
                k += 1
    while len(bits) % 8:
        bits.append(1)
    payload = bytearray()
    for i in range(0, len(bits), 8):
        b = int("".join(map(str, bits[i:i + 8])), 2)
        payload.append(b)
        if b == 0xFF:
            payload.append(0x00)
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + struct.pack(">HB", 2 + 1 + 128, 0x10)
    out += b"".join(struct.pack(">H", 1) for _ in range(64))
    out += b"\xff\xc1" + struct.pack(">HBHHB", 11, 12, h, w, 1)
    out += bytes((1, 0x11, 0))
    out += b"\xff\xc4" + struct.pack(
        ">HB", 2 + 1 + 16 + len(dc_vals), 0x00) + dc_counts + dc_vals
    out += b"\xff\xc4" + struct.pack(
        ">HB", 2 + 1 + 16 + len(ac_vals), 0x10) + ac_counts + ac_vals
    out += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes((1, 0x00))
    out += bytes((0, 63, 0))
    out += payload
    out += b"\xff\xd9"
    return bytes(out)


def _gray12(seed, shape=(32, 40)):
    rng = np.random.default_rng(seed)
    h, w = shape
    return np.clip(2048 + 600 * np.sin(np.arange(h * w).reshape(h, w) / 5.0)
                   + rng.normal(0, 50, shape), 0, 4095).astype(np.uint16)


# ------------------------------------------------------------------ decode --

# name → (image maker, Pillow mode, Pillow keywords)
_PILLOW = {
    **{f"gray_q{q}": (lambda q=q: _gray(seed=q), "L", {"quality": q})
       for q in (95, 85, 50, 20, 5)},
    **{f"odd{h}x{w}": (lambda h=h, w=w: np.random.default_rng(h + w)
                       .integers(0, 256, (h, w)).astype(np.uint8), "L",
                       {"quality": 90})
       for h, w in [(8, 8), (9, 13), (64, 65), (1, 1), (17, 128), (33, 7)]},
    **{f"rgb_{name}": (lambda: _rgb(), "RGB",
                       {"quality": 85, "subsampling": sub})
       for sub, name in ((0, "444"), (1, "422"), (2, "420"))},
    **{f"rgb_{name}_odd": (lambda: _rgb(7, (37, 51)), "RGB",
                           {"quality": 80, "subsampling": sub})
       for sub, name in ((1, "422"), (2, "420"))},
    **{f"prog_gray_q{q}": (lambda q=q: _gray(seed=q + 60, shape=(96, 112)),
                           "L", {"quality": q, "progressive": True})
       for q in (95, 85, 50, 20)},
    **{f"prog_rgb_{sub}": (lambda: _rgb(61), "RGB",
                           {"quality": 85, "progressive": True,
                            "subsampling": sub}) for sub in (0, 1, 2)},
    "prog_rgb_odd": (lambda: _rgb(62, (45, 29)), "RGB",
                     {"quality": 70, "progressive": True, "subsampling": 2}),
    "restart_gray": (lambda: _gray(seed=4, shape=(48, 48)), "L",
                     {"quality": 85, "restart_marker_blocks": 2}),
    "restart_rgb": (lambda: _rgb(8, (40, 72)), "RGB",
                    {"quality": 85, "subsampling": 2,
                     "restart_marker_rows": 1}),
    "restart_prog": (lambda: _gray(seed=9, shape=(56, 72)), "L",
                     {"quality": 75, "progressive": True,
                      "restart_marker_blocks": 3}),
    "highfreq": (lambda: (np.random.default_rng(5).integers(0, 2, (40, 40))
                          * 255).astype(np.uint8), "L", {"quality": 95}),
    "optimized": (lambda: _gray(seed=10), "L",
                  {"quality": 60, "optimize": True}),
}


@pytest.mark.parametrize("case", sorted(_PILLOW))
def test_pillow_decode_equals_jax(case):
    make, mode, kw = _PILLOW[case]
    img = make()
    s = _pil(img, mode, **kw)
    if kw.get("progressive"):
        assert b"\xff\xc2" in s
    if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
        assert b"\xff\xdd" in s
    got = _same_decode(s)
    assert got.shape == img.shape and got.dtype == np.uint8


@pytest.mark.parametrize("shape", [(32, 40), (8, 8), (64, 16)])
def test_12bit_decode_equals_jax(shape):
    img = _gray12(sum(shape), shape)
    got = _same_decode(_encode_sequential_12bit(img))
    assert got.dtype == np.uint16 and got.shape == shape
    # q = 1: the error is the DCT coefficients' rounding
    assert np.abs(got.astype(int) - img.astype(int)).max() <= 4


def _single_block_12bit(dc: int) -> bytes:
    """One 8×8 SOF1 12-bit block of DC ``dc`` (q = 1), codes of length 2."""
    cat = dc.bit_length()
    counts = [0] * 16
    counts[1] = 1
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes([1] * 64)
    out += b"\xff\xc1" + struct.pack(">HBHHB", 11, 12, 8, 8, 1)
    out += bytes((1, 0x11, 0))
    out += b"\xff\xc4" + struct.pack(">HB", 20, 0x00) + bytes(counts)
    out += bytes([cat])
    out += b"\xff\xc4" + struct.pack(">HB", 20, 0x10) + bytes(counts)
    out += bytes([0x00])
    out += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes((1, 0x00))
    out += bytes((0, 63, 0))
    bits = "00" + (format(dc, f"0{cat}b") if cat else "") + "00"
    bits += "1" * ((8 - len(bits) % 8) % 8)
    out += int(bits, 2).to_bytes(len(bits) // 8, "big")
    return bytes(out + b"\xff\xd9")


@pytest.mark.parametrize("dc", [0, 8, 800, 2047])
def test_flat_block_known_answer(dc):
    got = _same_decode(_single_block_12bit(dc))
    assert np.array_equal(got, np.full((8, 8), round(dc / 8.0) + 2048))


def test_idct_basis_and_zigzag_equal_jax():
    assert P._IDCT_C.dtype == J._IDCT_C.dtype
    assert np.array_equal(P._IDCT_C, J._IDCT_C)
    assert np.array_equal(P._ZIGZAG, J._ZIGZAG)
    zz = np.random.default_rng(0).integers(-300, 300, (3, 5, 64)).astype(
        np.int32)
    q = np.random.default_rng(1).integers(1, 50, 64).astype(np.int32)
    for prec in (8, 12):
        _same_array(P._reconstruct(zz, q, prec), J._reconstruct(zz, q, prec))
    plane = np.random.default_rng(2).integers(0, 4096, (7, 9))
    for axis in (0, 1):
        _same_array(P._upsample2x(plane, axis), J._upsample2x(plane, axis))


# -------------------------------------------- host loops and Python loops --

def _parity_stream(kind: str) -> bytes:
    g = _gray(seed=40, shape=(56, 72))
    rgb = np.stack([g, np.roll(g, 3, 1), 255 - g], -1)
    return {
        "gray": lambda: _pil(g, "L", quality=85),
        "rst": lambda: _pil(g, "L", quality=85, restart_marker_blocks=2),
        "rgb444": lambda: _pil(rgb, "RGB", quality=85, subsampling=0),
        "rgb422": lambda: _pil(rgb, "RGB", quality=85, subsampling=1),
        "rgb420": lambda: _pil(rgb, "RGB", quality=85, subsampling=2),
        "prog_gray": lambda: _pil(g, "L", quality=85, progressive=True),
        "prog_lowq": lambda: _pil(g, "L", quality=20, progressive=True),
        "prog_rgb420": lambda: _pil(rgb, "RGB", quality=85,
                                    progressive=True, subsampling=2),
        "prog_rst": lambda: _pil(g, "L", quality=60, progressive=True,
                                 restart_marker_blocks=5),
        "gray128": lambda: _pil(_gray(seed=41, shape=(128, 128)), "L",
                                quality=90),
        "prog128": lambda: _pil(_gray(seed=42, shape=(128, 128)), "L",
                                quality=90, progressive=True),
        "12bit": lambda: _encode_sequential_12bit(_gray12(43, (48, 56))),
    }[kind]()


@pytest.mark.parametrize("kind", ["gray", "rst", "rgb444", "rgb422",
                                  "rgb420", "prog_gray", "prog_lowq",
                                  "prog_rgb420", "prog_rst", "gray128",
                                  "prog128", "12bit"])
def test_host_decode_equals_python(monkeypatch, kind):
    s = _parity_stream(kind)
    native.reset_calls()
    host = P.decode(s)
    entry = "jpegdct_prog_segment" if kind.startswith("prog") \
        else "jpegdct_segment"
    assert native.CALLS[entry] > 0
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    native.reset_calls()
    py = P.decode(s)
    assert set(native.CALLS.values()) == {0}
    _same_array(host[0], py[0])
    assert host[1] == py[1]
    _same_array(host[0], J.decode(s)[0])


def _stream(scans, sof=0xC0, dc=((0,), 1), ac=((0,), 1), h=8, w=8):
    """A one-component stream: DQT of ones, ``sof``, DC and AC table 0 with
    ``dc``/``ac`` = (values, code length) (canonical codes, in order), then
    each of ``scans`` = ((Ss, Se, Ah, Al), bit string) as an SOS and its
    entropy bits, padded with 1s and FF-stuffed."""
    def dht(tc, values, length):
        counts = [0] * 16
        counts[length - 1] = len(values)
        return (b"\xff\xc4" + struct.pack(">HB", 19 + len(values), tc << 4)
                + bytes(counts) + bytes(values))

    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes([1] * 64)
    out += bytes((0xFF, sof)) + struct.pack(">HBHHB", 11, 8, h, w, 1)
    out += bytes((1, 0x11, 0))
    out += dht(0, *dc) + dht(1, *ac)
    for (ss, se, ah, al), bits in scans:
        out += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes((1, 0x00))
        out += bytes((ss, se, (ah << 4) | al))
        bits += "1" * ((8 - len(bits) % 8) % 8)
        for i in range(0, len(bits), 8):
            out.append(int(bits[i:i + 8], 2))
            if out[-1] == 0xFF:
                out.append(0x00)
    return bytes(out + b"\xff\xd9")


_SEQ = (0, 63, 0, 0)
# each return code of the host loops; name → (stream, host message)
_TAXONOMY = {
    "truncated": (_stream([(_SEQ, "00000000")], w=160),
                  "Truncated JPEG entropy segment."),
    "invalid_code": (_stream([(_SEQ, "1" * 16)]),
                     "Invalid Huffman code in scan data."),
    "ac_overflow": (_stream([(_SEQ, "0" + "00" * 3 + "01")],
                            ac=((0xF0, 0xF1), 2)),
                    "AC run overflows the block."),
    "dc_category": (_stream([(_SEQ, "0")], dc=((16,), 1)),
                    "Invalid DC category."),
    "prog_band_overflow": (_stream([((0, 0, 0, 0), "0"),
                                    ((1, 5, 0, 0), "0")], sof=0xC2,
                                   ac=((0x51,), 1)),
                           "AC run overflows the block."),
    "prog_refine_magnitude": (_stream([((0, 0, 0, 0), "0"),
                                       ((1, 63, 1, 0), "0")], sof=0xC2,
                                      ac=((0x02,), 1)),
                              "Invalid progressive refinement symbol."),
    "prog_refine_outside": (_stream([((0, 0, 0, 0), "0"),
                                     ((1, 1, 1, 0), "01")], sof=0xC2,
                                    ac=((0x11,), 1)),
                            "Invalid progressive refinement symbol."),
    "prog_dc_category": (_stream([((0, 0, 0, 0), "0")], sof=0xC2,
                                 dc=((17,), 1)), "Invalid DC category."),
}


@pytest.mark.parametrize("case", sorted(_TAXONOMY))
def test_host_error_taxonomy(monkeypatch, case):
    """Each return code maps to JAX's host message; the Python loops raise
    JAX's Python message (they differ for the progressive codes, as in
    JAX)."""
    s, msg = _TAXONOMY[case]
    host = _outcome(lambda: P.decode(s))
    assert host == ("JpegDctError", msg)
    _same_outcome(host, _outcome(lambda: J.decode(s)))
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    py = _outcome(lambda: P.decode(s))
    assert py[0] == "JpegDctError"
    # JAX's Python loops (its library, once loaded, ignores the variable)
    monkeypatch.setattr(J, "_native", lambda: None)
    _same_outcome(py, _outcome(lambda: J.decode(s)))


def test_prog_scan_wider_than_its_first_decodes_alike(monkeypatch):
    """A non-interleaved DC scan (3 x 3 blocks) then an interleaved one
    (4 x 4 for the same component): coefficients are allocated at the
    interleaved grid, so both loops index inside it and agree."""
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes([1] * 64)
    out += b"\xff\xc2" + struct.pack(">HBHHB", 14, 8, 17, 17, 2)
    out += bytes((1, 0x22, 0)) + bytes((2, 0x11, 0))
    counts = [0] * 16
    counts[0] = 1
    out += b"\xff\xc4" + struct.pack(">HB", 20, 0x00) + bytes(counts)
    out += bytes([0])
    out += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes((1, 0x00))
    out += bytes((0, 0, 0x01)) + b"\x00\x00"
    out += b"\xff\xda" + struct.pack(">HB", 10, 2)
    out += bytes((1, 0x00)) + bytes((2, 0x00)) + bytes((0, 0, 0x01))
    out += b"\x00\x00\x00\xff\xd9"
    s = bytes(out)
    host = _same_decode(s)
    assert host.shape == (17, 17, 2)
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    _same_array(P.decode(s)[0], host)


def test_host_fuzz_equals_python(monkeypatch):
    """Seeded corruption of sequential and progressive streams: the host
    loops and the Python loops give the same pixels or both raise."""
    rng = np.random.default_rng(3)
    cases = []
    for s in (_parity_stream("rst"), _parity_stream("prog_gray")):
        for _ in range(12):
            t = bytearray(s)
            for _ in range(rng.integers(1, 4)):
                t[rng.integers(len(s) // 3, len(t) - 2)] = rng.integers(0, 256)
            cases.append(bytes(t))
    host = [_outcome(lambda: P.decode(t)) for t in cases]
    for t, h in zip(cases, host):
        _same_outcome(h, _outcome(lambda: J.decode(t)))
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    for t, h in zip(cases, host):
        py = _outcome(lambda: P.decode(t))
        assert py[0] == h[0]
        if h[0] == "ok":
            _same_outcome(h, py)


@pytest.mark.parametrize("caller", ["sequential", "progressive",
                                    "packbits_encode", "packbits_decode"])
def test_failed_build_raises_no_fallback(monkeypatch, caller):
    """A host library that does not build raises ``NativeBuildError`` from
    the DCT and PackBits paths; nothing falls back to the Python loops."""
    from mdx_torch.io import rle

    def refuse(*a, **k):
        raise native.NativeBuildError("compiler refused on purpose")

    stream = _pil(_gray(seed=45, shape=(16, 16)), "L", quality=80,
                  progressive=caller == "progressive")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", refuse)
    native.reset_calls()
    call = {"sequential": lambda: P.decode(stream),
            "progressive": lambda: P.decode(stream),
            "packbits_encode": lambda: rle.packbits_encode(b"abc"),
            "packbits_decode": lambda: rle.packbits_decode(b"\x02abc", 3)}
    with pytest.raises(native.NativeBuildError, match="on purpose"):
        call[caller]()
    assert set(native.CALLS.values()) == {0}


def test_calls_count_one_a_restart_segment():
    s = _pil(_gray(seed=44, shape=(32, 48)), "L", quality=85,
             restart_marker_blocks=4)     # 4 x 6 blocks: 6 segments
    native.reset_calls()
    P.decode(s)
    assert native.CALLS["jpegdct_segment"] == 6
    assert native.CALLS["jpegdct_prog_segment"] == 0


# ------------------------------------------------------------------ errors --

def _sof_swapped(to: int) -> bytes:
    s = bytearray(_pil(_gray(seed=14, shape=(32, 32)), "L", quality=85))
    s[s.find(b"\xff\xc0") + 1] = to
    return bytes(s)


_ERRORS = {
    "not_jpeg": lambda: b"\x12\x34",
    "empty": lambda: b"",
    "no_eoi": lambda: _pil(_gray(seed=15), "L")[:-2],
    "half": lambda: (lambda s: s[:len(s) // 2])(_pil(_gray(seed=15), "L")),
    "arithmetic": lambda: _sof_swapped(0xC9),
    "lossless_sof3": lambda: _sof_swapped(0xC3),
    "jpegls_sof55": lambda: _sof_swapped(0xF7),
    "differential": lambda: _sof_swapped(0xC5),
    "baseline_12bit": lambda: (lambda s: s.replace(b"\xff\xc1", b"\xff\xc0"))(
        _single_block_12bit(8)),
    "no_scan": lambda: b"\xff\xd8\xff\xd9",
    "restart_out_of_sequence": lambda: (
        lambda s: s.replace(b"\xff\xd1", b"\xff\xd3", 1))(
            _pil(_gray(seed=16, shape=(48, 48)), "L",
                 restart_marker_blocks=2)),
    "restart_missing": lambda: (
        lambda s: s.replace(b"\xff\xd0", b"", 1))(
            _pil(_gray(seed=16, shape=(48, 48)), "L",
                 restart_marker_blocks=2)),
    "bad_sampling": lambda: (lambda s: s.replace(b"\x01\x11\x00", b"\x01\x31"
                                                 b"\x00", 1))(
        _pil(_gray(seed=17, shape=(16, 16)), "L")),
    "sequential_with_progressive_params": lambda: _stream(
        [((0, 63, 1, 0), "0")]),
    "bad_spectral": lambda: _stream([((0, 5, 0, 0), "0")], sof=0xC2),
    "duplicate_component_scan": lambda: (
        lambda s: s[:-2] + s[s.index(b"\xff\xda"):])(_stream([(_SEQ, "00")])),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_errors_same(case):
    s = _ERRORS[case]()
    got = _outcome(lambda: P.decode(s))
    assert got[0] == "JpegDctError", got
    _same_outcome(got, _outcome(lambda: J.decode(s)))


def test_wrong_codec_sofs_name_the_ports_modules():
    assert "mdx_torch.io.jpegll" in str(pytest.raises(
        P.JpegDctError, P.decode, _sof_swapped(0xC3)).value)
    assert "mdx_torch.io.jpegls" in str(pytest.raises(
        P.JpegDctError, P.decode, _sof_swapped(0xF7)).value)


def test_corrupted_streams_fail_alike():
    rng = np.random.default_rng(7)
    base = [_pil(_rgb(9, (40, 48)), "RGB", quality=80, subsampling=1),
            _pil(_gray(seed=18, shape=(40, 48)), "L", quality=70,
                 progressive=True)]
    for s in base:
        for _ in range(15):
            t = bytearray(s)
            for _ in range(rng.integers(1, 5)):
                t[rng.integers(2, len(t))] = rng.integers(0, 256)
            t = bytes(t)
            _same_outcome(_outcome(lambda: P.decode(t)),
                          _outcome(lambda: J.decode(t)))


# ------------------------------------------------------------------ DICOM --

@pytest.fixture
def _jax_numpy_rescale(monkeypatch):
    """Route the JAX reader's rescale to its numpy body (its C++ loop is
    one ulp off numpy's, ROADMAP Queue 3)."""
    from mdx.io import native as jax_native

    def refuse(*a, **k):
        raise jax_native.NativeUnavailable("numpy body under test")

    monkeypatch.setattr(jax_native, "rescale_f32", refuse)


def _file(tmp_path, name, streams, rows, cols, ts=JD.TS_JPEG_BASELINE,
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


def test_dicom_gray_frame(tmp_path, _jax_numpy_rescale):
    g = _gray(seed=10, shape=(64, 64))
    p = _file(tmp_path, "g.dcm", [_pil(g, "L", quality=95)], 64, 64, bits=8)
    got = _reads_equal(p)
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - g).mean() < 3


def test_dicom_multiframe_and_spanning_fragments(tmp_path,
                                                 _jax_numpy_rescale):
    frames = [_gray(seed=s, shape=(32, 40)) for s in (1, 2, 3)]
    streams = [_pil(f, "L", quality=90, progressive=s == 2)
               for s, f in enumerate(frames)]
    p = _file(tmp_path, "m.dcm", streams, 32, 40, bits=8)
    assert _reads_equal(p).shape == (3, 32, 40)
    # two frames in five fragments: grouped on FF D8
    a, b = streams[0], streams[1]
    ds_p, ds_j = PD.read_dataset(p), JD.read_dataset(p)
    for ds in (ds_p, ds_j):
        ds.attrs["NumberOfFrames"] = 2
        ds.fragments = [a[:10], a[10:50], a[50:], b[:7], b[7:]]
    _same_array(PD.decode_pixels(ds_p), JD.decode_pixels(ds_j))


def test_dicom_12bit_extended(tmp_path, _jax_numpy_rescale):
    img = _gray12(19, (48, 64))
    p = _file(tmp_path, "x.dcm", [_encode_sequential_12bit(img)], 48, 64,
              ts=JD.TS_JPEG_EXTENDED, bits=16)
    got = _reads_equal(p)
    assert got.dtype == np.uint16
    assert np.abs(got.astype(int) - img.astype(int)).max() <= 4


@pytest.mark.parametrize("sub", [0, 1, 2])
def test_dicom_ybr_takes_the_y_plane(tmp_path, sub, _jax_numpy_rescale):
    rgb = _rgb(11, (48, 64))
    s = _pil(rgb, "RGB", quality=92, subsampling=sub)
    p = _file(tmp_path, "y.dcm", [s, s], 48, 64, bits=8, samples=3,
              photometric="YBR_FULL_422", modality="US")
    stored = _reads_equal(p)
    assert stored.shape == (2, 48, 64, 3)
    img = PD.load_dicom(p)[0]
    assert img.ndim == 2
    np.testing.assert_array_equal(img, P.decode(s)[0][..., 0])


@pytest.mark.parametrize("defect,match", [
    ("corrupt", "Corrupt JPEG pixel data"),
    ("signed", "Signed pixel data"),
    ("12_in_8", "12-bit JPEG codestream in an 8-bit container"),
    ("shape", "JPEG frame is"),
    ("bits32", "BitsAllocated=32"),
    ("sof3", "lossless \\(SOF3\\)"),
    ("sof55", "JPEG-LS \\(SOF55\\)"),
    ("j2k_body", "missing SOI"),
    ("frames", "groups into"),
])
def test_dicom_errors_same(tmp_path, defect, match):
    from mdx_torch.io import jpegll, jpegls

    g = _gray(seed=12, shape=(32, 32))
    s = _pil(g, "L", quality=85)
    kw = {"bits": 8}
    streams, rows = [s], 32
    if defect == "corrupt":
        streams = [s[:40]]
    elif defect == "signed":
        kw["signed"] = True
    elif defect == "12_in_8":
        streams = [_encode_sequential_12bit(_gray12(20, (32, 32)))]
    elif defect == "shape":
        rows = 24
    elif defect == "bits32":
        kw["bits"] = 32
    elif defect == "sof3":
        streams = [jpegll.encode(g.astype(np.uint16), precision=8,
                                 predictor=1)]
    elif defect == "sof55":
        streams = [jpegls.encode(g, precision=8)]
    elif defect == "j2k_body":
        from mdx_torch.io import jpeg2k

        streams = [jpeg2k.encode(g)]
    p = _file(tmp_path, "e.dcm", streams, rows, 32, **kw)
    ds_p, ds_j = PD.read_dataset(p), JD.read_dataset(p)
    if defect == "frames":
        for ds in (ds_p, ds_j):
            ds.attrs["NumberOfFrames"] = 3
            ds.fragments = [s[:20], s[20:], s[:30], s[30:]]
    got = _outcome(lambda: PD.decode_pixels(ds_p))
    assert got[0] == "DicomError"
    assert __import__("re").search(match, got[1]), got
    _same_outcome(got, _outcome(lambda: JD.decode_pixels(ds_j)))


# -------------------------------------------------------------- fixtures --

def _ct8(seed=0, n=512) -> np.ndarray:
    """An 8-bit CT-like slice (soft tissue window): body, organs, a bone
    ring, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / n - 0.5
    r = np.hypot(x, y * 1.2)
    img = np.where(r < 0.42, 110.0, 8.0)
    img += np.where(np.hypot(x - 0.12, y) < 0.08, 40.0, 0.0)
    img += np.where(np.hypot(x + 0.15, y + 0.1) < 0.05, 120.0, 0.0)
    img += np.where((r > 0.40) & (r < 0.42), 130.0, 0.0)
    img += rng.normal(0, 3, (n, n))
    return np.clip(img, 0, 255).astype(np.uint8)


def _ultrasound_rgb(seed=1, shape=(480, 640)) -> np.ndarray:
    """A colour ultrasound frame: a speckled grey fan and a colour Doppler
    box (the RGB that a scanner's JPEG encoder turns into YBR 4:2:2)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy + 40.0, xx - w / 2)
    ang = np.arctan2(xx - w / 2, yy + 40.0)
    fan = (r > 60) & (r < h) & (np.abs(ang) < 0.7)
    tissue = 90 + 50 * np.sin(r / 23.0) * np.cos(ang * 5)
    speckle = rng.gamma(6.0, 1 / 6.0, shape)
    gray = np.where(fan, np.clip(tissue * speckle, 0, 255), 0)
    rgb = np.repeat(gray[..., None], 3, -1)
    box = (yy > 150) & (yy < 260) & (xx > 260) & (xx < 380) & fan
    flow = np.sin((xx - 260) / 18.0)
    rgb[box, 0] = np.where(flow[box] > 0, 200 * flow[box], rgb[box, 0])
    rgb[box, 2] = np.where(flow[box] < 0, -200 * flow[box], rgb[box, 2])
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ct12(seed=2, n=256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / n - 0.5
    r = np.hypot(x, y * 1.2)
    img = 1024 + 400 * np.cos(6 * r) * (r < 0.42)
    img += np.where(np.hypot(x + 0.15, y + 0.1) < 0.05, 1500.0, 0.0)
    img += rng.normal(0, 4, (n, n))
    return np.clip(img, 0, 4095).astype(np.uint16)


# name → (source pixels, encoder, max |error|, RMS error bound); the colour
# frame's bounds are on its Y plane against the source's BT.601 luma
FIXTURE_SPECS = {
    "ct512_rst.jpg": (lambda: _ct8(), lambda a: _pil(
        a, "L", quality=90, restart_marker_blocks=64), 20, 3.0),
    "ct512_prog.jpg": (lambda: _ct8(), lambda a: _pil(
        a, "L", quality=90, progressive=True), 20, 3.0),
    "us480x640_422.jpg": (lambda: _ultrasound_rgb(), lambda a: _pil(
        a, "RGB", quality=75, subsampling=1), 50, 8.0),
    "ct256_12bit.jpg": (lambda: _ct12(), _encode_sequential_12bit, 2, 0.5),
}


def make_fixtures(out_dir) -> dict:
    """Write the DCT JPEG fixtures: Pillow's libjpeg streams (a 512^2 8-bit
    slice with restart intervals, the same progressive, a 480 x 640 colour
    ultrasound frame at 4:2:2) and a 256^2 12-bit SOF1 stream of the
    test-only encoder, all from seeded pixels.  ``python -c "from
    tests.test_torch_jpegdct import make_fixtures;
    make_fixtures('tests/torch_fixtures/jpegdct')"`` from the repo root
    remakes them."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    made = {}
    for name, (source, encode, _, _) in FIXTURE_SPECS.items():
        made[name] = encode(source())
        (out / name).write_bytes(made[name])
    return made


def _within_bounds(name: str, stream: bytes):
    source, _, max_err, rms = FIXTURE_SPECS[name]
    got = _same_decode(stream)
    src = source()
    assert got.shape == src.shape and got.dtype == src.dtype
    if src.ndim == 3:
        src = src.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
        got = got[..., 0]
    e = got.astype(np.float64) - src
    assert np.abs(e).max() <= max_err
    assert np.sqrt((e ** 2).mean()) <= rms


@pytest.mark.parametrize("name", sorted(FIXTURE_SPECS))
def test_committed_fixture_decodes_alike_within_its_bound(name):
    assert sum((FIXTURES / n).stat().st_size for n in FIXTURE_SPECS) \
        < 300 * 1024
    stream = (FIXTURES / name).read_bytes()
    assert J.decode(stream)[1] == (12 if "12bit" in name else 8)
    _within_bounds(name, stream)


def test_make_fixtures_remakes_them(tmp_path):
    for name, stream in make_fixtures(tmp_path).items():
        assert (tmp_path / name).read_bytes() == stream
        _within_bounds(name, stream)
