"""The port's lossless JPEG codecs (``mdx_torch.io.jpegll``,
``mdx_torch.io.jpegls``) and their host C++ loops (``mdx_torch.io.native``)
against the JAX package's (``mdx.io.jpegll``, ``mdx.io.jpegls``, with its
``native/libmdxio.so`` as its own tests build it) on the same inputs, every
one made from a seed with numpy.

* JPEG Lossless: the port's decode of JAX-encoded streams bit-equal to
  JAX's decode, the port's encode byte-equal to JAX's: predictors 1-7,
  precisions 2-16, point transform, restart intervals, three-component
  frames (the Python scan path, as in JAX), 1xN and Nx1 frames, a fuzz;
* JPEG-LS: the same for NEAR 0-3, precisions 2-16, restart intervals, the
  three interleave modes (ILV 0 with several components decodes, ILV 1 and
  2 are refused by both), flat, ramp, noise, checker and run content, and
  LSE preset thresholds;
* errors: malformed, truncated, corrupt-code and table-mismatch streams
  and bad encode arguments raise the same class with the same message;
* the host loops bit for bit against the port's Python bodies on random
  and truncated segments;
* the host library: its hashed path under ``build/mdx_torch_host/``, reuse
  by a second process, a failed build raising ``NativeBuildError`` with
  the compiler's text, ``CALLS``, ``MDX_NO_NATIVE=1``, and many threads
  sharing one library.
"""

import os
import re
import shutil
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from mdx.io import jpegll as JL
from mdx.io import jpegls as JS
from mdx_torch.io import jpegll as PL
from mdx_torch.io import jpegls as PS
from mdx_torch.io import native

ROOT = Path(__file__).resolve().parents[1]


def _img(seed=0, shape=(40, 56), precision=12):
    """Gradient + noise + a flat band: small and large differences, runs."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = np.linspace(0, (1 << precision) - 1, w, dtype=np.int64)
    img = np.broadcast_to(base, shape).copy()
    img[h // 4:h // 2] = (1 << precision) // 2
    img += rng.integers(-200, 200, shape)
    return np.clip(img, 0, (1 << precision) - 1).astype(np.uint16)


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


# ----------------------------------------------------------- JPEG Lossless --


def _ll_same(img, **kw) -> bytes:
    """Encode in both packages (byte-equal), decode JAX's stream in both
    (bit-equal), and check the round trip; returns the stream."""
    a = JL.encode(img, **kw)
    assert PL.encode(img, **kw) == a
    (ja, jp), (pa, pp) = JL.decode(a), PL.decode(a)
    _same_array(pa, ja)
    assert pp == jp
    pt = kw.get("point_transform", 0)
    want = (img.astype(np.int64) >> pt) << pt
    assert np.array_equal(pa, want)
    return a


@pytest.mark.parametrize("pred", range(1, 8))
def test_jpegll_predictors(pred):
    _ll_same(_img(seed=pred), precision=12, predictor=pred)


@pytest.mark.parametrize("precision", [2, 8, 12, 15, 16])
@pytest.mark.parametrize("pred", [1, 6])
def test_jpegll_precisions(precision, pred):
    _ll_same(_img(seed=precision, precision=precision), precision=precision,
             predictor=pred)


def test_jpegll_precision_inferred():
    _ll_same(_img(seed=3, precision=10))


@pytest.mark.parametrize("pt,pred", [(1, 1), (3, 4), (2, 7), (11, 2)])
def test_jpegll_point_transform(pt, pred):
    _ll_same(_img(seed=pt), precision=12, predictor=pred, point_transform=pt)


@pytest.mark.parametrize("pred,restart_rows", [(1, 1), (4, 5), (7, 3),
                                               (5, 40), (2, 17)])
def test_jpegll_restart_intervals(pred, restart_rows):
    _ll_same(_img(seed=restart_rows), precision=12, predictor=pred,
             restart_rows=restart_rows)


@pytest.mark.parametrize("ncomp", [2, 3, 4])
def test_jpegll_interleaved_components_take_the_python_scan(ncomp):
    rng = np.random.default_rng(ncomp)
    img = rng.integers(0, 4096, (24, 20, ncomp)).astype(np.uint16)
    native.reset_calls()
    _ll_same(img, precision=12, predictor=1, restart_rows=7)
    # JAX's native decode serves one component only; so does the port's
    assert native.CALLS["jpegll_diffs"] == 0
    assert native.CALLS["jpegll_pack"] == 4


@pytest.mark.parametrize("shape", [(1, 1), (1, 37), (37, 1), (2, 2)])
@pytest.mark.parametrize("pred", [1, 4, 7])
def test_jpegll_degenerate_shapes(shape, pred):
    rng = np.random.default_rng(sum(shape) + pred)
    _ll_same(rng.integers(0, 1 << 16, shape).astype(np.uint16),
             precision=16, predictor=pred)


def test_jpegll_ssss16_and_stuffing():
    img = np.zeros((9, 11), np.uint16)
    img[::2] = 65535                      # ±32768 diffs everywhere
    _ll_same(img, precision=16)
    _ll_same(np.full((16, 16), 77, np.uint16), precision=8)


def test_jpegll_fuzz():
    rng = np.random.default_rng(99)
    for trial in range(25):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        precision = int(rng.integers(2, 17))
        img = rng.integers(0, 1 << precision, (h, w)).astype(np.uint16)
        _ll_same(img, precision=precision, predictor=int(rng.integers(1, 8)),
                 restart_rows=int(rng.integers(0, 4)))


# ----------------------------------------------------------------- JPEG-LS --


def _ls_same(img, **kw) -> bytes:
    a = JS.encode(img, **kw)
    assert PS.encode(img, **kw) == a
    (ja, jp, jn), (pa, pp, pn) = JS.decode(a), PS.decode(a)
    _same_array(pa, ja)
    assert (pp, pn) == (jp, jn)
    near = kw.get("near", 0)
    assert np.abs(pa - img.astype(np.int64)).max() <= near
    return a


@pytest.mark.parametrize("near", [0, 1, 2, 3])
def test_jpegls_near(near):
    _ls_same(_img(seed=near), precision=12, near=near)


@pytest.mark.parametrize("precision", range(2, 17))
def test_jpegls_precisions(precision):
    _ls_same(_img(seed=precision, precision=precision), precision=precision)


@pytest.mark.parametrize("restart_rows,near", [(1, 0), (5, 0), (16, 2),
                                               (40, 1)])
def test_jpegls_restart_intervals(restart_rows, near):
    _ls_same(_img(seed=restart_rows, shape=(37, 23)), precision=12,
             near=near, restart_rows=restart_rows)


def _content(kind: str, shape=(24, 31), precision=12):
    rng = np.random.default_rng(len(kind))
    h, w = shape
    maxv = (1 << precision) - 1
    if kind == "flat":
        return np.full(shape, 1234 & maxv)
    if kind == "ramp":
        return np.add.outer(np.arange(h), np.arange(w)) * maxv // (h + w)
    if kind == "noise":
        return rng.integers(0, maxv + 1, shape)
    if kind == "checker":                 # 0 ↔ MAXVAL: the LG escape path
        return np.indices(shape).sum(0) % 2 * maxv
    if kind == "runs":                    # runs that end at and before EOL
        img = np.repeat(rng.integers(0, maxv + 1, (h, w // 3 + 1)), 3,
                        axis=1)[:, :w]
        img[h // 2, 0] = 17
        return img
    return _img(seed=5, shape=shape, precision=precision)   # "band"


@pytest.mark.parametrize("kind", ["flat", "ramp", "noise", "checker", "runs",
                                  "band"])
@pytest.mark.parametrize("near", [0, 2])
def test_jpegls_content(kind, near):
    _ls_same(_content(kind).astype(np.uint16), precision=12, near=near)


@pytest.mark.parametrize("shape", [(1, 1), (1, 17), (17, 1), (2, 2)])
def test_jpegls_degenerate_shapes(shape):
    rng = np.random.default_rng(sum(shape))
    _ls_same(rng.integers(0, 256, shape).astype(np.uint8), precision=8)


@pytest.mark.parametrize("w", [4, 5, 8, 13, 16, 64])
def test_jpegls_runs_to_line_end(w):
    img = np.full((7, w), 42, np.uint8)
    img[3, 0] = 17
    _ls_same(img, precision=8)


def test_jpegls_fuzz():
    rng = np.random.default_rng(99)
    for trial in range(40):
        p = int(rng.integers(2, 17))
        maxv = (1 << p) - 1
        h, w = int(rng.integers(1, 24)), int(rng.integers(1, 24))
        img = rng.integers(0, maxv + 1, (h, w))
        if trial % 2:
            img[h // 2:] = img[h // 2, 0]
        near = int(rng.integers(0, min(3, maxv // 2) + 1)) if trial % 3 == 0 \
            else 0
        _ls_same(img, precision=p, near=near)


def test_jpegls_segment_ending_in_ff_is_refused_alike():
    """A restart interval whose last byte is 0xFF: the encoder appends no
    zero byte after it, so the decoder takes that 0xFF for the start of the
    RST marker and refuses the stream.  Both packages write the same bytes
    and give the same error (carried over bit for bit; ROADMAP Queue 3)."""
    img = np.array([[15, 6, 152, 190, 108], [225, 216, 233, 118, 159]]
                   + [[167] * 5] * 10, np.uint8)
    a = JS.encode(img, precision=8, restart_rows=8)
    assert PS.encode(img, precision=8, restart_rows=8) == a
    assert b"\xff\xff\xd0" in a
    _raises_same(lambda: JS.decode(a), lambda: PS.decode(a),
                 "Missing restart marker")


def _params(mod, maxval, near, t=None, reset=64):
    t1, t2, t3 = t or mod.default_thresholds(maxval, near)
    return mod._Params(maxval, near, t1, t2, t3, reset)


def _sof55(p, h, w, ncomp=1) -> bytes:
    out = b"\xff\xf7" + struct.pack(">HBHHB", 8 + 3 * ncomp, p, h, w, ncomp)
    return out + b"".join(bytes((c + 1, 0x11, 0)) for c in range(ncomp))


def _sos(comps, near=0, ilv=0) -> bytes:
    body = bytes([len(comps)]) + b"".join(bytes((c, 0)) for c in comps)
    body += bytes((near, ilv, 0))
    return b"\xff\xda" + struct.pack(">H", len(body) + 2) + body


def _lse(maxval, t1, t2, t3, reset) -> bytes:
    return b"\xff\xf8" + struct.pack(">HBHHHHH", 13, 1, maxval, t1, t2, t3,
                                     reset)


def _ls_decoded_same(stream: bytes):
    (ja, jp, jn), (pa, pp, pn) = JS.decode(stream), PS.decode(stream)
    _same_array(pa, ja)
    assert (pp, pn) == (jp, jn)
    return pa


@pytest.mark.parametrize("ncomp", [2, 3])
@pytest.mark.parametrize("near", [0, 2])
def test_jpegls_ilv0_components(ncomp, near):
    """Nf > 1 in ILV 0: one scan per component, fresh coder state each
    (hand-built: the encoder writes Nf = 1 for DICOM grayscale)."""
    rng = np.random.default_rng(ncomp + near)
    h, w, p = 16, 20, 8
    planes = [rng.integers(0, 256, (h, w)) for _ in range(ncomp)]
    params = _params(JS, 255, near)
    out = b"\xff\xd8" + _sof55(p, h, w, ncomp)
    for ci, plane in enumerate(planes, start=1):
        out += _sos([ci], near) + JS._encode_scan_python(plane, params)
    img = _ls_decoded_same(out + b"\xff\xd9")
    assert img.shape == (h, w, ncomp)
    assert np.abs(img - np.stack(planes, -1)).max() <= near


@pytest.mark.parametrize("ilv", [1, 2])
def test_jpegls_line_and_sample_interleave_refused_alike(ilv):
    stream = (b"\xff\xd8" + _sof55(8, 4, 4, 3) + _sos([1, 2, 3], 0, ilv)
              + b"\x00" * 8 + b"\xff\xd9")
    _raises_same(lambda: JS.decode(stream), lambda: PS.decode(stream),
                 "Interleaved JPEG-LS scans")


@pytest.mark.parametrize("maxval,t,reset,near", [
    (4095, (10, 40, 200), 32, 0),
    (4095, (0, 0, 0), 0, 0),              # zeros: the defaults, RESET 64
    (1000, (5, 17, 80), 64, 0),           # MAXVAL below 2^P - 1
    (4095, (30, 90, 400), 16, 2),
    (255, (3, 3, 3), 255, 1)])
def test_jpegls_lse_preset_thresholds(maxval, t, reset, near):
    h, w, p = 20, 24, 12
    img = np.clip(_img(seed=maxval + near, shape=(h, w)), 0, maxval)
    defaults = JS.default_thresholds(maxval, near)
    used = tuple(ti or di for ti, di in zip(t, defaults))
    params = _params(JS, maxval, near, used, reset or 64)
    scan = JS._encode_scan_python(img.astype(np.int64), params)
    assert native.jpegls_encode(img, _params(PS, maxval, near, used,
                                             reset or 64)) == scan
    stream = (b"\xff\xd8" + _sof55(p, h, w) + _lse(maxval, *t, reset)
              + _sos([1], near) + scan + b"\xff\xd9")
    got = _ls_decoded_same(stream)
    assert np.abs(got - img).max() <= near


# ------------------------------------------------------------------ errors --


def _raises_same(jax_fn, port_fn, match=None):
    with pytest.raises(Exception) as je:
        jax_fn()
    with pytest.raises(Exception) as pe:
        port_fn()
    j, p = je.value, pe.value
    assert (type(p).__name__, str(p)) == (type(j).__name__, str(j))
    port_cls = {"JpegLLError": PL.JpegLLError,
                "JpegLSError": PS.JpegLSError}.get(type(j).__name__)
    if port_cls is not None:
        assert isinstance(p, port_cls)
    if match:
        assert re.search(match, str(p)), str(p)


def _patched(stream: bytes, marker: bytes, offset: int, value: int) -> bytes:
    b = bytearray(stream)
    b[bytes(b).find(marker) + offset] = value
    return bytes(b)


def _ll_stream(**kw):
    return JL.encode(_img(seed=3, shape=(16, 16)), precision=12, **kw)


def _ll_cases():
    enc = _ll_stream()
    sos = enc.find(b"\xff\xda")
    dht = enc.find(b"\xff\xc4")
    hdr = enc[:sos + 2 + struct.unpack_from(">H", enc, sos + 2)[0]]
    rst = _ll_stream(restart_rows=4)
    return {
        "not_a_jpeg": b"\x00\x01\x02\x03",
        "lossy_sof": _patched(enc, b"\xff\xc3", 1, 0xC0),
        "truncated_half": enc[:len(enc) // 2],
        "truncated_scan": enc[:len(enc) - 40] + b"\xff\xd9",
        "no_eoi": enc[:-2],
        # all-ones bytes: longer than any code (Annex K.2's reserved word)
        "corrupt_code": hdr + b"\xff\x00" * 8 + b"\xff\xd9",
        "missing_table": _patched(enc, b"\xff\xda", 6, 0x10),
        "dht_value_list": enc[:dht + 4] + b"\x00" + b"\x10" * 16
        + enc[dht + 21:],
        "dht_symbol_17": _patched(enc, b"\xff\xc4", 21, 17),
        "unknown_component": _patched(enc, b"\xff\xda", 5, 9),
        "predictor_0": _patched(enc, b"\xff\xda", 7, 0),
        "point_transform": _patched(enc, b"\xff\xda", 9, 12),
        "precision_1": _patched(enc, b"\xff\xc3", 4, 1),
        "zero_rows": _patched(_patched(enc, b"\xff\xc3", 5, 0),
                              b"\xff\xc3", 6, 0),
        "five_components": _patched(enc, b"\xff\xc3", 9, 5),
        "subsampled": _patched(enc, b"\xff\xc3", 11, 0x21),
        "sos_before_sof": b"\xff\xd8" + enc[sos:],
        "no_frame": b"\xff\xd8\xff\xd9",
        "two_sof": enc[:sos] + enc[2:dht] + enc[sos:],
        "mid_row_restart": _patched(rst, b"\xff\xdd", 5, 17),
        "restart_count": _patched(rst, b"\xff\xdd", 5, 16 * 2),
        "restart_sequence": rst.replace(b"\xff\xd1", b"\xff\xd3", 1),
        "bad_segment_length": _patched(enc, b"\xff\xc4", 2, 0xFF),
    }


@pytest.mark.parametrize("case", sorted(_ll_cases()))
def test_jpegll_errors_same(case):
    stream = _ll_cases()[case]
    _raises_same(lambda: JL.decode(stream), lambda: PL.decode(stream))


@pytest.mark.parametrize("kw", [{"predictor": 0}, {"precision": 17},
                                {"precision": 4},
                                {"precision": 12, "point_transform": 12},
                                {"restart_rows": 0, "precision": 1}])
def test_jpegll_bad_encode_args_same(kw):
    img = _img(shape=(8, 8))
    _raises_same(lambda: JL.encode(img, **kw), lambda: PL.encode(img, **kw))


@pytest.mark.parametrize("img", [np.zeros((4, 4, 5), np.uint16),
                                 np.zeros((0, 4), np.uint16),
                                 np.zeros(4, np.uint16)])
def test_jpegll_bad_encode_shapes_same(img):
    _raises_same(lambda: JL.encode(img), lambda: PL.encode(img))


def test_jpegll_oversubscribed_table_same():
    counts = np.zeros(16, np.int64)
    counts[0] = 3
    vals = np.arange(3, dtype=np.uint8)
    _raises_same(lambda: JL._build_table(counts, vals),
                 lambda: PL._build_table(counts, vals), "over-subscribes")


def _ls_cases():
    img = _img(seed=11, shape=(16, 16))
    enc = JS.encode(img, precision=12)
    enc8 = JS.encode(np.ones((4, 4), np.uint8), precision=8)
    sos = enc.find(b"\xff\xda")
    scan = enc[sos + 10:-2]
    rst = JS.encode(img, precision=12, restart_rows=4)
    head = b"\xff\xd8" + _sof55(12, 16, 16)
    return {
        "not_a_jpeg": b"\x00\x01\x02",
        "sof3_stream": JL.encode(np.ones((4, 4), np.uint16), precision=12),
        "truncated_half": enc[:len(enc) // 2],
        "no_eoi": enc[:-2],
        "truncated_scan": enc[:sos + 10 + len(scan) // 2],
        "marker_mid_symbol": enc[:sos + 10 + len(scan) // 2] + b"\xff\xd9",
        "corrupt_golomb": head + _sos([1]) + b"\x00" * 40 + b"\xff\xd9",
        "ilv_patch": _patched(_patched(enc8, b"\xff\xda", 8, 1),
                              b"\xff\xda", 4, 3),
        "ilv0_two_components": b"\xff\xd8" + _sof55(8, 4, 4, 2)
        + _sos([1, 2]) + b"\x00" * 4 + b"\xff\xd9",
        "lse_mapping": enc8[:enc8.find(b"\xff\xda")]
        + b"\xff\xf8" + struct.pack(">HB", 3, 2) + enc8[enc8.find(b"\xff\xda"):],
        "lse_oversize": head + b"\xff\xf8" + struct.pack(">HB", 3, 4)
        + enc[sos:],
        "lse_unknown": head + b"\xff\xf8" + struct.pack(">HB", 3, 9)
        + enc[sos:],
        "lse_malformed": head + b"\xff\xf8" + struct.pack(">HBH", 5, 1, 9)
        + enc[sos:],
        "lse_thresholds": head + _lse(4095, 50, 20, 10, 64) + enc[sos:],
        "lse_maxval_0": head + _lse(0, 0, 0, 0, 0) + enc[sos:],
        "point_transform": _patched(enc8, b"\xff\xda", 9, 2),
        "near_too_big": _patched(enc8, b"\xff\xda", 7, 200),
        "dnl_height": _patched(_patched(enc, b"\xff\xf7", 5, 0),
                               b"\xff\xf7", 6, 0),
        "precision_17": _patched(enc, b"\xff\xf7", 4, 17),
        "sof_length": _patched(enc, b"\xff\xf7", 3, 12),
        "subsampled": _patched(enc, b"\xff\xf7", 11, 0x22),
        "sos_before_sof": b"\xff\xd8" + enc[sos:],
        "sos_length": _patched(enc, b"\xff\xda", 3, 9),
        "dnl_marker": head + b"\xff\xdc\x00\x04\x00\x10" + enc[sos:],
        "stray_restart": head + b"\xff\xd0" + enc[sos:],
        "unexpected_marker": head + b"\xff\xc4\x00\x02" + enc[sos:],
        "no_scan": head + b"\xff\xd9",
        "missing_component_scan": b"\xff\xd8" + _sof55(8, 4, 4, 2)
        + _sos([1]) + JS._encode_scan_python(np.zeros((4, 4), np.int64),
                                             _params(JS, 255, 0))
        + b"\xff\xd9",
        "missing_restart": rst.replace(b"\xff\xd0", b"", 1),
        "restart_sequence": rst.replace(b"\xff\xd1", b"\xff\xd2", 1),
        "not_a_marker": enc[:sos] + b"\x00" + enc[sos:],
    }


@pytest.mark.parametrize("case", sorted(_ls_cases()))
def test_jpegls_errors_same(case):
    stream = _ls_cases()[case]
    _raises_same(lambda: JS.decode(stream), lambda: PS.decode(stream))


@pytest.mark.parametrize("img,kw", [
    (np.zeros((4, 4), np.uint8), {"precision": 17}),
    (np.full((4, 4), 300, np.int32), {"precision": 8}),
    (np.full((4, 4), -1, np.int32), {}),
    (np.zeros((4, 4), np.uint8), {"precision": 8, "near": 200}),
    (np.zeros((4, 4, 3), np.uint8), {}),
    (np.zeros((4, 4), np.float32), {}),
    (np.zeros((0, 4), np.uint8), {})])
def test_jpegls_bad_encode_args_same(img, kw):
    _raises_same(lambda: JS.encode(img, **kw), lambda: PS.encode(img, **kw))


def test_jpegls_bit_io_same():
    for mod in (JS, PS):
        bw = mod._BitWriter()
        bw.write_bits(0xFF, 8)
        bw.write_bits(0b1010101, 7)
        bw.write_bits(0x3, 2)
        bw.flush()
        assert bytes(bw.out) == b"\xff\x55\xc0"
    _raises_same(lambda: JS._BitReader(b"\xff\xd9", 0).read_bits(9),
                 lambda: PS._BitReader(b"\xff\xd9", 0).read_bits(9), "marker")


@pytest.mark.parametrize("maxval,near", [(3, 0), (255, 0), (255, 2),
                                         (4095, 0), (4095, 7), (65535, 3),
                                         (100, 1), (127, 0)])
def test_jpegls_derived_parameters_same(maxval, near):
    assert PS.default_thresholds(maxval, near) == \
        JS.default_thresholds(maxval, near)
    p, j = _params(PS, maxval, near), _params(JS, maxval, near)
    for k in ("range", "limit", "qbpp", "a_init", "t"):
        assert getattr(p, k) == getattr(j, k), k


# -------------------------------------------------- host loops vs Python --


def _ll_table():
    enc = PL.encode(_img(seed=8, shape=(24, 24)), precision=12)
    dht = enc.find(b"\xff\xc4") + 4
    counts = np.frombuffer(enc[dht + 1:dht + 17], np.uint8)
    values = np.frombuffer(enc[dht + 17:dht + 17 + int(counts.sum())],
                           np.uint8)
    return PL._build_table(counts.astype(np.int64), values)


def _outcome(fn):
    try:
        return ("ok", fn())
    except (PL.JpegLLError, PS.JpegLSError) as e:
        return (type(e).__name__, str(e))


def _same_outcome(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] != "ok":
        assert a == b
    elif isinstance(a[1], tuple):            # (plane, end)
        _same_array(a[1][0], b[1][0])
        assert a[1][1] == b[1][1]
    else:
        for x, y in zip(a[1], b[1]):
            _same_array(x, y)


def test_jpegll_host_decode_equals_python_on_random_segments():
    rng = np.random.default_rng(12)
    tab = _ll_table()
    seg = PL.encode(_img(seed=8, shape=(24, 24)), precision=12)
    scan = seg[seg.find(b"\xff\xda") + 10:-2].replace(b"\xff\x00", b"\xff")
    cases = [(scan, 24 * 24), (scan[:len(scan) // 2], 24 * 24), (b"", 1),
             (scan, 0)]
    cases += [(rng.integers(0, 256, int(rng.integers(0, 300))).astype(
        np.uint8).tobytes(), int(rng.integers(1, 500))) for _ in range(40)]
    outcomes = {"ok": 0}
    for data, count in cases:
        nat = _outcome(lambda: PL._scan_diffs(data, [tab], 1, count))
        py = _outcome(lambda: PL._scan_diffs_py(data, [tab], count))
        _same_outcome(nat, py)
        outcomes[nat[0]] = outcomes.get(nat[0], 0) + 1
    assert outcomes["ok"] >= 2 and outcomes.get("JpegLLError", 0) >= 10


def test_jpegll_host_pack_equals_python(monkeypatch):
    rng = np.random.default_rng(5)
    for trial in range(15):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        prec = int(rng.integers(2, 17))
        im = rng.integers(0, 1 << prec, (h, w)).astype(np.uint16)
        kw = dict(precision=prec, predictor=int(rng.integers(1, 8)),
                  restart_rows=int(rng.integers(0, 3)))
        native.reset_calls()
        e_native = PL.encode(im, **kw)
        assert native.CALLS["jpegll_pack"] > 0
        with monkeypatch.context() as mp:
            mp.setattr(PL, "_pack_segment", PL._pack_segment_py)
            assert PL.encode(im, **kw) == e_native, f"trial {trial}"


@pytest.mark.parametrize("near", [0, 2])
def test_jpegls_host_coder_equals_python(near):
    rng = np.random.default_rng(near)
    for trial in range(30):
        p = int(rng.integers(2, 17))
        maxv = (1 << p) - 1
        if near > maxv // 2:
            continue
        h, w = int(rng.integers(1, 24)), int(rng.integers(1, 24))
        img = rng.integers(0, maxv + 1, (h, w)).astype(np.int64)
        if trial % 2:
            img[h // 2:] = img[h // 2, 0]
        params = _params(PS, maxv, near)
        py_bytes = PS._encode_scan_python(img, params)
        assert native.jpegls_encode(img, params) == py_bytes
        buf = py_bytes + b"\xff\xd9"
        for cut in (buf, buf[:len(buf) // 2], buf[:len(buf) // 3] + b"\xff\xd9"):
            _same_outcome(
                _outcome(lambda: native.jpegls_decode(cut, 0, w, h, params)),
                _outcome(lambda: PS._decode_scan_python(cut, 0, w, h,
                                                        params)))


def test_jpegls_host_decode_equals_python_on_random_bytes():
    rng = np.random.default_rng(21)
    kinds = set()
    for trial in range(60):
        p = int(rng.integers(2, 17))
        params = _params(PS, (1 << p) - 1, 0)
        h, w = int(rng.integers(1, 12)), int(rng.integers(1, 12))
        data = rng.integers(0, 256, int(rng.integers(0, 80))).astype(
            np.uint8).tobytes()
        nat = _outcome(lambda: native.jpegls_decode(data, 0, w, h, params))
        py = _outcome(lambda: PS._decode_scan_python(data, 0, w, h, params))
        _same_outcome(nat, py)
        kinds.add(nat[1] if nat[0] != "ok" else "ok")
    assert len(kinds) >= 3, kinds


def test_host_wrappers_check_their_inputs():
    params = _params(PS, 255, 0)
    with pytest.raises(PS.JpegLSError, match="plane"):
        native.jpegls_decode(b"\x00" * 8, 0, 0, 4, params)
    with pytest.raises(ValueError, match="offset"):
        native.jpegls_decode(b"\x00" * 8, 9, 4, 4, params)
    with pytest.raises(ValueError, match="code counts"):
        native.jpegll_diffs(b"\x00", np.zeros(15), np.zeros(0), 4)
    with pytest.raises(ValueError, match="categories"):
        native.jpegll_pack(np.array([17]), np.array([0]), np.zeros(18),
                           np.ones(18))


# -------------------------------------------------------- the host library --


def test_library_builds_under_its_hash():
    native.load()
    lib = native.library_path()
    assert lib.parent == ROOT / "build" / "mdx_torch_host"
    assert re.fullmatch(r"libmdx_torch_host_[0-9a-f]{16}\.so", lib.name)
    assert lib.exists() and native.BUILD["path"] == str(lib)
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not any(f.startswith("-march") or "openmp" in f
                   for f in native.CXX_FLAGS)


def test_second_process_reuses_the_library():
    native.load()
    lib = native.library_path()
    before = lib.stat()
    env = {k: v for k, v in os.environ.items() if k != "MDX_NO_NATIVE"}
    r = subprocess.run(
        [sys.executable, "-c", "from mdx_torch.io import native; "
         "native.load(); print(native.BUILD)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "'seconds': None" in r.stdout and str(lib) in r.stdout
    after = lib.stat()
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)


def test_a_late_concurrent_build_keeps_the_installed_library(tmp_path,
                                                              monkeypatch):
    """A build that compiled while another process installed the library
    (it saw no library when it started) leaves the installed file in place:
    a process that loaded it keeps the same file, and no temporary is
    left."""
    src = tmp_path / "codecs.cpp"
    shutil.copy(native.SOURCE, src)
    first = native.build(src, tmp_path / "b")
    lib = Path(first["path"])
    before = lib.stat()
    real = type(lib).exists
    monkeypatch.setattr(type(lib), "exists",
                        lambda self: False if self == lib else real(self))
    late = native.build(src, tmp_path / "b")
    assert late["seconds"] is not None and late["path"] == str(lib)
    after = lib.stat()
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [lib.name]


def test_build_names_by_source_and_reuses(tmp_path):
    src = tmp_path / "codecs.cpp"
    shutil.copy(native.SOURCE, src)
    first = native.build(src, tmp_path / "b")
    assert first["seconds"] is not None and first["compiler"]
    assert first["version"] and Path(first["path"]).exists()
    assert native.build(src, tmp_path / "b") == {
        "compiler": None, "version": None, "seconds": None,
        "path": first["path"]}
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.library_path(src, tmp_path / "b") != Path(first["path"])
    assert [p.name for p in (tmp_path / "b").iterdir()] == [
        Path(first["path"]).name]


def test_uncompilable_source_raises_with_the_compiler_text(tmp_path):
    src = tmp_path / "codecs.cpp"
    src.write_text(native.SOURCE.read_text()
                   + "\n#error broken on purpose\n")
    with pytest.raises(native.NativeBuildError,
                       match="(?s)failed.*broken on purpose"):
        native.build(src, tmp_path / "b")
    assert list((tmp_path / "b").iterdir()) == []


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match="no host C\\+\\+"):
        native.build(native.SOURCE, tmp_path)


def test_concurrent_builds_leave_one_library(tmp_path):
    src = tmp_path / "codecs.cpp"
    shutil.copy(native.SOURCE, src)
    got, errs = [], []

    def one():
        try:
            got.append(native.build(src, tmp_path / "b")["path"])
        except Exception as e:       # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs and len(set(got)) == 1 and len(got) == 4
    assert [p.name for p in (tmp_path / "b").iterdir()] == [Path(got[0]).name]
    import ctypes

    ctypes.CDLL(got[0]).mdx_torch_io_jpegll_pack   # loads and binds


def test_calls_count_each_entry_point():
    img = _img(seed=4, shape=(20, 16))
    native.reset_calls()
    ll = PL.encode(img, precision=12, restart_rows=6)   # 4 intervals
    ls = PS.encode(img, precision=12, restart_rows=8)   # 3 intervals
    # the other codecs' entry points (test_torch_jpeg2k, _jpegdct,
    # _transcode count them)
    rest = {"jpeg2k_t1_block": 0, "jpeg2k_t1_encode": 0,
            "jpegdct_segment": 0, "jpegdct_prog_segment": 0,
            "packbits_decode": 0, "packbits_encode": 0}
    assert native.CALLS == {"jpegll_diffs": 0, "jpegll_pack": 4,
                            "jpegls_decode": 0, "jpegls_encode": 3, **rest}
    PL.decode(ll)
    PS.decode(ls)
    assert native.CALLS == {"jpegll_diffs": 4, "jpegll_pack": 4,
                            "jpegls_decode": 3, "jpegls_encode": 3, **rest}
    native.reset_calls()
    assert set(native.CALLS.values()) == {0}


def test_no_native_runs_the_python_bodies(monkeypatch):
    img = _img(seed=6, shape=(24, 20))
    ll, ls = PL.encode(img, precision=12), PS.encode(img, precision=12,
                                                     near=1)
    want_ll, want_ls = PL.decode(ll)[0], PS.decode(ls)[0]
    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    native.reset_calls()
    assert PL.encode(img, precision=12) == ll
    assert PS.encode(img, precision=12, near=1) == ls
    _same_array(PL.decode(ll)[0], want_ll)
    _same_array(PS.decode(ls)[0], want_ls)
    assert set(native.CALLS.values()) == {0}


def test_threads_share_the_library_and_lose_no_count():
    """More threads than cores decode at once with a short switch
    interval: every result right, every call counted."""
    imgs = [_img(seed=s, shape=(16, 24)) for s in range(4)]
    ll = [PL.encode(i, precision=12, restart_rows=4) for i in imgs]
    ls = [PS.encode(i, precision=12, restart_rows=4) for i in imgs]
    n_threads, reps = 2 * min(os.cpu_count() or 4, 16), 3
    errs = []

    def work():
        try:
            for _ in range(reps):
                for k in range(4):
                    assert np.array_equal(PL.decode(ll[k])[0], imgs[k])
                    assert np.array_equal(PS.decode(ls[k])[0], imgs[k])
        except Exception as e:       # noqa: BLE001 - reported below
            errs.append(e)

    native.reset_calls()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs[:3]
    calls = n_threads * reps * 4 * 4          # 4 streams of 4 intervals
    assert native.CALLS["jpegll_diffs"] == calls
    assert native.CALLS["jpegls_decode"] == calls
