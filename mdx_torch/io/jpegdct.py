"""Baseline / Extended sequential JPEG (ITU-T T.81) decoder for DICOM.

The port's copy of ``mdx/io/jpegdct.py``; CPU tests hold its decode
bit-equal to the original's, with the same errors.  Covers the two lossy
DCT transfer syntaxes:

* JPEG Baseline (Process 1), 8-bit          1.2.840.10008.1.2.4.50
* JPEG Extended (Process 2 & 4), 12-bit     1.2.840.10008.1.2.4.51

`.4.50` is the dominant syntax in ultrasound and secondary-capture
archives.  Decode-only, as in the JAX package: writing lossy codestreams
of medical images is deliberately unsupported.

Implemented from the standard:

* Marker layer: SOI / SOF0 / SOF1 / SOF2 / DHT / DQT / DRI / SOS /
  RSTn / EOI, APPn + COM skipped.  Arithmetic-coded SOFs and
  hierarchical processes raise specific errors rather than wrong pixels.
* Annex F.2.2.3 canonical Huffman decoding (mincode/maxcode/valptr), DC
  category + EXTEND, AC run/size with ZRL and EOB, byte destuffing
  (FF 00) per F.1.2.3.
* Interleaved MCUs with sampling factors Hi/Vi ∈ {1, 2} (4:4:4, 4:2:2,
  4:2:0: everything DICOM emits); restart intervals with modulo-8
  marker sequence check; single- and multi-scan (non-interleaved)
  frames.
* Progressive (SOF2, Annex G Huffman): spectral-selection DC/AC scans,
  successive-approximation first + refinement passes with EOB runs;
  the control flow follows libjpeg's jdphuff, so refinement matches the
  ecosystem bit for bit.  A conformance extension: DICOM specifies
  sequential processes for `.4.50`/`.4.51`, but web re-exports carry
  progressive streams into archives.
* Dequantisation + inverse zigzag + 8×8 IDCT over all blocks at once
  (the separable DCT-III basis as one float64 einsum, the JAX package's
  expression on the same basis, so the pixels are the same); level shift
  2^(P−1), clamp to [0, 2^P−1].
* Chroma upsampling: libjpeg's "fancy" triangle filter; the DICOM layer
  keeps YBR samples as stored and takes the Y plane for the grayscale QA
  path.

The serial entropy pass of each restart segment runs in the port's host
C++ loops (:mod:`mdx_torch.io.native`: ``jpegdct_segment``,
``jpegdct_prog_segment``); the Python loops here
(``_decode_segment_py``, ``_decode_prog_segment_py``) are their plain
versions, taken only under ``MDX_NO_NATIVE=1``.  A host library that does
not build raises :class:`mdx_torch.io.native.NativeBuildError`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mdx_torch.io import native as _native

__all__ = ["JpegDctError", "decode"]


class JpegDctError(ValueError):
    """Malformed or unsupported JPEG (DCT process) stream."""


_SOI, _EOI = 0xD8, 0xD9
_SOF0, _SOF1 = 0xC0, 0xC1
_DHT, _DQT, _DRI, _SOS, _COM = 0xC4, 0xDB, 0xDD, 0xDA, 0xFE
_RST0 = 0xD0
_SOF2 = 0xC2
_UNSUPPORTED_SOF = {
    0xC3: "lossless (SOF3) — use mdx_torch.io.jpegll",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic sequential (SOF9)",
    0xCA: "arithmetic progressive (SOF10)",
    0xCB: "arithmetic lossless (SOF11)",
    0xCD: "differential arithmetic (SOF13)",
    0xCE: "differential arithmetic (SOF14)",
    0xCF: "differential arithmetic (SOF15)",
    0xF7: "JPEG-LS (SOF55) — use mdx_torch.io.jpegls",
}

# Zigzag order: _ZIGZAG[k] = raster index of the k-th zigzag coefficient.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# Separable IDCT basis: C[u, x] = c(u)/2 · cos((2x+1)uπ/16).
_IDCT_C = np.empty((8, 8), np.float64)
for _u in range(8):
    _cu = (1.0 / np.sqrt(2.0)) if _u == 0 else 1.0
    for _x in range(8):
        _IDCT_C[_u, _x] = 0.5 * _cu * np.cos((2 * _x + 1) * _u * np.pi / 16)


@dataclass
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    td: int = 0
    ta: int = 0


class _Huff:
    """Canonical Huffman decoder tables (T.81 F.2.2.3)."""

    __slots__ = ("mincode", "maxcode", "valptr", "values")

    def __init__(self, counts: bytes, values: bytes):
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        self.values = values
        code = 0
        k = 0
        for length in range(1, 17):
            c = counts[length - 1]
            if c:
                self.valptr[length] = k
                self.mincode[length] = code
                code += c
                self.maxcode[length] = code - 1
                k += c
            code <<= 1
        if k != len(values):
            raise JpegDctError("DHT count/value mismatch.")


class _BitReader:
    """MSB-first bit reader over destuffed scan bytes."""

    __slots__ = ("buf", "pos", "cache", "nbits")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.cache = 0
        self.nbits = 0

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.buf):
                raise JpegDctError("Truncated JPEG entropy segment.")
            self.cache = self.buf[self.pos]
            self.pos += 1
            self.nbits = 8
        self.nbits -= 1
        return (self.cache >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def decode_symbol(self, h: _Huff) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.read_bit()
            if h.maxcode[length] >= code:
                return h.values[h.valptr[length] + code - h.mincode[length]]
        raise JpegDctError("Invalid Huffman code in scan data.")


def _extend(v: int, t: int) -> int:
    """T.81 F.2.2.1 EXTEND: map t low bits to the signed value."""
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def _u16(buf: bytes, pos: int) -> int:
    if pos + 2 > len(buf):
        raise JpegDctError("Truncated JPEG stream.")
    return struct.unpack_from(">H", buf, pos)[0]


def _seg_len(buf: bytes, pos: int) -> int:
    """Marker segment length, bounds-checked against the buffer."""
    length = _u16(buf, pos)
    if length < 2 or pos + length > len(buf):
        raise JpegDctError("Truncated JPEG marker segment.")
    return length


def _destuff(buf: bytes, pos: int) -> Tuple[bytes, int]:
    """Collect entropy bytes from ``pos`` to the next marker, removing
    FF 00 stuffing.  Returns (bytes, offset_of_marker)."""
    out = bytearray()
    n = len(buf)
    while pos < n:
        b = buf[pos]
        if b != 0xFF:
            out.append(b)
            pos += 1
            continue
        if pos + 1 >= n:
            break
        nxt = buf[pos + 1]
        if nxt == 0x00:
            out.append(0xFF)
            pos += 2
        elif nxt == 0xFF:
            pos += 1  # fill byte
        else:
            break  # a real marker
    return bytes(out), pos


def decode(stream: bytes) -> Tuple[np.ndarray, int]:
    """Decode one baseline/extended-sequential JPEG codestream.

    Returns ``(image, precision)`` — ``[H, W]`` for one component or
    ``[H, W, C]`` (components upsampled to full resolution, in frame
    order — YCbCr stays YCbCr; color-space handling is the caller's).
    dtype uint8 (P=8) or uint16 (P=12).
    """
    buf = bytes(stream)
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != _SOI:
        raise JpegDctError("Not a JPEG stream (missing SOI).")
    pos = 2
    precision = 0
    progressive = False
    height = width = 0
    comps: List[_Component] = []
    qtables: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, _Huff] = {}
    ac_tabs: Dict[int, _Huff] = {}
    restart_interval = 0
    coeffs: Dict[int, np.ndarray] = {}  # cid -> [by, bx, 64] zigzag coeffs
    hmax = vmax = 1

    while True:
        if pos + 2 > len(buf):
            raise JpegDctError("Truncated JPEG stream (no EOI).")
        if buf[pos] != 0xFF:
            raise JpegDctError(f"Expected marker at offset {pos}.")
        marker = buf[pos + 1]
        pos += 2
        if marker == _EOI:
            break
        if marker == 0xFF:
            pos -= 1
            continue
        if marker in _UNSUPPORTED_SOF:
            raise JpegDctError(
                f"Unsupported JPEG process: {_UNSUPPORTED_SOF[marker]}.")
        if marker in (_SOF0, _SOF1, _SOF2):
            length = _seg_len(buf, pos)
            progressive = marker == _SOF2
            precision = buf[pos + 2]
            height = _u16(buf, pos + 3)
            width = _u16(buf, pos + 5)
            nf = buf[pos + 7]
            if marker == _SOF0 and precision != 8:
                raise JpegDctError(
                    f"Baseline JPEG requires P=8 (got {precision}).")
            if precision not in (8, 12):
                raise JpegDctError(
                    f"JPEG precision {precision} unsupported (8/12).")
            if height == 0:
                raise JpegDctError("DNL-deferred height unsupported.")
            if not (1 <= nf <= 4) or length != 8 + 3 * nf:
                raise JpegDctError("Malformed SOF segment.")
            for c in range(nf):
                cid = buf[pos + 8 + 3 * c]
                hv = buf[pos + 9 + 3 * c]
                h, v = hv >> 4, hv & 0x0F
                if h not in (1, 2) or v not in (1, 2):
                    raise JpegDctError(
                        f"Sampling factors {h}x{v} unsupported "
                        "(DICOM uses 1 or 2).")
                comps.append(_Component(cid, h, v, buf[pos + 10 + 3 * c]))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            pos += length
            continue
        if marker == _DQT:
            length = _seg_len(buf, pos)
            end = pos + length
            p2 = pos + 2
            while p2 < end:
                pq, tq = buf[p2] >> 4, buf[p2] & 0x0F
                p2 += 1
                if pq == 0:
                    q = np.frombuffer(buf, np.uint8, 64, p2).astype(
                        np.int32)
                    p2 += 64
                elif pq == 1:
                    q = np.frombuffer(buf, ">u2", 64, p2).astype(np.int32)
                    p2 += 128
                else:
                    raise JpegDctError(f"Bad DQT precision {pq}.")
                qtables[tq] = q  # zigzag order
            pos += length
            continue
        if marker == _DHT:
            length = _seg_len(buf, pos)
            end = pos + length
            p2 = pos + 2
            while p2 < end:
                tc, th = buf[p2] >> 4, buf[p2] & 0x0F
                counts = buf[p2 + 1:p2 + 17]
                nv = sum(counts)
                values = buf[p2 + 17:p2 + 17 + nv]
                if len(values) < nv:
                    raise JpegDctError("Truncated DHT segment.")
                tab = _Huff(counts, values)
                if tc == 0:
                    dc_tabs[th] = tab
                elif tc == 1:
                    ac_tabs[th] = tab
                else:
                    raise JpegDctError(f"Bad DHT class {tc}.")
                p2 += 17 + nv
            pos += length
            continue
        if marker == _DRI:
            length = _seg_len(buf, pos)
            restart_interval = _u16(buf, pos + 2)
            pos += length
            continue
        if marker == _SOS:
            if not comps:
                raise JpegDctError("SOS before SOF.")
            length = _seg_len(buf, pos)
            ns = buf[pos + 2]
            if length != 6 + 2 * ns or not (1 <= ns <= len(comps)):
                raise JpegDctError("Malformed SOS segment.")
            scan_comps = []
            for j in range(ns):
                cs = buf[pos + 3 + 2 * j]
                tdta = buf[pos + 4 + 2 * j]
                comp = next((c for c in comps if c.cid == cs), None)
                if comp is None:
                    raise JpegDctError(f"SOS names unknown component {cs}.")
                comp.td, comp.ta = tdta >> 4, tdta & 0x0F
                scan_comps.append(comp)
            ss, se = buf[pos + 3 + 2 * ns], buf[pos + 4 + 2 * ns]
            ahl = buf[pos + 5 + 2 * ns]
            ah, al = ahl >> 4, ahl & 0x0F
            pos += length
            if progressive:
                if ss == 0 and se == 0:
                    pass                      # DC scan (may interleave)
                elif 1 <= ss <= se <= 63 and ns == 1:
                    pass                      # AC scan (single component)
                else:
                    raise JpegDctError(
                        "Invalid progressive spectral selection.")
                pos = _decode_scan_prog(buf, pos, scan_comps, dc_tabs,
                                        ac_tabs, width, height, hmax,
                                        vmax, restart_interval, coeffs,
                                        ss, se, ah, al)
            else:
                if (ss, se, ah, al) != (0, 63, 0, 0):
                    raise JpegDctError(
                        "Sequential scan with progressive parameters.")
                pos = _decode_scan(buf, pos, scan_comps, dc_tabs, ac_tabs,
                                   width, height, hmax, vmax,
                                   restart_interval, coeffs)
            continue
        if 0xD0 <= marker <= 0xD7:
            raise JpegDctError("Restart marker outside an entropy segment.")
        if marker == _COM or 0xE0 <= marker <= 0xEF or marker == 0xDC:
            length = _seg_len(buf, pos)
            pos += length
            continue
        raise JpegDctError(f"Unexpected marker 0xFF{marker:02X}.")

    if not comps or not coeffs:
        raise JpegDctError("JPEG stream contains no image scan.")
    for c in comps:
        if c.cid not in coeffs:
            raise JpegDctError(f"Component {c.cid} has no scan data.")
        if c.tq not in qtables:
            raise JpegDctError(f"Missing quantisation table {c.tq}.")

    planes = []
    for c in comps:
        plane = _reconstruct(coeffs[c.cid], qtables[c.tq], precision)
        # crop to the component's true extent, then upsample to frame size
        cw = -(-width * c.h // hmax)
        ch = -(-height * c.v // vmax)
        plane = plane[:ch, :cw]
        if c.v != vmax:
            plane = _upsample2x(plane, axis=0)
        if c.h != hmax:
            plane = _upsample2x(plane, axis=1)
        planes.append(plane[:height, :width])
    dtype = np.uint8 if precision == 8 else np.uint16
    if len(planes) == 1:
        return planes[0].astype(dtype), precision
    return np.stack(planes, axis=-1).astype(dtype), precision


def _decode_scan(buf: bytes, pos: int, scan_comps: List[_Component],
                 dc_tabs: Dict[int, _Huff], ac_tabs: Dict[int, _Huff],
                 width: int, height: int, hmax: int, vmax: int,
                 restart_interval: int,
                 coeffs: Dict[int, np.ndarray]) -> int:
    """One scan's entropy data → zigzag coefficient arrays per component.
    Returns the offset just past the scan (at the next marker)."""
    interleaved = len(scan_comps) > 1
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    # per-component block grid for THIS scan
    grids = {}
    for c in scan_comps:
        if interleaved:
            bx, by = mcus_x * c.h, mcus_y * c.v
        else:
            cw = -(-width * c.h // hmax)
            ch = -(-height * c.v // vmax)
            bx, by = -(-cw // 8), -(-ch // 8)
        grids[c.cid] = (by, bx)
        if c.cid in coeffs:
            # T.81 sequential modes give each component exactly one scan;
            # a duplicate would also desync the host loop's row stride
            # (it indexes by this scan's grid, not the allocation)
            raise JpegDctError(
                f"Component {c.cid} appears in more than one scan.")
        coeffs[c.cid] = np.zeros((by, bx, 64), np.int32)
    if interleaved:
        mcus = mcus_y * mcus_x
    else:
        c = scan_comps[0]
        by, bx = grids[c.cid]
        mcus = by * bx

    for c in scan_comps:
        if c.td not in dc_tabs or c.ta not in ac_tabs:
            raise JpegDctError(
                f"Scan uses undefined Huffman table (DC {c.td}/AC {c.ta}).")

    # per-restart-interval segments: full coder reset each, so every
    # destuffed segment decodes independently (host loop or Python)
    mcu0 = 0
    expect_rst = 0
    while mcu0 < mcus:
        cnt = min(restart_interval, mcus - mcu0) if restart_interval \
            else mcus - mcu0
        seg, pos = _destuff(buf, pos)
        _decode_segment(seg, scan_comps, dc_tabs, ac_tabs, grids, coeffs,
                        mcu0, cnt, interleaved, mcus_x)
        mcu0 += cnt
        if mcu0 < mcus:
            if pos + 2 > len(buf) or buf[pos] != 0xFF or \
                    not (0xD0 <= buf[pos + 1] <= 0xD7):
                raise JpegDctError("Missing restart marker.")
            if buf[pos + 1] - _RST0 != expect_rst:
                raise JpegDctError("Restart marker out of sequence.")
            expect_rst = (expect_rst + 1) & 7
            pos += 2
    return pos


def _decode_segment(seg: bytes, scan_comps: List[_Component],
                    dc_tabs: Dict[int, _Huff], ac_tabs: Dict[int, _Huff],
                    grids: Dict[int, Tuple[int, int]],
                    coeffs: Dict[int, np.ndarray], mcu0: int, cnt: int,
                    interleaved: bool, mcus_x: int) -> None:
    if not _native.disabled():
        _native.jpegdct_segment(seg, scan_comps, dc_tabs, ac_tabs, grids,
                                coeffs, mcu0, cnt, interleaved, mcus_x)
        return
    _decode_segment_py(seg, scan_comps, dc_tabs, ac_tabs, grids, coeffs,
                       mcu0, cnt, interleaved, mcus_x)


def _decode_segment_py(seg: bytes, scan_comps: List[_Component],
                       dc_tabs: Dict[int, _Huff],
                       ac_tabs: Dict[int, _Huff],
                       grids: Dict[int, Tuple[int, int]],
                       coeffs: Dict[int, np.ndarray], mcu0: int, cnt: int,
                       interleaved: bool, mcus_x: int) -> None:
    """The plain version of the host loop ``native.jpegdct_segment``."""
    br = _BitReader(seg)
    pred = {c.cid: 0 for c in scan_comps}

    def _one_block(c: _Component, row: int, col: int) -> None:
        blk = coeffs[c.cid][row, col]
        t = br.decode_symbol(dc_tabs[c.td])
        if t > 15:
            raise JpegDctError("Invalid DC category.")
        diff = _extend(br.read_bits(t), t) if t else 0
        pred[c.cid] += diff
        blk[0] = pred[c.cid]
        k = 1
        while k < 64:
            rs = br.decode_symbol(ac_tabs[c.ta])
            r, s = rs >> 4, rs & 0x0F
            if s == 0:
                if r == 15:
                    k += 16  # ZRL
                    continue
                break  # EOB
            k += r
            if k > 63:
                raise JpegDctError("AC run overflows the block.")
            blk[k] = _extend(br.read_bits(s), s)
            k += 1

    for m in range(mcu0, mcu0 + cnt):
        if interleaved:
            my, mx = divmod(m, mcus_x)
            for c in scan_comps:
                for dv in range(c.v):
                    for dh in range(c.h):
                        _one_block(c, my * c.v + dv, mx * c.h + dh)
        else:
            c = scan_comps[0]
            row, col = divmod(m, grids[c.cid][1])
            _one_block(c, row, col)


def _decode_scan_prog(buf: bytes, pos: int, scan_comps: List[_Component],
                      dc_tabs: Dict[int, _Huff],
                      ac_tabs: Dict[int, _Huff], width: int, height: int,
                      hmax: int, vmax: int, restart_interval: int,
                      coeffs: Dict[int, np.ndarray], ss: int, se: int,
                      ah: int, al: int) -> int:
    """One progressive scan (T.81 Annex G, Huffman).  Coefficients
    accumulate across scans in ``coeffs``; control flow mirrors the
    de-facto reference decoder (libjpeg jdphuff.c) so successive-
    approximation refinement matches the ecosystem bit-for-bit.
    """
    dc_scan = ss == 0
    interleaved = dc_scan and len(scan_comps) > 1
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    grids = {}
    for c in scan_comps:
        if interleaved:
            bx, by = mcus_x * c.h, mcus_y * c.v
        else:
            cw = -(-width * c.h // hmax)
            ch = -(-height * c.v // vmax)
            bx, by = -(-cw // 8), -(-ch // 8)
        grids[c.cid] = (by, bx)
        if c.cid not in coeffs:
            # allocate at the FULL interleaved grid — the superset of
            # every legal scan grid for this component — so a later scan
            # with a wider grid (e.g. non-interleaved DC first, then an
            # interleaved DC refinement) can never index past the
            # allocation; decoders index rows by the allocation stride
            coeffs[c.cid] = np.zeros(
                (mcus_y * c.v, mcus_x * c.h, 64), np.int32)
        elif coeffs[c.cid].shape[0] < by or coeffs[c.cid].shape[1] < bx:
            # unreachable given full-grid allocation; guards the
            # invariant if allocation policy ever changes
            raise JpegDctError(
                f"Scan grid {by}x{bx} for component {c.cid} exceeds its "
                f"allocated coefficient grid "
                f"{coeffs[c.cid].shape[0]}x{coeffs[c.cid].shape[1]}.")
    if interleaved:
        mcus = mcus_y * mcus_x
    else:
        by, bx = grids[scan_comps[0].cid]
        mcus = by * bx

    if dc_scan and ah == 0:
        for c in scan_comps:
            if c.td not in dc_tabs:
                raise JpegDctError(
                    f"Progressive DC scan uses undefined table {c.td}.")
    if not dc_scan and ah == 0 or (not dc_scan and ah > 0):
        c = scan_comps[0]
        if c.ta not in ac_tabs:
            raise JpegDctError(
                f"Progressive AC scan uses undefined table {c.ta}.")

    mcu0 = 0
    expect_rst = 0
    while mcu0 < mcus:
        cnt = min(restart_interval, mcus - mcu0) if restart_interval \
            else mcus - mcu0
        seg, pos = _destuff(buf, pos)
        _decode_prog_segment(seg, scan_comps, dc_tabs, ac_tabs, grids,
                             coeffs, mcu0, cnt, interleaved, mcus_x,
                             ss, se, ah, al, dc_scan)
        mcu0 += cnt
        if mcu0 < mcus:
            if pos + 2 > len(buf) or buf[pos] != 0xFF or \
                    not (0xD0 <= buf[pos + 1] <= 0xD7):
                raise JpegDctError("Missing restart marker.")
            if buf[pos + 1] - _RST0 != expect_rst:
                raise JpegDctError("Restart marker out of sequence.")
            expect_rst = (expect_rst + 1) & 7
            pos += 2
    return pos


def _decode_prog_segment(seg: bytes, scan_comps: List[_Component],
                         dc_tabs: Dict[int, _Huff],
                         ac_tabs: Dict[int, _Huff],
                         grids: Dict[int, Tuple[int, int]],
                         coeffs: Dict[int, np.ndarray], mcu0: int,
                         cnt: int, interleaved: bool, mcus_x: int,
                         ss: int, se: int, ah: int, al: int,
                         dc_scan: bool) -> None:
    if not _native.disabled():
        _native.jpegdct_prog_segment(seg, scan_comps, dc_tabs, ac_tabs,
                                     grids, coeffs, mcu0, cnt, interleaved,
                                     mcus_x, ss, se, ah, al, dc_scan)
        return
    _decode_prog_segment_py(seg, scan_comps, dc_tabs, ac_tabs, grids,
                            coeffs, mcu0, cnt, interleaved, mcus_x,
                            ss, se, ah, al, dc_scan)


def _decode_prog_segment_py(seg: bytes, scan_comps: List[_Component],
                            dc_tabs: Dict[int, _Huff],
                            ac_tabs: Dict[int, _Huff],
                            grids: Dict[int, Tuple[int, int]],
                            coeffs: Dict[int, np.ndarray], mcu0: int,
                            cnt: int, interleaved: bool, mcus_x: int,
                            ss: int, se: int, ah: int, al: int,
                            dc_scan: bool) -> None:
    """The plain version of the host loop
    ``native.jpegdct_prog_segment``."""
    br = _BitReader(seg)
    pred = {c.cid: 0 for c in scan_comps}
    eobrun = 0
    p1 = 1 << al
    m1 = -1 << al

    def _dc_first(c: _Component, blk: np.ndarray) -> None:
        t = br.decode_symbol(dc_tabs[c.td])
        if t > 15:
            raise JpegDctError("Invalid DC category.")
        diff = _extend(br.read_bits(t), t) if t else 0
        pred[c.cid] += diff
        blk[0] = pred[c.cid] << al

    def _dc_refine(blk: np.ndarray) -> None:
        # (v>>1<<1) | bit == v in two's complement for either sign
        if br.read_bit():
            blk[0] = int(blk[0]) | p1

    def _ac_first(c: _Component, blk: np.ndarray) -> None:
        nonlocal eobrun
        if eobrun > 0:
            eobrun -= 1
            return
        k = ss
        while k <= se:
            rs = br.decode_symbol(ac_tabs[c.ta])
            r, s = rs >> 4, rs & 0x0F
            if s:
                k += r
                if k > se:
                    raise JpegDctError("AC run overflows the band.")
                blk[k] = _extend(br.read_bits(s), s) << al
                k += 1
            else:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.read_bits(r)
                    eobrun -= 1  # this block ends here
                    return
                k += 16  # ZRL

    def _ac_refine(c: _Component, blk: np.ndarray) -> None:
        nonlocal eobrun
        k = ss
        if eobrun == 0:
            while k <= se:
                rs = br.decode_symbol(ac_tabs[c.ta])
                r, s = rs >> 4, rs & 0x0F
                if s == 0:
                    if r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += br.read_bits(r)
                        break
                    # ZRL: r == 15, skip 15 zero-history coefficients
                else:
                    if s != 1:
                        raise JpegDctError(
                            "Invalid refinement magnitude (s != 1).")
                    s = p1 if br.read_bit() else m1
                # advance over r zero-history coeffs, consuming
                # correction bits for the nonzero-history ones
                while k <= se:
                    coef = int(blk[k])
                    if coef != 0:
                        if br.read_bit() and (coef & p1) == 0:
                            blk[k] = coef + (p1 if coef >= 0 else m1)
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s:
                    if k > se:
                        raise JpegDctError(
                            "Refinement coefficient outside the band.")
                    blk[k] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                coef = int(blk[k])
                if coef != 0 and br.read_bit() and (coef & p1) == 0:
                    blk[k] = coef + (p1 if coef >= 0 else m1)
                k += 1
            eobrun -= 1

    for m in range(mcu0, mcu0 + cnt):
        if interleaved:
            my, mx = divmod(m, mcus_x)
            for c in scan_comps:
                for dv in range(c.v):
                    for dh in range(c.h):
                        blk = coeffs[c.cid][my * c.v + dv, mx * c.h + dh]
                        _dc_first(c, blk) if ah == 0 else _dc_refine(blk)
        else:
            c = scan_comps[0]
            row, col = divmod(m, grids[c.cid][1])
            blk = coeffs[c.cid][row, col]
            if dc_scan:
                _dc_first(c, blk) if ah == 0 else _dc_refine(blk)
            elif ah == 0:
                _ac_first(c, blk)
            else:
                _ac_refine(c, blk)


def _upsample2x(plane: np.ndarray, axis: int) -> np.ndarray:
    """2× triangle-filter upsampling along ``axis`` (the de-facto
    standard "fancy upsampling" of libjpeg, jdsample.c): each output
    sample is (3·nearer + farther + rounding) / 4, edges replicated.
    T.81 mandates no filter; matching libjpeg keeps decoded chroma
    within ~±2 of the ecosystem's decoders."""
    p = np.moveaxis(plane, axis, 0).astype(np.int64)
    prev = np.concatenate([p[:1], p[:-1]], axis=0)
    nxt = np.concatenate([p[1:], p[-1:]], axis=0)
    even = (3 * p + prev + 1) >> 2
    odd = (3 * p + nxt + 2) >> 2
    out = np.stack([even, odd], axis=1).reshape((-1,) + p.shape[1:])
    return np.moveaxis(out, 0, axis)


def _reconstruct(zz: np.ndarray, qtab_zz: np.ndarray,
                 precision: int) -> np.ndarray:
    """Dequantise + inverse zigzag + IDCT for ALL blocks at once."""
    by, bx, _ = zz.shape
    deq = zz.astype(np.float64) * qtab_zz[None, None, :]
    blocks = np.zeros((by, bx, 64), np.float64)
    blocks[:, :, _ZIGZAG] = deq
    blocks = blocks.reshape(by, bx, 8, 8)
    # separable IDCT: out[x, y] = Σ_u Σ_v C[u,x]·B[u,v]·C[v,y]
    spatial = np.einsum("ux,ijuv,vy->ijxy", _IDCT_C, blocks, _IDCT_C,
                        optimize=True)
    level = 1 << (precision - 1)
    maxv = (1 << precision) - 1
    spatial = np.clip(np.round(spatial + level), 0, maxv)
    # tile the block grid into a plane
    return spatial.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
