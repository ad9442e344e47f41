"""JPEG Lossless (ITU-T T.81 process 14) codec for DICOM pixel data.

The port's copy of ``mdx/io/jpegll.py``; CPU tests hold its decode bit-equal
and its encode byte-equal to the original's, with the same errors.  Covers
the two lossless JPEG transfer syntaxes:

* JPEG Lossless, Non-Hierarchical (Process 14)        1.2.840.10008.1.2.4.57
* JPEG Lossless, First-Order Prediction (14, SV1)     1.2.840.10008.1.2.4.70

Implemented from the standard (ITU-T T.81):

* Annex B marker syntax: SOI / SOF3 / DHT / DRI / SOS / RSTn / EOI,
  APPn/COM skipped.
* Annex F.2.2.3 canonical Huffman decoding (mincode/maxcode/valptr).
* Annex H lossless coding model: differences coded as the DC
  magnitude-category scheme (SSSS + extend; SSSS=16 means +32768 with no
  extra bits), reconstruction modulo 2^16, predictors 1–7 with the
  first-line → Ra and first-column → Rb rules and the
  ``1 << (P - Pt - 1)`` scan-start default.
* Point transform Pt (decoder shifts output left by Pt, H.2.2).
* Restart intervals — **row-aligned only** (Ri a multiple of the MCU
  row).  Each restart interval then decodes as an independent sub-image
  (prediction fully reset, first row of the interval uses first-line
  semantics), which is how every real encoder emits them; a mid-row Ri
  raises instead of risking silently wrong pixels.
* Single-component scans and Ns≤4 interleaved scans with Hi=Vi=1
  (DICOM grayscale is 1 component; RGB is 3, interleaved).  Subsampled
  lossless (Hi/Vi > 1) does not occur in DICOM and raises.

Reconstruction is vectorised where the recurrence allows: predictor 1
is a row cumsum (first column is itself a column cumsum), predictor 2 a
column cumsum, predictor 4 a 2-D prefix sum (the Ra+Rb−Rc recurrence
telescopes), predictors 3 and 5 run row-at-a-time (5's in-row chain
``Rx[c] = Rx[c-1] + ((Rb−Rc)>>1) + d`` has a previous-row-only
increment, so it is also a cumsum).  Only 6 and 7 — whose ``>>1``
involves the current row and does not commute with mod-2^16 — fall back
to a per-sample loop.  The serial Huffman bit decode of a single-component
scan and the encoder's bit packer run in the port's host C++ loops
(:mod:`mdx_torch.io.native`: ``jpegll_diffs``, ``jpegll_pack``); the
Python loops here (``_scan_diffs_py``, ``_pack_segment_py``) are their
plain versions, taken for multi-component scans (as the JAX package does)
and under ``MDX_NO_NATIVE=1``.

Huffman tables on encode are optimal per frame: package-merge with the
JPEG 16-bit length limit over the SSSS histogram, plus the Annex K.2
reserved symbol so no codeword of the maximum length is all ones.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mdx_torch.io import native as _native

__all__ = ["JpegLLError", "decode", "encode"]


class JpegLLError(ValueError):
    """Malformed or unsupported JPEG Lossless stream."""


_M16 = 0xFFFF
_SOI, _EOI = 0xD8, 0xD9
_SOF3 = 0xC3
_DHT, _DRI, _SOS, _COM = 0xC4, 0xDD, 0xDA, 0xFE
_RST0 = 0xD0
# All SOFn markers other than SOF3; seeing one means a lossy/unsupported
# process, which deserves a specific error.
_OTHER_SOF = {0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7,
              0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------


@dataclass
class _HuffTable:
    counts: np.ndarray        # [16] codes per length 1..16
    values: np.ndarray        # symbols in canonical order
    mincode: np.ndarray       # [17] first code of each length (index by L)
    maxcode: np.ndarray       # [17] last code of each length, -1 if none
    valptr: np.ndarray        # [17] index into values of first code of len L


def _build_table(counts: np.ndarray, values: np.ndarray) -> _HuffTable:
    """Canonical code bookkeeping per T.81 F.2.2.3 (DECODE tables)."""
    if int(counts.sum()) != len(values):
        raise JpegLLError("DHT counts do not match value list length.")
    if len(values) and int(values.max()) > 16:
        raise JpegLLError(
            "DHT symbol > 16 is invalid for lossless (SSSS is 0..16).")
    mincode = np.zeros(17, dtype=np.int64)
    maxcode = np.full(17, -1, dtype=np.int64)
    valptr = np.zeros(17, dtype=np.int64)
    code = 0
    k = 0
    for length in range(1, 17):
        n = int(counts[length - 1])
        if n:
            valptr[length] = k
            mincode[length] = code
            code += n
            maxcode[length] = code - 1
            k += n
        if code > (1 << length):
            raise JpegLLError("DHT table over-subscribes code space.")
        code <<= 1
    return _HuffTable(counts, values, mincode, maxcode, valptr)


def _optimal_lengths(freq: np.ndarray, limit: int = 16) -> np.ndarray:
    """Length-limited Huffman code lengths via package-merge.

    ``freq`` is over 17 real symbols (SSSS 0..16) **plus one reserved
    dummy symbol** appended by the caller (Annex K.2's trick: the dummy
    takes the all-ones codeword of the maximum length, which JPEG
    forbids for real symbols).  Zero-frequency symbols get no code.
    """
    syms = np.flatnonzero(freq)
    if len(syms) == 0:
        raise JpegLLError("Empty symbol set.")
    if len(syms) == 1:
        out = np.zeros(len(freq), dtype=np.int64)
        out[syms[0]] = 1
        return out
    # package-merge: coins at each level, cheapest 2 merge up
    items: List[List[Tuple[int, Dict[int, int]]]] = []
    base = [(int(freq[s]), {int(s): 1}) for s in syms]
    base.sort(key=lambda t: t[0])
    prev: List[Tuple[int, Dict[int, int]]] = []
    for _ in range(limit):
        level = list(base)
        for a, b in zip(prev[::2], prev[1::2]):
            merged: Dict[int, int] = dict(a[1])
            for s, c in b[1].items():
                merged[s] = merged.get(s, 0) + c
            level.append((a[0] + b[0], merged))
        level.sort(key=lambda t: t[0])
        prev = level
    lengths = np.zeros(len(freq), dtype=np.int64)
    for _, bag in prev[: 2 * (len(syms) - 1)]:
        for s, c in bag.items():
            lengths[s] += c
    return lengths


def _canonical_codes(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray, np.ndarray]:
    """Code lengths → (counts[16], values, code_of_symbol, len_of_symbol).

    Canonical order: (length, symbol).  Symbols with length 0 are absent.
    """
    order = sorted(int(s) for s in np.flatnonzero(lengths))
    order.sort(key=lambda s: (int(lengths[s]), s))
    counts = np.zeros(16, dtype=np.int64)
    for s in order:
        counts[int(lengths[s]) - 1] += 1
    codes = np.zeros(len(lengths), dtype=np.int64)
    code = 0
    prev_len = int(lengths[order[0]])
    for s in order:
        ln = int(lengths[s])
        code <<= ln - prev_len
        prev_len = ln
        codes[s] = code
        code += 1
    return counts, np.asarray(order, dtype=np.uint8), codes, lengths


# ---------------------------------------------------------------------------
# Marker parsing
# ---------------------------------------------------------------------------


@dataclass
class _Frame:
    precision: int
    rows: int
    cols: int
    comp_ids: List[int]


def _u16(b: bytes, i: int) -> int:
    return struct.unpack_from(">H", b, i)[0]


def decode(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode one JPEG Lossless stream.

    Returns ``(img, precision)`` where ``img`` is uint16 ``[H, W]`` for a
    single component or ``[H, W, S]`` interleaved for S components.
    """
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != _SOI:
        raise JpegLLError("Not a JPEG stream (missing SOI).")

    frame: Optional[_Frame] = None
    tables: Dict[int, _HuffTable] = {}
    restart_interval = 0
    planes: Dict[int, np.ndarray] = {}

    i = 2
    while True:
        while i < n and data[i] == 0xFF and i + 1 < n and data[i + 1] == 0xFF:
            i += 1
        if i + 1 >= n:
            raise JpegLLError("Truncated JPEG stream (no EOI).")
        if data[i] != 0xFF:
            raise JpegLLError("Expected a JPEG marker.")
        marker = data[i + 1]
        i += 2
        if marker == _EOI:
            break
        if marker in _OTHER_SOF:
            raise JpegLLError(
                f"SOF 0x{marker:02X} is not lossless process 14 "
                "(only SOF3 is supported).")
        if i + 2 > n:
            raise JpegLLError("Truncated marker segment.")
        seg_len = _u16(data, i)
        if seg_len < 2 or i + seg_len > n:
            raise JpegLLError("Marker segment length out of range.")
        seg = data[i + 2:i + seg_len]
        i += seg_len

        if marker == _SOF3:
            if frame is not None:
                raise JpegLLError("Multiple SOF segments.")
            if len(seg) < 6:
                raise JpegLLError("Truncated SOF3.")
            precision = seg[0]
            rows = _u16(seg, 1)
            cols = _u16(seg, 3)
            ncomp = seg[5]
            if not (2 <= precision <= 16):
                raise JpegLLError(f"SOF3 precision {precision} out of 2..16.")
            if rows == 0 or cols == 0:
                raise JpegLLError("SOF3 with zero dimensions.")
            if not (1 <= ncomp <= 4):
                raise JpegLLError(f"{ncomp} components unsupported (1..4).")
            if len(seg) < 6 + 3 * ncomp:
                raise JpegLLError("Truncated SOF3 component list.")
            comp_ids = []
            for c in range(ncomp):
                cid, hv = seg[6 + 3 * c], seg[7 + 3 * c]
                if hv != 0x11:
                    raise JpegLLError(
                        "Subsampled lossless JPEG (Hi/Vi != 1) unsupported.")
                comp_ids.append(cid)
            frame = _Frame(precision, rows, cols, comp_ids)
        elif marker == _DHT:
            j = 0
            while j < len(seg):
                if j + 17 > len(seg):
                    raise JpegLLError("Truncated DHT.")
                tc_th = seg[j]
                counts = np.frombuffer(seg[j + 1:j + 17], dtype=np.uint8)
                total = int(counts.sum())
                if j + 17 + total > len(seg):
                    raise JpegLLError("Truncated DHT value list.")
                values = np.frombuffer(
                    seg[j + 17:j + 17 + total], dtype=np.uint8)
                j += 17 + total
                if (tc_th >> 4) == 0:  # DC-class tables drive lossless
                    tables[tc_th & 0x0F] = _build_table(
                        counts.astype(np.int64), values)
        elif marker == _DRI:
            if len(seg) < 2:
                raise JpegLLError("Truncated DRI.")
            restart_interval = _u16(seg, 0)
        elif marker == _SOS:
            if frame is None:
                raise JpegLLError("SOS before SOF3.")
            if len(seg) < 4:
                raise JpegLLError("Truncated SOS header.")
            ns = seg[0]
            if len(seg) < 1 + 2 * ns + 3:
                raise JpegLLError("Truncated SOS component list.")
            scan_comps = []   # (component index in frame, huff table)
            for c in range(ns):
                cid, tdta = seg[1 + 2 * c], seg[2 + 2 * c]
                try:
                    ci = frame.comp_ids.index(cid)
                except ValueError:
                    raise JpegLLError(
                        f"SOS references unknown component id {cid}.") from None
                td = tdta >> 4
                if td not in tables:
                    raise JpegLLError(f"SOS references missing DC table {td}.")
                scan_comps.append((ci, tables[td]))
            ss = seg[1 + 2 * ns]           # predictor selection
            pt = seg[3 + 2 * ns] & 0x0F    # point transform (Al)
            if not (1 <= ss <= 7):
                raise JpegLLError(f"Predictor selection {ss} out of 1..7.")
            if pt >= frame.precision:
                raise JpegLLError("Point transform >= precision.")
            comps, i = _decode_scan(
                data, i, frame, scan_comps, ss, pt, restart_interval)
            for (ci, _), plane in zip(scan_comps, comps):
                planes[ci] = plane
        # all other markers (APPn, COM, ...) are skipped via seg_len

    if frame is None:
        raise JpegLLError("JPEG stream has no SOF3 frame header.")
    missing = [cid for k, cid in enumerate(frame.comp_ids) if k not in planes]
    if missing:
        raise JpegLLError(f"No scan decoded component id(s) {missing}.")
    if len(frame.comp_ids) == 1:
        return planes[0], frame.precision
    img = np.stack([planes[k] for k in range(len(frame.comp_ids))], axis=-1)
    return img, frame.precision


# ---------------------------------------------------------------------------
# Scan decoding
# ---------------------------------------------------------------------------


def _entropy_segments(data: bytes, i: int,
                      n_restarts: int) -> Tuple[List[bytes], int]:
    """Split entropy-coded bytes at the expected RSTn markers.

    Returns the destuffed per-interval byte strings and the index of the
    first marker after the scan (pointing at 0xFF).
    """
    segs = []
    cur = bytearray()
    expect = 0
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            raise JpegLLError("Truncated entropy-coded scan.")
        cur += data[i:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i = j + 2
            continue
        if _RST0 <= nxt <= 0xD7:
            if len(segs) >= n_restarts or nxt != _RST0 + (expect & 7):
                raise JpegLLError(
                    f"Unexpected restart marker 0xFF{nxt:02X}.")
            segs.append(bytes(cur))
            cur = bytearray()
            expect += 1
            i = j + 2
            continue
        # real marker: end of scan
        segs.append(bytes(cur))
        if len(segs) != n_restarts + 1:
            raise JpegLLError(
                f"Scan has {len(segs) - 1} restart intervals, "
                f"DRI implies {n_restarts}.")
        return segs, j


def _decode_scan(data: bytes, i: int, frame: _Frame, scan_comps, ss: int,
                 pt: int, ri: int):
    """Decode one scan's entropy data → list of uint16 [H, W] planes."""
    h, w, ns = frame.rows, frame.cols, len(scan_comps)
    total_mcus = h * w
    if ri:
        if ri % w:
            raise JpegLLError(
                f"Restart interval {ri} is not row-aligned (width {w}); "
                "mid-row restarts are unsupported.")
        n_restarts = (total_mcus - 1) // ri
    else:
        n_restarts = 0
    segs, end = _entropy_segments(data, i, n_restarts)

    rows_per = (ri // w) if ri else h
    planes = [np.empty((h, w), dtype=np.uint16) for _ in range(ns)]
    r0 = 0
    for seg_idx, seg in enumerate(segs):
        seg_rows = min(rows_per, h - r0)
        diffs = _scan_diffs(seg, [t for _, t in scan_comps], seg_rows, w)
        for k in range(ns):
            planes[k][r0:r0 + seg_rows] = _reconstruct(
                diffs[k].reshape(seg_rows, w), ss, frame.precision, pt)
        r0 += seg_rows
    if r0 != h:
        raise JpegLLError("Scan decoded fewer rows than the frame header.")
    return planes, end


def _scan_diffs(seg: bytes, tabs: List[_HuffTable], rows: int,
                cols: int) -> List[np.ndarray]:
    """Huffman-decode one restart interval → per-component diff arrays.

    The host C++ loop for the single-component case; the Python loop below
    is its plain version.
    """
    count = rows * cols
    if len(tabs) == 1 and not _native.disabled():
        rc, diffs = _native.jpegll_diffs(
            seg, tabs[0].counts, tabs[0].values, count)
        if rc == -1:
            raise JpegLLError("Truncated entropy-coded segment.")
        if rc == -2:
            raise JpegLLError("Invalid Huffman code in scan.")
        if rc == -3:
            raise JpegLLError("DHT counts do not match value list length.")
        return [diffs]
    return _scan_diffs_py(seg, tabs, count)


def _scan_diffs_py(seg: bytes, tabs: List[_HuffTable],
                   count: int) -> List[np.ndarray]:
    bits = np.unpackbits(np.frombuffer(seg, dtype=np.uint8))
    nb = len(bits)
    out = [np.empty(count, dtype=np.int32) for _ in tabs]
    pos = 0
    for m in range(count):
        for k, tab in enumerate(tabs):
            code = 0
            ln = 0
            maxc = tab.maxcode
            while True:
                if pos >= nb:
                    raise JpegLLError("Truncated entropy-coded segment.")
                code = (code << 1) | int(bits[pos])
                pos += 1
                ln += 1
                if ln > 16:
                    raise JpegLLError("Invalid Huffman code in scan.")
                if maxc[ln] >= code:
                    break
            s = int(tab.values[tab.valptr[ln] + code - tab.mincode[ln]])
            if s == 0:
                d = 0
            elif s == 16:
                d = 32768
            else:
                if pos + s > nb:
                    raise JpegLLError("Truncated entropy-coded segment.")
                v = 0
                for _ in range(s):
                    v = (v << 1) | int(bits[pos])
                    pos += 1
                d = v if v >= (1 << (s - 1)) else v - (1 << s) + 1
            out[k][m] = d
    return out


def _reconstruct(d: np.ndarray, ss: int, precision: int,
                 pt: int) -> np.ndarray:
    """Un-difference one restart interval (T.81 H.2): ``Rx = (Px + d) mod
    2^16`` with first-line → Ra, first-column → Rb, scan-start default
    ``1 << (P - Pt - 1)``; output shifted left by Pt."""
    h, w = d.shape
    d = d.astype(np.int64)
    default = 1 << (precision - pt - 1)
    x = np.zeros((h, w), dtype=np.int64)

    # first line: Ra chain == cumsum from the default
    x[0] = (default + np.cumsum(d[0])) & _M16
    if h > 1:
        if ss == 1:
            col0 = (x[0, 0] + np.cumsum(d[1:, 0])) & _M16     # Rb chain
            x[1:, 0] = col0
            if w > 1:
                x[1:, 1:] = (col0[:, None] + np.cumsum(d[1:, 1:], axis=1)) & _M16
        elif ss == 2:
            x[1:] = (x[0][None, :] + np.cumsum(d[1:], axis=0)) & _M16
        elif ss == 4:
            # Ra + Rb - Rc telescopes: x = 2-D prefix sum of adjusted d
            dp = d.copy()
            dp[0, 0] += default
            x = np.cumsum(np.cumsum(dp, axis=0), axis=1) & _M16
            x[0] = (default + np.cumsum(d[0])) & _M16  # exact first line
        elif ss in (3, 5):
            for r in range(1, h):
                x[r, 0] = (x[r - 1, 0] + d[r, 0]) & _M16
                if w > 1:
                    if ss == 3:
                        x[r, 1:] = (x[r - 1, :-1] + d[r, 1:]) & _M16
                    else:
                        # in-row chain with a previous-row-only increment
                        t = ((x[r - 1, 1:] - x[r - 1, :-1]) >> 1) + d[r, 1:]
                        x[r, 1:] = (x[r, 0] + np.cumsum(t)) & _M16
        else:  # 6, 7: the >>1 uses the current row — strictly sequential
            xl = x.tolist()
            dl = d.tolist()
            for r in range(1, h):
                xr, xp, dr = xl[r], xl[r - 1], dl[r]
                xr[0] = (xp[0] + dr[0]) & _M16
                if ss == 6:
                    for c in range(1, w):
                        xr[c] = (xp[c] + ((xr[c - 1] - xp[c - 1]) >> 1)
                                 + dr[c]) & _M16
                else:
                    for c in range(1, w):
                        xr[c] = (((xr[c - 1] + xp[c]) >> 1) + dr[c]) & _M16
            x = np.asarray(xl, dtype=np.int64)
    if pt:
        x = (x << pt) & _M16
    return x.astype(np.uint16)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _predict(x: np.ndarray, ss: int, precision: int, pt: int) -> np.ndarray:
    """Prediction array for the encoder (x already point-transformed)."""
    h, w = x.shape
    x = x.astype(np.int64)
    p = np.empty((h, w), dtype=np.int64)
    p[0, 0] = 1 << (precision - pt - 1)
    p[0, 1:] = x[0, :-1]                    # first line: Ra
    if h > 1:
        p[1:, 0] = x[:-1, 0]                # first column: Rb
        ra, rb, rc = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
        if ss == 1:
            p[1:, 1:] = ra
        elif ss == 2:
            p[1:, 1:] = rb
        elif ss == 3:
            p[1:, 1:] = rc
        elif ss == 4:
            p[1:, 1:] = ra + rb - rc
        elif ss == 5:
            p[1:, 1:] = ra + ((rb - rc) >> 1)
        elif ss == 6:
            p[1:, 1:] = rb + ((ra - rc) >> 1)
        else:
            p[1:, 1:] = (ra + rb) >> 1
    return p


def _diff_symbols(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Signed diffs → (SSSS category, extra-bit count, extra-bit value)."""
    cat16 = d == -32768                      # ≡ +32768 mod 2^16 → SSSS 16
    mag = np.abs(np.where(cat16, 0, d))
    ssss = np.zeros(d.shape, dtype=np.int64)
    nz = mag > 0
    ssss[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    ssss[cat16] = 16
    extra_bits = np.where(cat16, 0, ssss)
    v = np.where(d >= 0, d, d + (1 << ssss) - 1)
    v = np.where(cat16 | (ssss == 0), 0, v)
    return ssss, extra_bits, v


def _pack_segment(ssss, extra_bits, extra_val, code_of, len_of) -> bytes:
    """Bit-pack one restart interval, 1-padded to a byte, 0xFF-stuffed.

    The host C++ loop (the per-bit fan-out of the NumPy packer materialises
    ~8 int64 elements per output bit, the encoder's hot loop); the NumPy
    packer is its plain version.
    """
    if _native.disabled():
        return _pack_segment_py(ssss, extra_bits, extra_val, code_of, len_of)
    return _native.jpegll_pack(ssss, extra_val, code_of, len_of)


def _pack_segment_py(ssss, extra_bits, extra_val, code_of, len_of) -> bytes:
    """Vectorised bit packing of one restart interval, 1-padded to a byte."""
    flat_s = ssss.ravel()
    codes = code_of[flat_s]
    clens = len_of[flat_s]
    ebits = extra_bits.ravel()
    evals = extra_val.ravel()
    total_len = clens + ebits
    vals = (codes << ebits) | evals          # ≤ 32 bits per sample
    n_bits = int(total_len.sum())
    starts = np.cumsum(total_len) - total_len
    idx = np.arange(n_bits, dtype=np.int64) - np.repeat(starts, total_len)
    shift = np.repeat(total_len, total_len) - 1 - idx
    bits = ((np.repeat(vals, total_len) >> shift) & 1).astype(np.uint8)
    pad = (-n_bits) % 8
    if pad:
        bits = np.concatenate([bits, np.ones(pad, dtype=np.uint8)])
    raw = np.packbits(bits).tobytes()
    return raw.replace(b"\xff", b"\xff\x00")  # byte stuffing


def encode(frame: np.ndarray, *, precision: Optional[int] = None,
           predictor: int = 1, point_transform: int = 0,
           restart_rows: int = 0) -> bytes:
    """Encode a 2-D (grayscale) or [H, W, S] (interleaved) frame.

    ``frame`` must be unsigned with values < 2^precision (mask signed
    data to ``precision`` bits first — the mod-2^16 arithmetic makes the
    round trip exact, see :func:`mdx_torch.io.dicom.decode_pixels`).
    ``predictor`` is the selection value Ss (1 = SV1, the only value the
    ``.70`` transfer syntax allows); ``restart_rows`` > 0 emits a DRI of
    that many MCU rows and RSTn markers between intervals.
    """
    if frame.ndim == 2:
        comps = [frame]
    elif frame.ndim == 3 and 1 <= frame.shape[2] <= 4:
        comps = [frame[:, :, k] for k in range(frame.shape[2])]
    else:
        raise JpegLLError("encode() expects [H, W] or [H, W, S<=4].")
    if not (1 <= predictor <= 7):
        raise JpegLLError(f"Predictor {predictor} out of 1..7.")
    h, w = comps[0].shape
    if h < 1 or w < 1 or h > 65535 or w > 65535:
        raise JpegLLError("Frame dimensions out of 1..65535.")
    arrs = [np.ascontiguousarray(c).astype(np.int64) & _M16 for c in comps]
    if precision is None:
        top = max(int(a.max()) for a in arrs)
        precision = max(2, int(top).bit_length())
    if not (2 <= precision <= 16):
        raise JpegLLError(f"Precision {precision} out of 2..16.")
    if not (0 <= point_transform < precision):
        raise JpegLLError("Point transform out of range.")
    for a in arrs:
        if int(a.max()) >= (1 << precision):
            raise JpegLLError(
                f"Sample exceeds 2^{precision}-1; mask or raise precision.")
    if point_transform:
        arrs = [a >> point_transform for a in arrs]

    # per-component diffs over row-aligned restart intervals
    rows_per = restart_rows if restart_rows else h
    seg_bounds = list(range(0, h, rows_per)) + [h]
    per_seg: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
    freq = np.zeros(18, dtype=np.int64)      # 17 real symbols + dummy
    for s0, s1 in zip(seg_bounds[:-1], seg_bounds[1:]):
        row: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for a in arrs:
            blk = a[s0:s1]
            pred = _predict(blk, predictor, precision, point_transform)
            diff = (blk - pred) & _M16
            d = ((diff + 32768) & _M16) - 32768
            ssss, ebits, evals = _diff_symbols(d)
            np.add.at(freq, ssss.ravel(), 1)
            row.append((ssss, ebits, evals))
        per_seg.append(row)
    # Reserved symbol (Annex K.2): weight strictly below every real
    # symbol, so package-merge gives it a maximal code length; canonical
    # ordering (it has the largest symbol value) then hands it the
    # all-ones codeword, which JPEG forbids for real symbols.
    freq = freq * 2
    freq[17] = 1
    lengths = _optimal_lengths(freq)
    counts, values, code_of, len_of = _canonical_codes(lengths)
    # drop the dummy from the emitted table (it is the last canonical code
    # of the maximum length, so real codes never hit all-ones)
    if values[-1] == 17:
        counts[int(lengths[17]) - 1] -= 1
        values = values[:-1]

    # interleave components within each MCU (per T.81 H.2 scan order)
    out = [b"\xff\xd8"]                      # SOI
    sof = struct.pack(">BHHB", precision, h, w, len(arrs))
    for k in range(len(arrs)):
        sof += bytes([k + 1, 0x11, 0])
    out.append(b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof)
    dht = bytes([0x00]) + counts.astype(np.uint8).tobytes() + values.tobytes()
    out.append(b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht)
    if restart_rows:
        out.append(b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * w))
    sos = bytes([len(arrs)])
    for k in range(len(arrs)):
        sos += bytes([k + 1, 0x00])
    sos += bytes([predictor, 0, point_transform])
    out.append(b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos)

    for seg_idx, row in enumerate(per_seg):
        if len(arrs) == 1:
            ssss, ebits, evals = row[0]
        else:
            # interleave per MCU: stack components on a trailing axis
            ssss = np.stack([r[0] for r in row], axis=-1)
            ebits = np.stack([r[1] for r in row], axis=-1)
            evals = np.stack([r[2] for r in row], axis=-1)
        out.append(_pack_segment(ssss, ebits, evals, code_of, len_of))
        if seg_idx != len(per_seg) - 1:
            out.append(bytes([0xFF, _RST0 + (seg_idx & 7)]))
    out.append(b"\xff\xd9")                  # EOI
    return b"".join(out)
