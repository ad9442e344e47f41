"""JPEG-LS (ITU-T T.87 / ISO-IEC 14495-1) codec for DICOM pixel data.

The port's copy of ``mdx/io/jpegls.py``; CPU tests hold its decode
bit-equal and its encode byte-equal to the original's, with the same
errors.  Covers the two JPEG-LS transfer syntaxes:

* JPEG-LS Lossless                            1.2.840.10008.1.2.4.80
* JPEG-LS Lossy (Near-Lossless)               1.2.840.10008.1.2.4.81

Implemented from the standard (ITU-T T.87):

* Marker syntax: SOI / SOF55 / LSE (preset parameters, ID 1) / DRI /
  SOS / RSTn / EOI; APPn and COM skipped.  LSE ID 2-4 (mapping tables,
  oversize dimensions), point transform ≠ 0, and DNL (Y = 0) raise
  specific errors rather than decoding wrong pixels.
* The LOCO-I coding core, clause A: causal template (c b d / a x) with
  the first-line/first-column rules of A.2.1; local-gradient
  quantisation into 365 sign-folded regular contexts (A.3.3) with the
  default T1/T2/T3/RESET of C.2.4.1.1 (or LSE overrides); MED prediction
  with bias correction and clamping (A.4.2); Golomb parameter
  ``min k : N[Q]<<k ≥ A[Q]``; error mapping incl. the
  ``k=0 ∧ 2B≤−N`` special map (A.5.2); limited-length Golomb codes
  LG(k, LIMIT) (A.5.3); context updates + bias cap C∈[−128,127]
  (A.6); run mode with the 32-entry J table, adaptive RUNindex, the
  end-of-line partial-run rule, and run-interruption contexts 365/366
  with their own Nn counters (A.7).
* Near-lossless (NEAR > 0): error quantisation, RANGE reduction, and
  reconstruction-within-±NEAR per A.4.4/A.4.5 — both directions, so
  `.4.81` streams decode.
* Bit stuffing per clause C: a byte following an 0xFF carries only 7
  payload bits (MSB is the stuffed 0); an MSB of 1 there is a marker and
  terminates the entropy segment.
* Restart intervals (DRI + RSTn): byte-aligned, full coder state reset
  every Ri sample lines, marker modulo-8 sequence checked.
* Components: Nf = 1 (DICOM grayscale) fully; Nf > 1 in ILV 0
  (component-sequential scans, each with fresh state).  ILV 1/2
  (line/sample interleaved — not produced for DICOM grayscale) raise.

The per-sample scan loop is adaptive in BOTH directions (every decoded
sample updates the contexts that code the next one), so neither side
vectorises: the scan decode and encode run in the port's host C++ loops
(:mod:`mdx_torch.io.native`: ``jpegls_decode``, ``jpegls_encode``;
bit-identical, same error taxonomy), and this module's Python coder
(``_decode_scan_python``, ``_encode_scan_python``) is their plain
version, taken under ``MDX_NO_NATIVE=1``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from mdx_torch.io import native as _native_mod

__all__ = ["JpegLSError", "decode", "encode"]


class JpegLSError(ValueError):
    """Malformed or unsupported JPEG-LS stream."""


_SOI, _EOI = 0xD8, 0xD9
_SOF55 = 0xF7
_LSE = 0xF8
_DRI, _SOS = 0xDD, 0xDA
_RST0 = 0xD0
_DNL = 0xDC
_COM = 0xFE
# Any other SOFn means a different (lossy DCT / lossless T.81) process.
_OTHER_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
              0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}

# Run-length code order table J (T.87 A.7.1.2).
_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)

_MIN_C, _MAX_C = -128, 127


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def default_thresholds(maxval: int, near: int) -> Tuple[int, int, int]:
    """Default T1/T2/T3 (T.87 C.2.4.1.1.1)."""
    def clamp(i: int, j: int) -> int:
        # C.2.4.1.1: CLAMP(i, j) = j if (i > MAXVAL or i < j) else i
        if i > maxval or i < j:
            return j
        return i

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


@dataclass
class _Params:
    """Everything clause A derives from P/MAXVAL/NEAR (+ LSE presets)."""

    maxval: int
    near: int
    t1: int
    t2: int
    t3: int
    reset: int

    def __post_init__(self):
        t = 2 * self.near + 1
        self.range = (self.maxval + 2 * self.near) // t + 1
        bpp = max(2, _ceil_log2(self.maxval + 1))
        self.limit = 2 * (bpp + max(8, bpp))
        self.qbpp = _ceil_log2(self.range)
        self.a_init = max(2, (self.range + 32) // 64)
        self.t = t


# --------------------------------------------------------------- bit I/O --


class _BitReader:
    """MSB-first reader over an entropy-coded segment with the clause-C
    stuffing rule: a byte after an 0xFF contributes 7 bits; MSB=1 there
    is a marker and ends the segment."""

    __slots__ = ("buf", "pos", "cache", "nbits", "prev_ff")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.cache = 0
        self.nbits = 0
        self.prev_ff = False

    def _fill(self) -> None:
        if self.pos >= len(self.buf):
            raise JpegLSError("Truncated JPEG-LS entropy segment.")
        b = self.buf[self.pos]
        if self.prev_ff:
            if b & 0x80:
                raise JpegLSError("Entropy segment ended at a marker "
                                  "mid-symbol (truncated scan).")
            self.pos += 1
            self.cache = (self.cache << 7) | b
            self.nbits += 7
            self.prev_ff = False
        else:
            self.pos += 1
            self.cache = (self.cache << 8) | b
            self.nbits += 8
            self.prev_ff = b == 0xFF

    def read_bit(self) -> int:
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        bit = (self.cache >> self.nbits) & 1
        self.cache &= (1 << self.nbits) - 1  # keep the cache a small int
        return bit

    def read_bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.cache >> self.nbits) & ((1 << n) - 1)
        self.cache &= (1 << self.nbits) - 1
        return v

    def align_to_marker(self) -> int:
        """Drop pad bits, then return the byte offset of the next marker
        (the 0xFF).  Used at restart boundaries and end of scan."""
        self.cache = 0
        self.nbits = 0
        pos = self.pos
        if self.prev_ff:
            pos -= 1  # the 0xFF already consumed into the cache
            self.prev_ff = False
        self.pos = pos
        return pos


class _BitWriter:
    """MSB-first writer emitting the clause-C stuffing: after writing an
    0xFF byte, the next byte carries 7 bits with a 0 MSB.

    ``cap`` is the current byte's payload capacity (7 after an 0xFF,
    else 8); ``free`` counts bits still open in it.  Bits land in the
    byte's LOW ``cap`` positions, so a 7-bit byte gets its MSB stuffed
    to 0 automatically.
    """

    __slots__ = ("out", "cur", "free", "cap")

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.free = 8
        self.cap = 8

    def write_bits(self, value: int, n: int) -> None:
        while n > 0:
            take = min(n, self.free)
            n -= take
            self.free -= take
            self.cur |= ((value >> n) & ((1 << take) - 1)) << self.free
            if self.free == 0:
                self.out.append(self.cur)
                self.cap = self.free = 7 if self.cur == 0xFF else 8
                self.cur = 0

    def write_unary(self, zeros: int) -> None:
        # `zeros` 0-bits followed by a 1 (limited-length Golomb prefix)
        while zeros >= 24:
            self.write_bits(0, 24)
            zeros -= 24
        self.write_bits(1, zeros + 1)

    def flush(self) -> None:
        """Pad the final byte with 0 bits (clause C fill bits)."""
        if self.free != self.cap:
            self.out.append(self.cur)
        self.cur = 0
        self.cap = self.free = 8


# ------------------------------------------------------------ scan coder --


class _ScanCoder:
    """Shared state machine for one entropy-coded segment (T.87 clause A).

    Encode and decode share context bookkeeping so the two directions
    cannot drift apart; the per-sample order of operations follows the
    standard's figures exactly (code, then update A/B/N, then bias)."""

    __slots__ = ("p", "A", "B", "C", "N", "Nn", "run_index")

    def __init__(self, p: _Params):
        self.p = p
        n_ctx = 367  # 0..364 regular, 365/366 run interruption
        self.A = [p.a_init] * n_ctx
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * n_ctx
        self.Nn = [0, 0]  # negative-error counters for contexts 365/366
        self.run_index = 0

    # -- context helpers ---------------------------------------------------

    def _quantize(self, d: int) -> int:
        p = self.p
        if d <= -p.t3:
            return -4
        if d <= -p.t2:
            return -3
        if d <= -p.t1:
            return -2
        if d < -p.near:
            return -1
        if d <= p.near:
            return 0
        if d < p.t1:
            return 1
        if d < p.t2:
            return 2
        if d < p.t3:
            return 3
        return 4

    def context(self, ra: int, rb: int, rc: int, rd: int) -> Tuple[int, int]:
        """(Q, SIGN); Q == 0 selects run mode."""
        q1 = self._quantize(rd - rb)
        q2 = self._quantize(rb - rc)
        q3 = self._quantize(rc - ra)
        if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
            return 81 * -q1 + 9 * -q2 + -q3, -1
        return 81 * q1 + 9 * q2 + q3, 1

    @staticmethod
    def _predict(ra: int, rb: int, rc: int) -> int:
        if rc >= max(ra, rb):
            return min(ra, rb)
        if rc <= min(ra, rb):
            return max(ra, rb)
        return ra + rb - rc

    def corrected_prediction(self, q: int, sign: int,
                             ra: int, rb: int, rc: int) -> int:
        px = self._predict(ra, rb, rc) + sign * self.C[q]
        if px < 0:
            return 0
        if px > self.p.maxval:
            return self.p.maxval
        return px

    def _k(self, q: int) -> int:
        a, n = self.A[q], self.N[q]
        k = 0
        while (n << k) < a:
            k += 1
        return k

    def _mod_range(self, e: int) -> int:
        r = self.p.range
        if e < 0:
            e += r
        if e >= (r + 1) // 2:
            e -= r
        return e

    def _quant_err(self, e: int) -> int:
        near, t = self.p.near, self.p.t
        if near == 0:
            return e
        if e > 0:
            return (near + e) // t
        return -((near - e) // t)

    def _update_regular(self, q: int, e: int) -> None:
        p = self.p
        self.B[q] += e * p.t
        self.A[q] += abs(e)
        if self.N[q] == p.reset:
            self.A[q] >>= 1
            self.B[q] >>= 1
            self.N[q] >>= 1
        self.N[q] += 1
        # bias computation (A.6.2)
        if self.B[q] <= -self.N[q]:
            self.B[q] += self.N[q]
            if self.C[q] > _MIN_C:
                self.C[q] -= 1
            if self.B[q] <= -self.N[q]:
                self.B[q] = -self.N[q] + 1
        elif self.B[q] > 0:
            self.B[q] -= self.N[q]
            if self.C[q] < _MAX_C:
                self.C[q] += 1
            if self.B[q] > 0:
                self.B[q] = 0

    # -- regular mode ------------------------------------------------------

    def decode_regular(self, br: _BitReader, q: int, sign: int,
                       px: int) -> int:
        p = self.p
        k = self._k(q)
        merr = self._read_lg(br, k, p.limit)
        if p.near == 0 and k == 0 and 2 * self.B[q] <= -self.N[q]:
            # inverse of the special map (A.5.2): e>=0 -> 2e+1, e<0 -> -2(e+1)
            e = (merr - 1) // 2 if (merr & 1) else -(merr // 2) - 1
        else:
            e = merr // 2 if not (merr & 1) else -((merr + 1) // 2)
        self._update_regular(q, e)
        rx = px + sign * e * p.t
        # A.4.5 reconstruction modulo + clamp
        if rx < -p.near:
            rx += p.range * p.t
        elif rx > p.maxval + p.near:
            rx -= p.range * p.t
        if rx < 0:
            rx = 0
        elif rx > p.maxval:
            rx = p.maxval
        return rx

    def encode_regular(self, bw: _BitWriter, q: int, sign: int,
                       px: int, x: int) -> int:
        p = self.p
        e = x - px
        if sign < 0:
            e = -e
        e = self._quant_err(e)
        rx = px + sign * e * p.t
        if rx < 0:
            rx = 0
        elif rx > p.maxval:
            rx = p.maxval
        e = self._mod_range(e)
        k = self._k(q)
        if p.near == 0 and k == 0 and 2 * self.B[q] <= -self.N[q]:
            merr = 2 * e + 1 if e >= 0 else -2 * (e + 1)
        else:
            merr = 2 * e if e >= 0 else -2 * e - 1
        self._write_lg(bw, merr, k, p.limit)
        self._update_regular(q, e)
        return rx

    # -- limited-length Golomb (A.5.3) ------------------------------------

    def _read_lg(self, br: _BitReader, k: int, limit: int) -> int:
        p = self.p
        zmax = limit - p.qbpp - 1
        z = 0
        while br.read_bit() == 0:
            z += 1
            if z > zmax:
                raise JpegLSError("Corrupt Golomb code (unary overflow).")
        if z < zmax:
            return (z << k) | (br.read_bits(k) if k else 0)
        return br.read_bits(p.qbpp) + 1

    def _write_lg(self, bw: _BitWriter, merr: int, k: int,
                  limit: int) -> None:
        p = self.p
        zmax = limit - p.qbpp - 1
        hi = merr >> k
        if hi < zmax:
            bw.write_unary(hi)
            if k:
                bw.write_bits(merr & ((1 << k) - 1), k)
        else:
            bw.write_unary(zmax)
            bw.write_bits(merr - 1, p.qbpp)

    # -- run mode (A.7) ----------------------------------------------------

    def decode_run(self, br: _BitReader, line: List[int], col: int,
                   width: int, run_val: int,
                   prev: List[int]) -> int:
        """Decode a run starting at ``col``; returns the next column.

        Every run sample reconstructs to ``run_val`` exactly (also under
        NEAR > 0), so Ra of the interrupting sample is ``run_val``.
        """
        while True:
            if br.read_bit() == 1:
                seg = 1 << _J[self.run_index]
                fill = min(seg, width - col)
                for i in range(fill):
                    line[col + i] = run_val
                col += fill
                if fill < seg:      # partial segment: hit end of line
                    return col
                if self.run_index < 31:
                    self.run_index += 1
                if col == width:    # exact segment to line end: no more bits
                    return col
            else:
                n = _J[self.run_index]
                cnt = br.read_bits(n) if n else 0
                if cnt > width - col - 1:
                    raise JpegLSError("Run length exceeds the line.")
                for i in range(cnt):
                    line[col + i] = run_val
                col += cnt
                rb = prev[col]
                line[col] = self._decode_run_interruption(br, run_val, rb)
                col += 1
                if self.run_index > 0:
                    self.run_index -= 1
                return col

    def encode_run(self, bw: _BitWriter, line: List[int], recon: List[int],
                   col: int, width: int, run_val: int,
                   prev: List[int]) -> int:
        cnt = 0
        while col < width and abs(line[col] - run_val) <= self.p.near:
            recon[col] = run_val
            col += 1
            cnt += 1
        while cnt >= (1 << _J[self.run_index]):
            bw.write_bits(1, 1)
            cnt -= 1 << _J[self.run_index]
            if self.run_index < 31:
                self.run_index += 1
        if col == width:
            if cnt > 0:
                bw.write_bits(1, 1)
            return col
        bw.write_bits(0, 1)
        n = _J[self.run_index]
        if n:
            bw.write_bits(cnt, n)
        rb = prev[col]
        recon[col] = self._encode_run_interruption(bw, run_val, rb, line[col])
        col += 1
        if self.run_index > 0:
            self.run_index -= 1
        return col

    def _ri_k(self, ritype: int) -> int:
        q = 365 + ritype
        temp = self.A[q] + (self.N[q] >> 1) if ritype else self.A[q]
        n = self.N[q]
        k = 0
        while (n << k) < temp:
            k += 1
        return k

    def _ri_update(self, ritype: int, e: int, em: int) -> None:
        q = 365 + ritype
        if e < 0:
            self.Nn[ritype] += 1
        self.A[q] += (em + 1 - ritype) >> 1
        if self.N[q] == self.p.reset:
            self.A[q] >>= 1
            self.N[q] >>= 1
            self.Nn[ritype] >>= 1
        self.N[q] += 1

    def _decode_run_interruption(self, br: _BitReader, ra: int,
                                 rb: int) -> int:
        p = self.p
        ritype = 1 if abs(ra - rb) <= p.near else 0
        px = ra if ritype else rb
        sign = -1 if (ritype == 0 and ra > rb) else 1
        k = self._ri_k(ritype)
        em = self._read_lg(br, k, p.limit - _J[self.run_index] - 1)
        # invert EMErrval = 2|e| - RItype - map  (A.7.1.5)
        temp = em + ritype
        map_bit = temp & 1
        e_abs = (temp + map_bit) // 2
        q365 = 365 + ritype
        if ((k != 0 or (2 * self.Nn[ritype] >= self.N[q365]))
                == bool(map_bit)):
            e = -e_abs
        else:
            e = e_abs
        self._ri_update(ritype, e, em)
        rx = px + sign * e * p.t
        if rx < -p.near:
            rx += p.range * p.t
        elif rx > p.maxval + p.near:
            rx -= p.range * p.t
        if rx < 0:
            rx = 0
        elif rx > p.maxval:
            rx = p.maxval
        return rx

    def _encode_run_interruption(self, bw: _BitWriter, ra: int, rb: int,
                                 x: int) -> int:
        p = self.p
        ritype = 1 if abs(ra - rb) <= p.near else 0
        px = ra if ritype else rb
        sign = -1 if (ritype == 0 and ra > rb) else 1
        e = x - px
        if sign < 0:
            e = -e
        e = self._quant_err(e)
        rx = px + sign * e * p.t
        if rx < 0:
            rx = 0
        elif rx > p.maxval:
            rx = p.maxval
        e = self._mod_range(e)
        k = self._ri_k(ritype)
        q365 = 365 + ritype
        if k == 0 and e > 0 and 2 * self.Nn[ritype] < self.N[q365]:
            map_bit = 1
        elif e < 0 and 2 * self.Nn[ritype] >= self.N[q365]:
            map_bit = 1
        elif e < 0 and k != 0:
            map_bit = 1
        else:
            map_bit = 0
        em = 2 * abs(e) - ritype - map_bit
        self._write_lg(bw, em, k, p.limit - _J[self.run_index] - 1)
        self._ri_update(ritype, e, em)
        return rx


# -------------------------------------------------------- scan traversal --


def _decode_scan_python(buf: bytes, pos: int, width: int, height: int,
                        params: _Params) -> Tuple[np.ndarray, int]:
    """Pure-Python scan decode (the host loop's plain version).  Returns the
    component plane and the offset of the terminating marker.

    Edge rules (T.87 A.2.1): the previous line of the first line is all
    zeros; Ra at column 0 is Rb (the sample above); Rc at column 0 is the
    Ra value used at column 0 of the PREVIOUS line (``edge``); Rd at the
    last column is Rb.
    """
    coder = _ScanCoder(params)
    br = _BitReader(buf, pos)
    prev: List[int] = [0] * width
    edge = 0
    out = np.empty((height, width), np.int64)
    for row in range(height):
        cur: List[int] = [0] * width
        ra0 = prev[0]
        col = 0
        while col < width:
            ra = cur[col - 1] if col > 0 else ra0
            rb = prev[col]
            rc = prev[col - 1] if col > 0 else edge
            rd = prev[col + 1] if col + 1 < width else prev[width - 1]
            q, sign = coder.context(ra, rb, rc, rd)
            if q == 0:
                col = coder.decode_run(br, cur, col, width, ra, prev)
            else:
                px = coder.corrected_prediction(q, sign, ra, rb, rc)
                cur[col] = coder.decode_regular(br, q, sign, px)
                col += 1
        out[row] = cur
        edge = ra0
        prev = cur
    end = br.align_to_marker()
    return out, end


def _encode_scan_python(plane: np.ndarray, params: _Params) -> bytes:
    height, width = plane.shape
    coder = _ScanCoder(params)
    bw = _BitWriter()
    prev: List[int] = [0] * width
    edge = 0
    rows = plane.tolist()
    for row in range(height):
        line = rows[row]
        recon: List[int] = [0] * width
        ra0 = prev[0]
        col = 0
        while col < width:
            ra = recon[col - 1] if col > 0 else ra0
            rb = prev[col]
            rc = prev[col - 1] if col > 0 else edge
            rd = prev[col + 1] if col + 1 < width else prev[width - 1]
            q, sign = coder.context(ra, rb, rc, rd)
            if q == 0:
                col = coder.encode_run(bw, line, recon, col, width, ra, prev)
            else:
                px = coder.corrected_prediction(q, sign, ra, rb, rc)
                recon[col] = coder.encode_regular(bw, q, sign, px, line[col])
                col += 1
        edge = ra0
        prev = recon
    bw.flush()
    return bytes(bw.out)


# ----------------------------------------------------------- marker layer --


def _u16(buf: bytes, pos: int) -> int:
    if pos + 2 > len(buf):
        raise JpegLSError("Truncated JPEG-LS stream.")
    return struct.unpack_from(">H", buf, pos)[0]


@dataclass
class _Frame:
    precision: int
    height: int
    width: int
    ncomp: int


def decode(stream: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode one JPEG-LS codestream.

    Returns ``(image, precision, near)`` — ``image`` is ``[H, W]`` int64
    (or ``[H, W, C]`` for multi-component ILV-0 streams) in the unsigned
    sample space of the codestream.
    """
    buf = bytes(stream)
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != _SOI:
        raise JpegLSError("Not a JPEG-LS stream (missing SOI).")
    pos = 2
    frame: Optional[_Frame] = None
    maxval_override: Optional[int] = None
    presets: Optional[Tuple[int, int, int, int]] = None  # T1,T2,T3,RESET
    restart_interval = 0
    planes: List[np.ndarray] = []
    near_seen = 0

    while True:
        if pos + 2 > len(buf):
            raise JpegLSError("Truncated JPEG-LS stream (no EOI).")
        if buf[pos] != 0xFF:
            raise JpegLSError(f"Expected marker at offset {pos}.")
        marker = buf[pos + 1]
        pos += 2
        if marker == _EOI:
            break
        if marker == 0xFF:      # fill byte
            pos -= 1
            continue
        if marker in _OTHER_SOF:
            raise JpegLSError(
                f"SOF{marker - 0xC0} is not JPEG-LS (expected SOF55); "
                "use the matching codec for this process.")
        if marker == _SOF55:
            length = _u16(buf, pos)
            p = buf[pos + 2]
            y = _u16(buf, pos + 3)
            x = _u16(buf, pos + 5)
            nf = buf[pos + 7]
            if not (2 <= p <= 16):
                raise JpegLSError(f"JPEG-LS precision P={p} outside 2..16.")
            if y == 0:
                raise JpegLSError("DNL-deferred height (Y=0) unsupported.")
            if nf < 1 or length != 8 + 3 * nf:
                raise JpegLSError("Malformed SOF55 segment.")
            for c in range(nf):
                hv = buf[pos + 9 + 3 * c]
                if hv != 0x11:
                    raise JpegLSError(
                        "Subsampled JPEG-LS components unsupported.")
            frame = _Frame(p, y, x, nf)
            pos += length
            continue
        if marker == _LSE:
            length = _u16(buf, pos)
            lse_id = buf[pos + 2]
            if lse_id == 1:
                if length != 13:
                    raise JpegLSError("Malformed LSE (ID 1) segment.")
                maxval_override = _u16(buf, pos + 3)
                t1 = _u16(buf, pos + 5)
                t2 = _u16(buf, pos + 7)
                t3 = _u16(buf, pos + 9)
                reset = _u16(buf, pos + 11)
                presets = (t1, t2, t3, reset or 64)
            elif lse_id in (2, 3):
                raise JpegLSError(
                    "JPEG-LS mapping tables (LSE ID 2/3) unsupported.")
            elif lse_id == 4:
                raise JpegLSError(
                    "JPEG-LS oversize image dimensions (LSE ID 4) "
                    "unsupported.")
            else:
                raise JpegLSError(f"Unknown LSE ID {lse_id}.")
            pos += length
            continue
        if marker == _DRI:
            length = _u16(buf, pos)
            restart_interval = _u16(buf, pos + 2)
            pos += length
            continue
        if marker == _SOS:
            if frame is None:
                raise JpegLSError("SOS before SOF55.")
            length = _u16(buf, pos)
            ns = buf[pos + 2]
            if length != 6 + 2 * ns:
                raise JpegLSError("Malformed SOS segment.")
            near = buf[pos + 3 + 2 * ns]
            ilv = buf[pos + 4 + 2 * ns]
            al = buf[pos + 5 + 2 * ns]
            if al & 0x0F:
                raise JpegLSError("JPEG-LS point transform unsupported.")
            if ns != 1:
                if ilv == 0:
                    raise JpegLSError("Malformed scan: ILV 0 requires "
                                      "one component per scan.")
                raise JpegLSError(
                    f"Interleaved JPEG-LS scans (ILV={ilv}) unsupported; "
                    "DICOM grayscale uses single-component scans.")
            maxval = maxval_override if maxval_override is not None \
                else (1 << frame.precision) - 1
            if not (0 < maxval < (1 << 16)):
                raise JpegLSError(f"Invalid MAXVAL {maxval}.")
            if near < 0 or near > min(255, maxval // 2):
                raise JpegLSError(f"Invalid NEAR {near}.")
            near_seen = max(near_seen, near)
            if presets is not None:
                t1, t2, t3, reset = presets
                d1, d2, d3 = default_thresholds(maxval, near)
                t1, t2, t3 = t1 or d1, t2 or d2, t3 or d3
                if not (near + 1 <= t1 <= t2 <= t3 <= maxval):
                    raise JpegLSError("Invalid LSE thresholds.")
            else:
                t1, t2, t3 = default_thresholds(maxval, near)
                reset = 64
            params = _Params(maxval, near, t1, t2, t3, reset)
            pos += length
            plane, pos = _decode_scan_segments(
                buf, pos, frame, params, restart_interval)
            planes.append(plane)
            continue
        if marker == _DNL:
            raise JpegLSError("DNL marker unsupported.")
        if 0xD0 <= marker <= 0xD7:
            raise JpegLSError("Restart marker outside an entropy segment.")
        if marker == _COM or 0xE0 <= marker <= 0xEF:
            length = _u16(buf, pos)
            pos += length
            continue
        raise JpegLSError(f"Unexpected marker 0xFF{marker:02X}.")

    if frame is None or not planes:
        raise JpegLSError("JPEG-LS stream contains no image scan.")
    if len(planes) != frame.ncomp:
        raise JpegLSError(
            f"Expected {frame.ncomp} component scans, found {len(planes)}.")
    if frame.ncomp == 1:
        img = planes[0]
    else:
        img = np.stack(planes, axis=-1)
    return img, frame.precision, near_seen


def _decode_scan_segments(buf: bytes, pos: int, frame: _Frame,
                          params: _Params,
                          restart_interval: int) -> Tuple[np.ndarray, int]:
    """One component's entropy data, split at restart markers."""
    height, width = frame.height, frame.width
    if restart_interval <= 0:
        plane, pos = _decode_scan_native_or_python(
            buf, pos, width, height, params)
        return plane, pos
    rows_done = 0
    chunks = []
    expect_rst = 0
    while rows_done < height:
        rows = min(restart_interval, height - rows_done)
        part, pos = _decode_scan_native_or_python(
            buf, pos, width, rows, params)
        chunks.append(part)
        rows_done += rows
        if rows_done < height:
            if pos + 2 > len(buf) or buf[pos] != 0xFF or \
                    not (0xD0 <= buf[pos + 1] <= 0xD7):
                raise JpegLSError("Missing restart marker.")
            if buf[pos + 1] - _RST0 != expect_rst:
                raise JpegLSError(
                    f"Restart marker out of sequence at offset {pos}.")
            expect_rst = (expect_rst + 1) & 7
            pos += 2
    return np.concatenate(chunks, axis=0), pos


def _native():
    """The host C++ loops, or None where the caller asked for the Python
    coder (``MDX_NO_NATIVE``).  A failed build raises; it never falls back."""
    return None if _native_mod.disabled() else _native_mod


def _decode_scan_native_or_python(buf: bytes, pos: int, width: int,
                                  height: int, params: _Params
                                  ) -> Tuple[np.ndarray, int]:
    nat = _native()
    if nat is not None:
        return nat.jpegls_decode(buf, pos, width, height, params)
    return _decode_scan_python(buf, pos, width, height, params)


# ---------------------------------------------------------------- encode --


def encode(image: np.ndarray, precision: Optional[int] = None,
           near: int = 0, restart_rows: int = 0) -> bytes:
    """Encode a single-component image as a JPEG-LS codestream.

    ``image`` is ``[H, W]`` of non-negative integers fitting
    ``precision`` bits (default: minimal precision that fits the data,
    at least 2).  ``near=0`` is lossless (`.4.80`); ``near>0`` is
    near-lossless (`.4.81`).  ``restart_rows`` emits DRI/RSTn every that
    many lines.
    """
    img = np.asarray(image)
    if img.ndim != 2:
        raise JpegLSError("encode() takes a single [H, W] component.")
    if img.size == 0:
        raise JpegLSError("Cannot encode an empty image.")
    if not np.issubdtype(img.dtype, np.integer):
        raise JpegLSError("JPEG-LS encodes integer samples.")
    arr = img.astype(np.int64)
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0:
        raise JpegLSError("Samples must be unsigned (two's-complement "
                          "mapping happens in the DICOM layer).")
    if precision is None:
        precision = max(2, _ceil_log2(hi + 1) if hi > 0 else 2)
    if not (2 <= precision <= 16):
        raise JpegLSError(f"Precision {precision} outside 2..16.")
    if hi >= (1 << precision):
        raise JpegLSError(
            f"Sample {hi} does not fit precision {precision}.")
    height, width = arr.shape
    if height > 0xFFFF or width > 0xFFFF:
        raise JpegLSError("Image dimensions exceed 16 bits.")
    maxval = (1 << precision) - 1
    if near < 0 or near > min(255, maxval // 2):
        raise JpegLSError(f"Invalid NEAR {near}.")
    t1, t2, t3 = default_thresholds(maxval, near)
    params = _Params(maxval, near, t1, t2, t3, 64)

    out = bytearray()
    out += bytes((0xFF, _SOI))
    out += bytes((0xFF, _SOF55))
    out += struct.pack(">HBHHB", 11, precision, height, width, 1)
    out += bytes((1, 0x11, 0))          # C1, H1V1, Tq1
    if restart_rows > 0:
        out += bytes((0xFF, _DRI)) + struct.pack(">HH", 4, restart_rows)
    out += bytes((0xFF, _SOS))
    out += struct.pack(">HB", 8, 1)
    out += bytes((1, 0))                # Cs1, mapping table 0
    out += bytes((near, 0, 0))          # NEAR, ILV=0, Ah/Al=0

    if restart_rows <= 0:
        out += _encode_scan_native_or_python(arr, params)
    else:
        rst = 0
        for r0 in range(0, height, restart_rows):
            part = arr[r0:r0 + restart_rows]
            out += _encode_scan_native_or_python(part, params)
            if r0 + restart_rows < height:
                out += bytes((0xFF, _RST0 + rst))
                rst = (rst + 1) & 7
    out += bytes((0xFF, _EOI))
    return bytes(out)


def _encode_scan_native_or_python(plane: np.ndarray,
                                  params: _Params) -> bytes:
    nat = _native()
    if nat is not None:
        return nat.jpegls_encode(plane, params)
    return _encode_scan_python(plane, params)
