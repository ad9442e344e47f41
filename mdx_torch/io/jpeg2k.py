"""JPEG 2000 Part 1 codec — transfer syntaxes `.4.90` / `.4.91`.

The port's copy of ``mdx/io/jpeg2k.py``; CPU tests hold its decode bit-equal
(pixels, precision, signedness) and its encode byte-equal to the original's,
with the same errors.  Decode covers the full `.4.90`/`.4.91` surface below;
write support covers `.4.90` only (reversible 5/3, :func:`encode`), as in
the JAX package, which writes no lossy medical image either.

Implemented surface:

* codestream parsing (SOC/SIZ/COD/COC/QCD/QCC/SOT/SOD/EOC; COM/CRG/TLM/
  PLM/PLT skipped), raw codestream or JP2 container (`jp2c` box);
* multiple tiles and tile-parts, arbitrary image/tile offsets;
* all five progression orders (LRCP/RLCP/RPCL/PCRL/CPRL), multiple
  quality layers, precinct partitions, SOP/EPH markers;
* packet headers (B.10): inclusion + zero-bitplane tag trees, coding
  pass counts, Lblock length signalling, header bit-stuffing;
* EBCOT Tier-1 (Annex D): MQ arithmetic decoder (Annex C state table),
  significance/refinement/cleanup passes with the standard context
  tables, and the code-block style flags — selective bypass (raw
  segments), predictable termination (decoder-irrelevant), RESET,
  TERMALL, vertically-causal contexts, segmentation symbols;
* dequantisation (reversible / scalar-derived / scalar-expounded) with
  in-loop half-LSB reconstruction of truncated magnitudes, exactly the
  ecosystem decoders' rule (value gains 2^(b-1) at the plane where its
  last coding event happened; full reversible decode is exact);
* inverse DWT: 5/3 reversible integer lifting and 9/7 irreversible
  float lifting (Annex F, NumPy float64, the same operations in the same
  order as the JAX package, so irreversible decodes are bit-equal too),
  arbitrary decomposition levels and odd tile/component offsets;
* inverse multiple-component transform: RCT (reversible) and ICT
  (YCbCr); DC level shift; depths to 16 bits; signed components.

Not implemented (raise ``Jpeg2kError`` naming the feature): ROI (RGN),
progression-order change (POC), packed packet headers (PPM/PPT),
per-tile coding-style overrides, component depths over 16, and
subsampled components (XRsiz/YRsiz > 1 — DICOM forbids subsampling for
the JPEG 2000 syntaxes, PS3.5 A.4.4).

The Tier-1 loops of one code-block (decode and encode) run in the port's
host C++ library (:mod:`mdx_torch.io.native`: ``jpeg2k_t1_block``,
``jpeg2k_t1_encode``); ``_t1_decode_block`` and ``_t1_encode_block`` here
are their plain versions, run only under ``MDX_NO_NATIVE=1``.  A failed
build of the library raises ``NativeBuildError``: there is no quiet
fallback.  Code-blocks are independent, so a component's blocks are
spread over a thread pool (:func:`_map_parallel`, capped by
``MDX_IO_THREADS``); ctypes releases the GIL for each call.  That pool
nests inside the DICOM reader's frame pool
(``mdx_torch.io.dicom._map_frames``), as in the JAX package: a multi-frame
file may run up to 16 frame threads each with up to 16 block threads.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from mdx_torch.io import native as _native

__all__ = ["decode", "Jpeg2kError"]


class Jpeg2kError(ValueError):
    """Malformed or unsupported JPEG 2000 stream."""


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _floor_log2(n: int) -> int:
    return max(n.bit_length() - 1, 0)


# ---------------------------------------------------------------------------
# MQ arithmetic decoder — ISO 15444-1 Annex C
# ---------------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH) — Table C.2
_MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# Tier-1 context numbering (local convention, used consistently by the
# Python oracle and the native kernel): 0-8 significance, 9-13 sign,
# 14-16 magnitude refinement, 17 run-length, 18 uniform.
_CTX_RL = 17
_CTX_UNI = 18
_N_CTX = 19


def _fresh_contexts() -> list:
    """[index, MPS] per context — initial states per Table D.7."""
    cx = [[0, 0] for _ in range(_N_CTX)]
    cx[0][0] = 4
    cx[_CTX_RL][0] = 3
    cx[_CTX_UNI][0] = 46
    return cx


class _MQDecoder:
    """Annex C MQ decoder over one codeword segment."""

    __slots__ = ("data", "bp", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data = data
        self.bp = 0
        b0 = data[0] if data else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        d, bp = self.data, self.bp
        b = d[bp] if bp < len(d) else 0xFF
        if b == 0xFF:
            b1 = d[bp + 1] if bp + 1 < len(d) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = d[bp + 1] if bp + 1 < len(d) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: list) -> int:
        i, mps = cx
        qe, nmps, nlps, switch = _MQ_TABLE[i]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            if self.a < qe:           # MPS exchange
                d = mps
                cx[0] = nmps
            else:
                d = 1 - mps
                if switch:
                    cx[1] = 1 - mps
                cx[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return mps
            if self.a < qe:           # conditional exchange
                d = 1 - mps
                if switch:
                    cx[1] = 1 - mps
                cx[0] = nlps
            else:
                d = mps
                cx[0] = nmps
        a, c, ct = self.a, self.c, self.ct
        while True:
            if ct == 0:
                self.c, self.ct = c, ct
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a & 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d


class _RawReader:
    """Raw (bypass) bit reader with 0xFF bit-unstuffing — D.8.2."""

    __slots__ = ("data", "pos", "buf", "cnt", "last")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.cnt = 0
        self.last = 0

    def bit(self) -> int:
        if self.cnt == 0:
            prev_ff = self.last == 0xFF
            if self.pos < len(self.data):
                self.buf = self.data[self.pos]
                self.pos += 1
            else:
                self.buf = 0xFF
            self.last = self.buf
            self.cnt = 7 if prev_ff else 8
        self.cnt -= 1
        return (self.buf >> self.cnt) & 1


# ---------------------------------------------------------------------------
# Packet-header bit reader and tag trees (B.10)
# ---------------------------------------------------------------------------


class _HeaderReader:
    __slots__ = ("data", "pos", "buf", "cnt")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.cnt = 0

    def bit(self) -> int:
        if self.cnt == 0:
            if self.pos >= len(self.data):
                raise Jpeg2kError("Truncated packet header.")
            prev = self.buf
            self.buf = self.data[self.pos]
            self.pos += 1
            self.cnt = 7 if prev == 0xFF else 8
        self.cnt -= 1
        return (self.buf >> self.cnt) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """End the packet header: if it ends on a 0xFF byte the next
        byte carries a stuffed 0 bit that belongs to the header."""
        if self.cnt == 0 and self.buf == 0xFF:
            if self.pos < len(self.data):
                self.pos += 1
        self.buf = 0
        self.cnt = 0
        return self.pos


class _TagNode:
    __slots__ = ("parent", "low", "value", "known")

    def __init__(self, parent):
        self.parent = parent
        self.low = 0
        self.value = 0
        self.known = False


class _TagTree:
    """B.10.2 tag tree (quad-tree of minima)."""

    def __init__(self, w: int, h: int):
        levels = []
        while True:
            levels.append((w, h))
            if w <= 1 and h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        # build top-down so parents exist
        self.nodes: List[List[_TagNode]] = []
        prev = None
        for (lw, lh) in reversed(levels):
            cur = []
            for y in range(lh):
                for x in range(lw):
                    parent = None
                    if prev is not None:
                        pw = (lw + 1) // 2
                        parent = prev[(y // 2) * pw + (x // 2)]
                    cur.append(_TagNode(parent))
            self.nodes.append(cur)
            prev = cur
        self.leaf_w = levels[0][0]

    def _leaf(self, x: int, y: int) -> _TagNode:
        return self.nodes[-1][y * self.leaf_w + x]

    def decode(self, rd: _HeaderReader, x: int, y: int,
               threshold: int) -> int:
        """Decode leaf (x, y) information up to ``threshold``; returns
        the leaf's current lower bound (== value if known).  A return
        ≥ threshold means the value is not yet known below threshold."""
        stack = []
        node = self._leaf(x, y)
        while node is not None:
            stack.append(node)
            node = node.parent
        low = 0
        for node in reversed(stack):
            if node.low < low:
                node.low = low
            while not node.known and node.low < threshold:
                if rd.bit():
                    node.known = True
                    node.value = node.low
                else:
                    node.low += 1
            low = node.low
        leaf = stack[0]
        return leaf.value if leaf.known else leaf.low

    def decode_full(self, rd: _HeaderReader, x: int, y: int) -> int:
        """Decode until the leaf value is fully known."""
        t = 1
        while True:
            v = self.decode(rd, x, y, t)
            if self._leaf(x, y).known:
                return v
            t = v + 1


# ---------------------------------------------------------------------------
# Codestream structures
# ---------------------------------------------------------------------------


@dataclass
class _Comp:
    depth: int
    signed: bool


@dataclass
class _Cod:
    prog: int = 0          # 0 LRCP, 1 RLCP, 2 RPCL, 3 PCRL, 4 CPRL
    layers: int = 1
    mct: int = 0
    levels: int = 5
    cbw: int = 6           # code-block width exponent (xcb)
    cbh: int = 6
    cb_style: int = 0
    transform: int = 0     # 0 = 9/7 irreversible, 1 = 5/3 reversible
    precincts: Optional[List[Tuple[int, int]]] = None  # (PPx, PPy)/res
    sop: bool = False
    eph: bool = False

    def ppx(self, r: int) -> int:
        if self.precincts is None:
            return 15
        return self.precincts[min(r, len(self.precincts) - 1)][0]

    def ppy(self, r: int) -> int:
        if self.precincts is None:
            return 15
        return self.precincts[min(r, len(self.precincts) - 1)][1]


@dataclass
class _Qcd:
    style: int = 0         # 0 none (reversible), 1 derived, 2 expounded
    guard: int = 2
    exps: List[int] = field(default_factory=list)
    mants: List[int] = field(default_factory=list)


# code-block coding-style flags (Table A.19)
_CB_LAZY = 0x01
_CB_RESET = 0x02
_CB_TERMALL = 0x04
_CB_VSC = 0x08
_CB_SEGSYM = 0x20


@dataclass
class _Block:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    lblock: int = 3
    zbp: int = 0
    npasses: int = 0
    chunks: List[Tuple[bytes, int]] = field(default_factory=list)
    # transport chunks: (bytes, passes covered), in stream order


@dataclass
class _Band:
    btype: int             # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    exp: int = 0
    mant: int = 0
    blocks: Dict[int, List[List[_Block]]] = field(default_factory=dict)
    incl_tree: Dict[int, _TagTree] = field(default_factory=dict)
    zbp_tree: Dict[int, _TagTree] = field(default_factory=dict)


@dataclass
class _Res:
    r: int
    x0: int
    y0: int
    x1: int
    y1: int
    bands: List[_Band] = field(default_factory=list)
    npx: int = 0
    npy: int = 0


# ---------------------------------------------------------------------------
# Tier-1 — EBCOT code-block decoding (Annex D), openjpeg-compatible
# in-loop half-LSB reconstruction
# ---------------------------------------------------------------------------


def _sig_ctx_tables():
    """[h, v, d] → significance context, per Table D.1."""
    ll = np.zeros((3, 3, 5), np.int8)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if h == 2:
                    c = 8
                elif h == 1:
                    c = 7 if v >= 1 else (6 if d >= 1 else 5)
                elif v == 2:
                    c = 4
                elif v == 1:
                    c = 3
                elif d >= 2:
                    c = 2
                else:
                    c = d
                ll[h, v, d] = c
    hl = np.transpose(ll, (1, 0, 2)).copy()
    hh = np.zeros((3, 3, 5), np.int8)
    for h in range(3):
        for v in range(3):
            hv = min(h + v, 2)
            for d in range(5):
                if d >= 3:
                    c = 8
                elif d == 2:
                    c = 7 if hv >= 1 else 6
                elif d == 1:
                    c = 5 if hv >= 2 else (4 if hv == 1 else 3)
                else:
                    c = 2 if hv >= 2 else hv
                hh[h, v, d] = c
    return ll, hl, hh


_SIG_LL, _SIG_HL, _SIG_HH = _sig_ctx_tables()

# (h_contrib, v_contrib) → (sign context, xor) — Table D.3/D.4
_SIGN_CTX = {}
for _hc in (-1, 0, 1):
    for _vc in (-1, 0, 1):
        if _hc == 1:
            _t = {1: (13, 0), 0: (12, 0), -1: (11, 0)}[_vc]
        elif _hc == 0:
            _t = {1: (10, 0), 0: (9, 0), -1: (10, 1)}[_vc]
        else:
            _t = {1: (11, 1), 0: (12, 1), -1: (13, 1)}[_vc]
        _SIGN_CTX[(_hc, _vc)] = _t


def _pass_kind(p: int, numbps: int) -> Tuple[int, int]:
    """pass index → (kind, bitplane); kind 0 sig, 1 ref, 2 cleanup.
    Pass 0 is the cleanup of the most significant plane."""
    if p == 0:
        return 2, numbps - 1
    q, t = divmod(p - 1, 3)
    return t, numbps - 2 - q


def _codeword_segments(blk: _Block, cb_style: int, numbps: int):
    """Regroup transport chunks into terminated codeword segments:
    [(bytes, first_pass_index, npasses, raw)].

    * plain: one segment holding every pass;
    * TERMALL: every pass its own segment;
    * LAZY: terminated at each MQ↔raw boundary (raw = sig+ref passes
      from the 5th most significant bitplane, i.e. pass index ≥ 10).
    Chunks belonging to one codeword segment concatenate across packets.
    """
    lazy = bool(cb_style & _CB_LAZY)
    termall = bool(cb_style & _CB_TERMALL)

    def is_raw(p):
        return lazy and p >= 10 and _pass_kind(p, numbps)[0] != 2

    def boundary_after(p):
        if termall:
            return True
        if lazy and p >= 9:
            return is_raw(p) != is_raw(p + 1)
        return False

    # flatten chunk bytes against pass indices
    segs = []
    cur = bytearray()
    first = 0
    p = 0
    for data, npasses in blk.chunks:
        cur += data
        for _ in range(npasses):
            if boundary_after(p):
                segs.append((bytes(cur), first, p - first + 1,
                             is_raw(p)))
                cur = bytearray()
                first = p + 1
            p += 1
        # a terminated segment's bytes cannot spill into the next chunk
        # when a boundary fell exactly at the chunk end — handled above;
        # otherwise the codeword continues into the next chunk
    if p > first or cur:
        segs.append((bytes(cur), first, p - first, is_raw(first)))
    return [s for s in segs if s[2] > 0]


def _t1_decode_block(chunks: List[Tuple[bytes, int]], btype: int,
                     mb: int, zbp: int, total: int, w: int, h: int,
                     cb_style: int) -> np.ndarray:
    """Pure-Python Tier-1 oracle: decode one code-block's coding passes
    → int32 [h, w] signed values with embedded half-LSB reconstruction
    (exact when the lowest plane is fully decoded)."""
    numbps = mb - zbp
    if total <= 0 or numbps <= 0 or not chunks:
        return np.zeros((h, w), np.int32)

    blk = _Block(0, 0, w, h)
    blk.chunks = chunks
    segments = _codeword_segments(blk, cb_style, numbps)

    sig = np.zeros((h + 2, w + 2), np.uint8)     # 1-pixel apron
    vis = np.zeros((h, w), np.uint8)
    refined = np.zeros((h, w), np.uint8)
    data = np.zeros((h, w), np.int32)

    if btype == 1:
        sig_tab = _SIG_HL
    elif btype == 3:
        sig_tab = _SIG_HH
    else:
        sig_tab = _SIG_LL

    vsc = bool(cb_style & _CB_VSC)
    segsym = bool(cb_style & _CB_SEGSYM)
    reset = bool(cb_style & _CB_RESET)
    termall = bool(cb_style & _CB_TERMALL)
    lazy = bool(cb_style & _CB_LAZY)

    cx = _fresh_contexts()

    def neigh(x, y):
        """(hcnt, vcnt, dcnt) with the VSC stripe mask; x,y are 0-based
        block coords, apron handles the borders."""
        xs, ys = x + 1, y + 1
        d_ok = 1
        if vsc and (y % 4) == 3:
            d_ok = 0
        l = sig[ys, xs - 1]
        r = sig[ys, xs + 1]
        u = sig[ys - 1, xs]
        d = sig[ys + 1, xs] * d_ok
        hcnt = int(l) + int(r)
        vcnt = int(u) + int(d)
        dcnt = (int(sig[ys - 1, xs - 1]) + int(sig[ys - 1, xs + 1])
                + (int(sig[ys + 1, xs - 1]) + int(sig[ys + 1, xs + 1]))
                * d_ok)
        return hcnt, vcnt, dcnt

    def sign_ctx(x, y):
        xs, ys = x + 1, y + 1
        d_ok = 1
        if vsc and (y % 4) == 3:
            d_ok = 0
        hc = 0
        if sig[ys, xs - 1]:
            hc += -1 if (x > 0 and data[y, x - 1] < 0) else 1
        if sig[ys, xs + 1]:
            hc += -1 if (x < w - 1 and data[y, x + 1] < 0) else 1
        hc = max(-1, min(1, hc))
        vc = 0
        if sig[ys - 1, xs]:
            vc += -1 if (y > 0 and data[y - 1, x] < 0) else 1
        if sig[ys + 1, xs] and d_ok:
            vc += -1 if (y < h - 1 and data[y + 1, x] < 0) else 1
        vc = max(-1, min(1, vc))
        return _SIGN_CTX[(hc, vc)]

    mq: Optional[_MQDecoder] = None
    raw: Optional[_RawReader] = None

    def set_sig(x, y, neg, bp):
        one = 1 << bp
        val = one | (one >> 1)
        data[y, x] = -val if neg else val
        sig[y + 1, x + 1] = 1

    def pass_sig(bp, rawpass):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y + 1, x + 1]:
                        continue
                    hc, vc_, dc = neigh(x, y)
                    if hc + vc_ + dc == 0:
                        continue
                    if rawpass:
                        bit = raw.bit()
                    else:
                        ctx = int(sig_tab[min(hc, 2), min(vc_, 2),
                                          min(dc, 4)])
                        bit = mq.decode(cx[ctx])
                    if bit:
                        if rawpass:
                            s = raw.bit()
                        else:
                            ctx, xor = sign_ctx(x, y)
                            s = mq.decode(cx[ctx]) ^ xor
                        set_sig(x, y, s, bp)
                    vis[y, x] = 1

    def pass_ref(bp, rawpass):
        one = 1 << bp
        poshalf = one >> 1
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y + 1, x + 1] or vis[y, x]:
                        continue
                    if rawpass:
                        bit = raw.bit()
                    else:
                        if refined[y, x]:
                            ctx = 16
                        else:
                            hc, vc_, dc = neigh(x, y)
                            ctx = 15 if hc + vc_ + dc else 14
                        bit = mq.decode(cx[ctx])
                    # openjpeg-compatible refinement: +half on a 1 bit,
                    # −half on a 0 (plane 0: +0 / −1 — exact finish)
                    neghalf = poshalf if poshalf else 1
                    delta = poshalf if bit else -neghalf
                    if data[y, x] < 0:
                        data[y, x] -= delta
                    else:
                        data[y, x] += delta
                    refined[y, x] = 1
                    vis[y, x] = 1

    def pass_cleanup(bp):
        for y0 in range(0, h, 4):
            for x in range(w):
                y = y0
                while y < min(y0 + 4, h):
                    if y == y0 and y0 + 4 <= h:
                        ok = True
                        for yy in range(y0, y0 + 4):
                            if sig[yy + 1, x + 1] or vis[yy, x]:
                                ok = False
                                break
                            hc, vc_, dc = neigh(x, yy)
                            if hc + vc_ + dc:
                                ok = False
                                break
                        if ok:
                            if not mq.decode(cx[_CTX_RL]):
                                y = y0 + 4
                                continue
                            pos = (mq.decode(cx[_CTX_UNI]) << 1) | \
                                mq.decode(cx[_CTX_UNI])
                            y = y0 + pos
                            ctx, xor = sign_ctx(x, y)
                            s = mq.decode(cx[ctx]) ^ xor
                            set_sig(x, y, s, bp)
                            y += 1
                            continue
                    if sig[y + 1, x + 1] or vis[y, x]:
                        y += 1
                        continue
                    hc, vc_, dc = neigh(x, y)
                    ctx = int(sig_tab[min(hc, 2), min(vc_, 2),
                                      min(dc, 4)])
                    if mq.decode(cx[ctx]):
                        ctx, xor = sign_ctx(x, y)
                        s = mq.decode(cx[ctx]) ^ xor
                        set_sig(x, y, s, bp)
                    y += 1

    p_done = 0
    for seg_bytes, first, npasses, rawseg in segments:
        if p_done >= total:
            break
        if rawseg:
            raw = _RawReader(seg_bytes)
            mq = None
        else:
            # without termination flags the single MQ codeword spans
            # every pass; with them, restart per segment
            if mq is None or termall or lazy:
                mq = _MQDecoder(seg_bytes)
            raw = None
        for p in range(first, min(first + npasses, total)):
            kind, bp = _pass_kind(p, numbps)
            if bp < 0:
                p_done = total
                break
            if reset and not rawseg:
                cx = _fresh_contexts()
            if kind == 0:
                pass_sig(bp, rawseg)
            elif kind == 1:
                pass_ref(bp, rawseg)
            else:
                pass_cleanup(bp)
                if segsym:
                    s = 0
                    for _ in range(4):
                        s = (s << 1) | mq.decode(cx[_CTX_UNI])
                    if s != 0x0A:
                        raise Jpeg2kError(
                            "Segmentation symbol mismatch "
                            "(corrupt entropy data).")
                vis[:] = 0
            p_done += 1
    return data


# ---------------------------------------------------------------------------
# Inverse DWT — Annex F
# ---------------------------------------------------------------------------


def _reflect(j: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample symmetric extension indices (F.3.7): period 2n−2."""
    if n == 1:
        return np.zeros_like(j)
    p = 2 * n - 2
    j = np.abs(j) % p
    return np.where(j < n, j, p - j)


def _sr_1d_53(y: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    """5/3 inverse lifting on interval [i0, i1) along ``axis``;
    ``y`` holds exactly the samples of [i0, i1)."""
    n = i1 - i0
    if n == 1:
        return y // 2 if i0 % 2 == 1 else y
    y = np.moveaxis(y, axis, 0)
    ext = y[_reflect(np.arange(-2, n + 2), n)]
    off = i0 - 2          # absolute index of ext[0]
    x = ext.copy()
    # even samples: x(2n) = y(2n) − ⌊(y(2n−1) + y(2n+1) + 2)/4⌋
    ev0 = off + ((-off) % 2)
    evs = np.arange(ev0, i1 + 2, 2)
    k = evs - off
    k = k[(k >= 1) & (k + 1 < ext.shape[0])]
    x[k] = ext[k] - ((ext[k - 1] + ext[k + 1] + 2) >> 2)
    # odd samples: x(2n+1) = y(2n+1) + ⌊(x(2n) + x(2n+2))/2⌋
    od0 = off + ((1 - off) % 2)
    ods = np.arange(od0, i1 + 1, 2)
    k = ods - off
    k = k[(k >= 1) & (k + 1 < ext.shape[0])]
    x[k] = ext[k] + ((x[k - 1] + x[k + 1]) >> 1)
    return np.moveaxis(x[2:2 + n], 0, axis)


_K97 = 1.230174104914001
_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971


def _sr_1d_97(y: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    """9/7 inverse lifting (float) on [i0, i1) along ``axis``."""
    n = i1 - i0
    if n == 1:
        return y * 2.0 if i0 % 2 == 1 else y
    y = np.moveaxis(y, axis, 0).astype(np.float64)
    ext = y[_reflect(np.arange(-4, n + 4), n)]
    off = i0 - 4
    idx = np.arange(off, off + ext.shape[0])
    even = (idx % 2) == 0
    shape = (slice(None),) + (None,) * (ext.ndim - 1)
    x = np.where(even[shape], ext * _K97, ext / _K97)

    def lift(arr, coef, parity):
        res = arr.copy()
        t0 = off + ((parity - off) % 2)
        tid = np.arange(t0, off + arr.shape[0], 2)
        k = tid - off
        k = k[(k >= 1) & (k + 1 < arr.shape[0])]
        res[k] = arr[k] + coef * (arr[k - 1] + arr[k + 1])
        return res

    # inverse lifting: undo δ, γ, β, α (signs folded into constants)
    x = lift(x, -_D97, 0)
    x = lift(x, -_G97, 1)
    x = lift(x, -_B97, 0)
    x = lift(x, -_A97, 1)
    return np.moveaxis(x[4:4 + n], 0, axis)


def _inverse_dwt(ll: np.ndarray, details: list, rects: list,
                 reversible: bool) -> np.ndarray:
    """Multi-level 2D inverse: interleave by absolute coordinate parity,
    then horizontal and vertical 1D synthesis (F.3.4)."""
    cur = ll
    for (hl, lh, hh), ((ry0, rx0), (ry1, rx1)) in zip(details, rects):
        h, w = ry1 - ry0, rx1 - rx0
        dtype = np.int64 if reversible else np.float64
        a = np.zeros((h, w), dtype)
        ys = np.arange(ry0, ry1)
        xs = np.arange(rx0, rx1)
        even_y = (ys % 2 == 0)
        even_x = (xs % 2 == 0)
        if cur.size:
            a[np.ix_(even_y, even_x)] = cur
        if hl.size:
            a[np.ix_(even_y, ~even_x)] = hl
        if lh.size:
            a[np.ix_(~even_y, even_x)] = lh
        if hh.size:
            a[np.ix_(~even_y, ~even_x)] = hh
        sr = _sr_1d_53 if reversible else _sr_1d_97
        if w > 0:
            a = sr(a, rx0, rx1, axis=1)
        if h > 0:
            a = sr(a, ry0, ry1, axis=0)
        cur = a
    return cur


# ---------------------------------------------------------------------------
# Codestream parsing
# ---------------------------------------------------------------------------

_SOC = 0xFF4F
_SIZ = 0xFF51
_COD = 0xFF52
_COC = 0xFF53
_TLM = 0xFF55
_PLM = 0xFF57
_PLT = 0xFF58
_QCD = 0xFF5C
_QCC = 0xFF5D
_RGN = 0xFF5E
_POC = 0xFF5F
_PPM = 0xFF60
_PPT = 0xFF61
_CRG = 0xFF63
_COM = 0xFF64
_SOT = 0xFF90
_SOP = 0xFF91
_EPH = 0xFF92
_SOD = 0xFF93
_EOC = 0xFFD9


def _u16(b, p):
    if p + 2 > len(b):
        raise Jpeg2kError("Truncated codestream.")
    return struct.unpack_from(">H", b, p)[0]


def _u32(b, p):
    if p + 4 > len(b):
        raise Jpeg2kError("Truncated codestream.")
    return struct.unpack_from(">I", b, p)[0]


def _parse_cod(body: bytes) -> _Cod:
    if len(body) < 10:
        raise Jpeg2kError("Truncated COD segment.")
    scod = body[0]
    prog = body[1]
    layers = _u16(body, 2)
    mct = body[4]
    levels = body[5]
    cbw = (body[6] & 0x0F) + 2
    cbh = (body[7] & 0x0F) + 2
    cb_style = body[8]
    transform = body[9]
    precincts = None
    if scod & 0x01:
        if len(body) < 11 + levels:
            raise Jpeg2kError("Truncated COD precinct list.")
        precincts = [(body[i] & 0x0F, body[i] >> 4)
                     for i in range(10, 11 + levels)]
    if prog > 4:
        raise Jpeg2kError(f"Unknown progression order {prog}.")
    if layers < 1:
        raise Jpeg2kError("COD declares zero layers.")
    if cbw > 10 or cbh > 10 or cbw + cbh > 12:
        raise Jpeg2kError("Illegal code-block size.")
    if transform not in (0, 1):
        raise Jpeg2kError(f"Unknown wavelet transform {transform}.")
    return _Cod(prog=prog, layers=layers, mct=mct, levels=levels,
                cbw=cbw, cbh=cbh, cb_style=cb_style,
                transform=transform, precincts=precincts,
                sop=bool(scod & 0x02), eph=bool(scod & 0x04))


def _parse_qcd(body: bytes) -> _Qcd:
    if not body:
        raise Jpeg2kError("Empty QCD segment.")
    sqcd = body[0]
    style = sqcd & 0x1F
    q = _Qcd(guard=sqcd >> 5)
    if style == 0:
        q.style = 0
        q.exps = [b >> 3 for b in body[1:]]
    elif style == 1:
        q.style = 1
        v = _u16(body, 1)
        q.exps = [v >> 11]
        q.mants = [v & 0x7FF]
    elif style == 2:
        q.style = 2
        vals = [_u16(body, 1 + 2 * i)
                for i in range((len(body) - 1) // 2)]
        q.exps = [v >> 11 for v in vals]
        q.mants = [v & 0x7FF for v in vals]
    else:
        raise Jpeg2kError(f"Unknown quantisation style {style}.")
    return q


_JP2_SIG = bytes.fromhex("0000000c6a5020200d0a870a")


def _extract_codestream(buf: bytes) -> bytes:
    """Raw codestream passthrough, or the `jp2c` box of a JP2 file."""
    if buf[:2] == b"\xff\x4f":
        return buf
    if buf[:12] == _JP2_SIG:
        pos = 12
        while pos + 8 <= len(buf):
            lbox = _u32(buf, pos)
            tbox = buf[pos + 4:pos + 8]
            hdr = 8
            if lbox == 1:
                lbox = struct.unpack_from(">Q", buf, pos + 8)[0]
                hdr = 16
            elif lbox == 0:
                lbox = len(buf) - pos
            if lbox < hdr:
                raise Jpeg2kError("Corrupt JP2 box length.")
            if tbox == b"jp2c":
                return buf[pos + hdr:pos + lbox]
            pos += lbox
        raise Jpeg2kError("JP2 container has no codestream box.")
    raise Jpeg2kError("Not a JPEG 2000 codestream (missing SOC).")


class _Decoder:
    def __init__(self, buf: bytes):
        self.buf = _extract_codestream(buf)
        self.siz = None
        self.comps: List[_Comp] = []
        self.cod: Optional[_Cod] = None
        self.cocs: Dict[int, _Cod] = {}
        self.qcd: Optional[_Qcd] = None
        self.qccs: Dict[int, _Qcd] = {}
        self.tile_parts: Dict[int, List[bytes]] = {}

    # ---- top-level parse -------------------------------------------------
    def parse(self):
        buf = self.buf
        if _u16(buf, 0) != _SOC:
            raise Jpeg2kError("Missing SOC marker.")
        pos = 2
        while pos + 2 <= len(buf):
            marker = _u16(buf, pos)
            if marker == _EOC:
                break
            if marker == _SOT:
                lsot = _u16(buf, pos + 2)
                isot = _u16(buf, pos + 4)
                psot = _u32(buf, pos + 6)
                if psot == 0:
                    psot = len(buf) - pos
                end = pos + psot
                if end > len(buf):
                    raise Jpeg2kError("Tile-part overruns codestream.")
                p2 = pos + 2 + lsot
                while p2 + 2 <= len(buf):
                    m2 = _u16(buf, p2)
                    if m2 == _SOD:
                        p2 += 2
                        break
                    l2 = _u16(buf, p2 + 2)
                    self._tile_header_marker(m2)
                    p2 += 2 + l2
                else:
                    raise Jpeg2kError("Tile-part without SOD.")
                self.tile_parts.setdefault(isot, []).append(buf[p2:end])
                pos = end
                continue
            length = _u16(buf, pos + 2)
            if length < 2 or pos + 2 + length > len(buf):
                raise Jpeg2kError(
                    f"Corrupt marker segment 0x{marker:04X}.")
            body = buf[pos + 4:pos + 2 + length]
            self._main_header_marker(marker, body)
            pos += 2 + length
        if self.siz is None or self.cod is None or self.qcd is None:
            raise Jpeg2kError("Codestream missing SIZ/COD/QCD.")
        ncomp = len(self.comps)
        if self.qcd.style == 0:
            need = 1 + 3 * self.cod.levels
            if len(self.qcd.exps) < need:
                raise Jpeg2kError("QCD exponent list too short.")

    def _main_header_marker(self, marker: int, body: bytes):
        if marker == _SIZ:
            if len(body) < 36:
                raise Jpeg2kError("Truncated SIZ segment.")
            (rsiz, xsiz, ysiz, x0, y0, xt, yt, xt0, yt0,
             csiz) = struct.unpack_from(">HIIIIIIIIH", body, 0)
            if xsiz <= x0 or ysiz <= y0 or xt == 0 or yt == 0:
                raise Jpeg2kError("Degenerate SIZ geometry.")
            # sanity bounds so corrupted headers fail honestly instead
            # of attempting multi-GiB allocations (fuzz-asserted): no
            # DICOM slice approaches 2^28 px / 2^20 per side
            if xsiz > 1 << 20 or ysiz > 1 << 20 or \
                    (xsiz - x0) * (ysiz - y0) > 1 << 28:
                raise Jpeg2kError("Implausible SIZ image dimensions.")
            if _ceil_div(xsiz - xt0, xt) * _ceil_div(ysiz - yt0, yt) \
                    > 1 << 16:
                raise Jpeg2kError("Implausible SIZ tile count.")
            if csiz == 0 or len(body) < 36 + 3 * csiz:
                raise Jpeg2kError("Truncated SIZ component list.")
            self.siz = (xsiz, ysiz, x0, y0, xt, yt, xt0, yt0)
            for i in range(csiz):
                ssiz, xr, yr = struct.unpack_from(">BBB", body,
                                                  36 + 3 * i)
                depth = (ssiz & 0x7F) + 1
                if depth > 16:
                    raise Jpeg2kError(
                        f"Component depth {depth} > 16 unsupported.")
                if xr != 1 or yr != 1:
                    raise Jpeg2kError(
                        "Subsampled components (XRsiz/YRsiz > 1) "
                        "unsupported (DICOM forbids them for "
                        "JPEG 2000 syntaxes).")
                self.comps.append(_Comp(depth, bool(ssiz & 0x80)))
        elif marker == _COD:
            self.cod = _parse_cod(body)
        elif marker == _COC:
            if self.cod is None:
                raise Jpeg2kError("COC before COD.")
            big = len(self.comps) > 256
            if len(body) < (8 if big else 7):
                raise Jpeg2kError("Truncated COC segment.")
            c = _u16(body, 0) if big else body[0]
            rest = body[2:] if big else body[1:]
            scoc = rest[0]
            levels = rest[1]
            cbw = (rest[2] & 0x0F) + 2
            cbh = (rest[3] & 0x0F) + 2
            cb_style = rest[4]
            transform = rest[5]
            prec = None
            if scoc & 0x01:
                if len(rest) < 7 + levels:
                    raise Jpeg2kError("Truncated COC precinct list.")
                prec = [(b & 0x0F, b >> 4)
                        for b in rest[6:7 + levels]]
            base = self.cod
            self.cocs[c] = _Cod(
                prog=base.prog, layers=base.layers, mct=base.mct,
                levels=levels, cbw=cbw, cbh=cbh, cb_style=cb_style,
                transform=transform, precincts=prec, sop=base.sop,
                eph=base.eph)
        elif marker == _QCD:
            self.qcd = _parse_qcd(body)
        elif marker == _QCC:
            big = len(self.comps) > 256
            if len(body) < (4 if big else 2):
                raise Jpeg2kError("Truncated QCC segment.")
            c = _u16(body, 0) if big else body[0]
            rest = body[2:] if big else body[1:]
            self.qccs[c] = _parse_qcd(rest)
        elif marker in (_RGN, _POC, _PPM):
            name = {_RGN: "ROI (RGN)",
                    _POC: "progression-order change (POC)",
                    _PPM: "packed packet headers (PPM)"}[marker]
            raise Jpeg2kError(f"Unsupported JPEG 2000 feature: {name}.")
        elif marker in (_COM, _CRG, _TLM, _PLM):
            pass
        # unknown marker segments with valid lengths: skip

    def _tile_header_marker(self, marker: int):
        if marker in (_COD, _COC, _QCD, _QCC):
            raise Jpeg2kError(
                "Per-tile COD/COC/QCD/QCC overrides are unsupported.")
        if marker == _PPT:
            raise Jpeg2kError(
                "Unsupported JPEG 2000 feature: packed packet headers "
                "(PPT).")
        if marker in (_POC, _RGN):
            raise Jpeg2kError(
                "Unsupported JPEG 2000 feature in tile header.")

    # ---- geometry --------------------------------------------------------
    def _tiles(self):
        xsiz, ysiz, x0, y0, xt, yt, xt0, yt0 = self.siz
        ntx = _ceil_div(xsiz - xt0, xt)
        nty = _ceil_div(ysiz - yt0, yt)
        for t in range(ntx * nty):
            ti, tj = t % ntx, t // ntx
            tx0 = max(xt0 + ti * xt, x0)
            ty0 = max(yt0 + tj * yt, y0)
            tx1 = min(xt0 + (ti + 1) * xt, xsiz)
            ty1 = min(yt0 + (tj + 1) * yt, ysiz)
            yield t, (tx0, ty0, tx1, ty1)

    def _cod_for(self, c: int) -> _Cod:
        return self.cocs.get(c, self.cod)

    def _qcd_for(self, c: int) -> _Qcd:
        return self.qccs.get(c, self.qcd)

    def _build_resolutions(self, c: int, rect) -> List[_Res]:
        cod = self._cod_for(c)
        tx0, ty0, tx1, ty1 = rect
        nl = cod.levels
        res_list = []
        for r in range(nl + 1):
            s = 1 << (nl - r)
            rx0, ry0 = _ceil_div(tx0, s), _ceil_div(ty0, s)
            rx1, ry1 = _ceil_div(tx1, s), _ceil_div(ty1, s)
            res = _Res(r, rx0, ry0, rx1, ry1)
            ppx, ppy = cod.ppx(r), cod.ppy(r)
            if rx1 > rx0:
                res.npx = _ceil_div(rx1, 1 << ppx) - (rx0 >> ppx)
            if ry1 > ry0:
                res.npy = _ceil_div(ry1, 1 << ppy) - (ry0 >> ppy)
            if r == 0:
                bands = [(0, nl, 0, 0)]
            else:
                nb = nl - r + 1
                bands = [(1, nb, 1, 0), (2, nb, 0, 1), (3, nb, 1, 1)]
            for btype, nb, xob, yob in bands:
                if nb > 0:
                    hshift = 1 << (nb - 1)
                else:
                    hshift = 0
                bx0 = _ceil_div(tx0 - hshift * xob, 1 << nb)
                by0 = _ceil_div(ty0 - hshift * yob, 1 << nb)
                bx1 = _ceil_div(tx1 - hshift * xob, 1 << nb)
                by1 = _ceil_div(ty1 - hshift * yob, 1 << nb)
                res.bands.append(_Band(btype, bx0, by0, bx1, by1))
            res_list.append(res)
        # quantisation per band in codestream order LL, (HL, LH, HH)×NL
        q = self._qcd_for(c)
        flat = [b for res in res_list for b in res.bands]
        for i, b in enumerate(flat):
            if q.style == 0:
                if i >= len(q.exps):
                    raise Jpeg2kError("Quantisation list too short.")
                b.exp, b.mant = q.exps[i], 0
            elif q.style == 2:
                if i >= len(q.exps):
                    raise Jpeg2kError("Quantisation list too short.")
                b.exp, b.mant = q.exps[i], q.mants[i]
        if q.style == 1:
            for res in res_list:
                nb = nl if res.r == 0 else nl - res.r + 1
                for b in res.bands:
                    b.exp = q.exps[0] - nl + nb
                    b.mant = q.mants[0]
        return res_list

    def _band_precinct_blocks(self, cod: _Cod, res: _Res, band: _Band,
                              pi: int):
        if pi in band.blocks:
            return band.blocks[pi]
        r = res.r
        ppx, ppy = cod.ppx(r), cod.ppy(r)
        bppx, bppy = (ppx, ppy) if r == 0 else (max(ppx - 1, 0),
                                                max(ppy - 1, 0))
        cbw = min(cod.cbw, bppx)
        cbh = min(cod.cbh, bppy)
        px = pi % max(res.npx, 1)
        py = pi // max(res.npx, 1)
        bpx0 = (((res.x0 >> ppx) + px) << ppx) >> (0 if r == 0 else 1)
        bpy0 = (((res.y0 >> ppy) + py) << ppy) >> (0 if r == 0 else 1)
        x0 = max(band.x0, bpx0)
        y0 = max(band.y0, bpy0)
        x1 = min(band.x1, bpx0 + (1 << bppx))
        y1 = min(band.y1, bpy0 + (1 << bppy))
        rows: List[List[_Block]] = []
        if x1 > x0 and y1 > y0:
            cb0x, cb1x = x0 >> cbw, _ceil_div(x1, 1 << cbw)
            cb0y, cb1y = y0 >> cbh, _ceil_div(y1, 1 << cbh)
            for gy in range(cb0y, cb1y):
                row = []
                for gx in range(cb0x, cb1x):
                    row.append(_Block(
                        x0=max(x0, gx << cbw), y0=max(y0, gy << cbh),
                        x1=min(x1, (gx + 1) << cbw),
                        y1=min(y1, (gy + 1) << cbh)))
                rows.append(row)
        band.blocks[pi] = rows
        nb_w = max(len(rows[0]) if rows else 0, 1)
        nb_h = max(len(rows), 1)
        band.incl_tree[pi] = _TagTree(nb_w, nb_h)
        band.zbp_tree[pi] = _TagTree(nb_w, nb_h)
        return rows

    # ---- packet decoding -------------------------------------------------
    @staticmethod
    def _read_passes(rd: _HeaderReader) -> int:
        if not rd.bit():
            return 1
        if not rd.bit():
            return 2
        v = rd.bits(2)
        if v < 3:
            return 3 + v
        v = rd.bits(5)
        if v < 31:
            return 6 + v
        return 37 + rd.bits(7)

    @staticmethod
    def _packet_segments(cod: _Cod, blk: _Block,
                         npasses: int) -> List[int]:
        """Pass counts of the terminated codeword segments this packet
        contributes for ``blk`` (B.10.7): each gets its own length."""
        lazy = bool(cod.cb_style & _CB_LAZY)
        termall = bool(cod.cb_style & _CB_TERMALL)
        if termall:
            return [1] * npasses
        if not lazy:
            return [npasses]
        segs = []
        cur = 0
        for i in range(npasses):
            p = blk.npasses + i
            cur += 1
            is_last = i == npasses - 1
            if not is_last:
                nxt = p + 1
                raw_p = p >= 10 and (p - 10) % 3 != 2
                raw_n = nxt >= 10 and (nxt - 10) % 3 != 2
                if p >= 9 and raw_p != raw_n:
                    segs.append(cur)
                    cur = 0
        if cur:
            segs.append(cur)
        return segs

    def _decode_packet(self, rd: _HeaderReader, cod: _Cod, res: _Res,
                      pi: int, layer: int):
        data = rd.data
        if cod.sop and data[rd.pos:rd.pos + 2] == b"\xff\x91":
            rd.pos += 6
        contributions = []
        if not rd.bit():
            pos = rd.align()
            if cod.eph:
                if data[pos:pos + 2] != b"\xff\x92":
                    raise Jpeg2kError("Missing EPH marker.")
                pos += 2
            rd.pos, rd.cnt, rd.buf = pos, 0, 0
            return contributions
        for band in res.bands:
            if band.x1 <= band.x0 or band.y1 <= band.y0:
                continue
            rows = self._band_precinct_blocks(cod, res, band, pi)
            itree = band.incl_tree[pi]
            ztree = band.zbp_tree[pi]
            for by, row in enumerate(rows):
                for bx, blk in enumerate(row):
                    if blk.x1 <= blk.x0 or blk.y1 <= blk.y0:
                        continue
                    if not blk.included:
                        v = itree.decode(rd, bx, by, layer + 1)
                        inc = v <= layer
                    else:
                        inc = bool(rd.bit())
                    if not inc:
                        continue
                    if not blk.included:
                        blk.zbp = ztree.decode_full(rd, bx, by)
                        blk.included = True
                    npasses = self._read_passes(rd)
                    while rd.bit():
                        blk.lblock += 1
                    for np_seg in self._packet_segments(cod, blk,
                                                        npasses):
                        bits = blk.lblock + _floor_log2(np_seg)
                        length = rd.bits(bits)
                        contributions.append((blk, length, np_seg))
                        blk.npasses += np_seg
        pos = rd.align()
        if cod.eph:
            if data[pos:pos + 2] != b"\xff\x92":
                raise Jpeg2kError("Missing EPH marker.")
            pos += 2
        rd.pos, rd.cnt, rd.buf = pos, 0, 0
        return contributions

    # ---- progression orders ----------------------------------------------
    def _packet_order(self, rect, res_per_comp) -> List[Tuple[int, int,
                                                              int, int]]:
        cod = self.cod
        ncomp = len(self.comps)
        maxres = max(len(r) for r in res_per_comp)
        order: List[Tuple[int, int, int, int]] = []

        def precincts(c, r):
            if r >= len(res_per_comp[c]):
                return 0
            res = res_per_comp[c][r]
            return res.npx * res.npy

        if cod.prog == 0:      # LRCP
            for layer in range(cod.layers):
                for r in range(maxres):
                    for c in range(ncomp):
                        for pi in range(precincts(c, r)):
                            order.append((c, r, pi, layer))
        elif cod.prog == 1:    # RLCP
            for r in range(maxres):
                for layer in range(cod.layers):
                    for c in range(ncomp):
                        for pi in range(precincts(c, r)):
                            order.append((c, r, pi, layer))
        elif cod.prog == 2:    # RPCL
            for r in range(maxres):
                order += self._pos_order(rect, res_per_comp,
                                         rs=[r],
                                         comps=list(range(ncomp)))
        elif cod.prog == 3:    # PCRL
            order += self._pos_order(rect, res_per_comp, rs=None,
                                     comps=list(range(ncomp)))
        else:                  # CPRL
            for c in range(ncomp):
                order += self._pos_order(rect, res_per_comp, rs=None,
                                         comps=[c])
        return order

    def _pos_order(self, rect, res_per_comp, rs, comps):
        """Position-scanning packet emission (B.12.1.3-5): walk the
        reference grid; a packet appears where its precinct's projection
        begins (or at the tile edge for partial first precincts)."""
        cod = self.cod
        tx0, ty0, tx1, ty1 = rect
        pairs = []
        for c in comps:
            nres = len(res_per_comp[c])
            for r in (rs if rs is not None else range(nres)):
                if r < nres and res_per_comp[c][r].npx \
                        and res_per_comp[c][r].npy:
                    pairs.append((c, r))
        if not pairs:
            return []

        def proj(c, r):
            ccod = self._cod_for(c)
            nl = ccod.levels
            return (1 << (ccod.ppx(r) + nl - r),
                    1 << (ccod.ppy(r) + nl - r))

        dx = min(proj(c, r)[0] for c, r in pairs)
        dy = min(proj(c, r)[1] for c, r in pairs)
        out = []
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                for c, r in pairs:
                    res = res_per_comp[c][r]
                    ccod = self._cod_for(c)
                    nl = ccod.levels
                    sdx, sdy = proj(c, r)
                    div = 1 << (nl - r)
                    ok_y = (y % sdy == 0) or (
                        y == ty0 and (res.y0 % (1 << ccod.ppy(r))) != 0)
                    ok_x = (x % sdx == 0) or (
                        x == tx0 and (res.x0 % (1 << ccod.ppx(r))) != 0)
                    if not (ok_x and ok_y):
                        continue
                    rx, ry = _ceil_div(x, div), _ceil_div(y, div)
                    px = (rx >> ccod.ppx(r)) - (res.x0 >> ccod.ppx(r))
                    py = (ry >> ccod.ppy(r)) - (res.y0 >> ccod.ppy(r))
                    if not (0 <= px < res.npx and 0 <= py < res.npy):
                        continue
                    pi = py * res.npx + px
                    for layer in range(cod.layers):
                        out.append((c, r, pi, layer))
                x += dx - (x % dx)
            y += dy - (y % dy)
        return out

    # ---- tile decode -----------------------------------------------------
    def decode_tile(self, t: int, rect) -> List[np.ndarray]:
        data = b"".join(self.tile_parts.get(t, []))
        ncomp = len(self.comps)
        res_per_comp = [self._build_resolutions(c, rect)
                        for c in range(ncomp)]
        rd = _HeaderReader(data, 0)
        for (c, r, pi, layer) in self._packet_order(rect, res_per_comp):
            res = res_per_comp[c][r]
            ccod = self._cod_for(c)
            contributions = self._decode_packet(rd, ccod, res, pi,
                                                layer)
            for blk, length, np_seg in contributions:
                seg = data[rd.pos:rd.pos + length]
                if len(seg) < length:
                    raise Jpeg2kError("Truncated packet body.")
                rd.pos += length
                blk.chunks.append((seg, np_seg))
        return [self._reconstruct_component(c, res_per_comp[c])
                for c in range(ncomp)]

    def _reconstruct_component(self, c, res_list) -> np.ndarray:
        cod = self._cod_for(c)
        comp = self.comps[c]
        reversible = cod.transform == 1
        guard = self._qcd_for(c).guard
        gain = {0: 0, 1: 1, 2: 1, 3: 2}

        # Tier-1 is per-code-block with no cross-block state: fan the
        # component's blocks out over a thread pool (the native kernel
        # releases the GIL for the whole ctypes call, so this scales on
        # multi-core hosts — same MDX_IO_THREADS convention as the
        # frame-level pool in mdx_torch/io/dicom.py)
        work = []
        for res in res_list:
            for band in res.bands:
                mb = guard + band.exp - 1
                for rows in band.blocks.values():
                    for row in rows:
                        for blk in row:
                            w = blk.x1 - blk.x0
                            h = blk.y1 - blk.y0
                            if w > 0 and h > 0 and blk.chunks:
                                work.append((band, blk, mb, w, h))

        def _one(item):
            band, blk, mb, w, h = item
            return _t1_block(blk.chunks, band.btype, mb, blk.zbp,
                             blk.npasses, w, h, cod.cb_style)

        decoded = dict(zip((id(it[1]) for it in work),
                           _map_parallel(_one, work)))

        def decode_band(band: _Band) -> np.ndarray:
            bw, bh = band.x1 - band.x0, band.y1 - band.y0
            dtype = np.int64 if reversible else np.float64
            if bw <= 0 or bh <= 0:
                return np.zeros((max(bh, 0), max(bw, 0)), dtype)
            arr = np.zeros((bh, bw), np.int64)
            for rows in band.blocks.values():
                for row in rows:
                    for blk in row:
                        vals = decoded.get(id(blk))
                        if vals is None:
                            continue
                        arr[blk.y0 - band.y0:blk.y1 - band.y0,
                            blk.x0 - band.x0:blk.x1 - band.x0] = vals
            if reversible:
                return arr
            rb = comp.depth + gain[band.btype]
            delta = (2.0 ** (rb - band.exp)) * (1.0
                                                + band.mant / 2048.0)
            return arr.astype(np.float64) * delta

        res0 = res_list[0]
        ll = decode_band(res0.bands[0])
        details = []
        rects = []
        for res in res_list[1:]:
            details.append(tuple(decode_band(b) for b in res.bands))
            rects.append(((res.y0, res.x0), (res.y1, res.x1)))
        return _inverse_dwt(ll, details, rects, reversible)


# ---------------------------------------------------------------------------
# Tier-1 dispatch: the host C++ loops (mdx_torch/csrc/host/codecs.cpp), or
# this module's _t1_decode_block / _t1_encode_block under MDX_NO_NATIVE=1
# ---------------------------------------------------------------------------


def _map_parallel(fn, items: list) -> list:
    """Order-preserving map over independent Tier-1 block decodes,
    pooled when there are multiple items and cores (``MDX_IO_THREADS``
    caps/disables, as in mdx_torch/io/dicom.py::_map_frames)."""
    import os

    env = os.environ.get("MDX_IO_THREADS")
    limit = int(env) if env else (os.cpu_count() or 1)
    workers = min(len(items), limit, 16)
    if workers <= 1:
        return [fn(it) for it in items]
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


def _t1_enc_block(vals: np.ndarray, btype: int):
    """The Tier-1 encoder of one code-block: the host loop, or its plain
    version under ``MDX_NO_NATIVE=1``."""
    if _native.disabled():
        return _t1_encode_block(vals, btype)
    return _native.jpeg2k_t1_encode(vals, btype)


def _t1_block(chunks, btype, mb, zbp, total, w, h,
              cb_style) -> np.ndarray:
    if _native.disabled():
        return _t1_decode_block(chunks, btype, mb, zbp, total, w, h,
                                cb_style)
    return _native.jpeg2k_t1_block(chunks, btype, mb, zbp, total, w, h,
                                   cb_style)


# ---------------------------------------------------------------------------
# Public decode
# ---------------------------------------------------------------------------


def decode(stream: bytes) -> Tuple[np.ndarray, int, bool]:
    """Decode a JPEG 2000 codestream (raw or JP2-wrapped).

    Returns ``(array, precision, signed)``: array is [H, W] for a single
    component or [H, W, C] after the inverse component transform, dtype
    uint8/uint16 (unsigned) or int16 (signed).
    """
    if len(stream) < 4:
        raise Jpeg2kError("Truncated JPEG 2000 stream.")
    dec = _Decoder(bytes(stream))
    dec.parse()
    xsiz, ysiz, x0, y0, *_ = dec.siz
    H, W = ysiz - y0, xsiz - x0
    ncomp = len(dec.comps)
    reversible = dec.cod.transform == 1
    planes = [np.zeros((H, W), np.int64 if reversible else np.float64)
              for _ in range(ncomp)]
    for t, rect in dec._tiles():
        tx0, ty0, tx1, ty1 = rect
        if tx1 <= tx0 or ty1 <= ty0:
            continue
        tiles = dec.decode_tile(t, rect)
        for c in range(ncomp):
            planes[c][ty0 - y0:ty1 - y0, tx0 - x0:tx1 - x0] = tiles[c]

    if dec.cod.mct == 1:
        if ncomp < 3:
            raise Jpeg2kError("MCT set with fewer than 3 components.")
        y_, u, v = planes[0], planes[1], planes[2]
        if reversible:   # RCT (G.2)
            g = y_ - ((u + v) >> 2)
            planes[0], planes[1], planes[2] = v + g, g, u + g
        else:            # ICT (G.3)
            planes[0] = y_ + 1.402 * v
            planes[1] = y_ - 0.344136 * u - 0.714136 * v
            planes[2] = y_ + 1.772 * u

    outs = []
    signed_any = any(c.signed for c in dec.comps)
    for c, comp in enumerate(dec.comps):
        p = planes[c]
        if not reversible:
            p = np.round(p)
        p = p.astype(np.int64)
        if comp.signed:
            lo = -(1 << (comp.depth - 1))
            hi = (1 << (comp.depth - 1)) - 1
        else:
            p = p + (1 << (comp.depth - 1))
            lo, hi = 0, (1 << comp.depth) - 1
        outs.append(np.clip(p, lo, hi))
    depth = max(comp.depth for comp in dec.comps)
    dtype = np.int16 if signed_any else (
        np.uint8 if depth <= 8 else np.uint16)
    if ncomp == 1:
        return outs[0].astype(dtype), depth, signed_any
    return np.stack(outs, axis=-1).astype(dtype), depth, signed_any


# ---------------------------------------------------------------------------
# Encoder — `.4.90` (reversible 5/3, single tile, one layer, LRCP)
# ---------------------------------------------------------------------------
# Write support mirrors the other lossless codecs in this io layer
# (JPEG-LL/JPEG-LS): grayscale, 8/16-bit, signed or unsigned, lossless
# only (the decode-only stance covers the lossy syntaxes).  The encoder
# exists for the writer (`mdx_torch.io.dicom_write`); its codestreams are
# byte-equal to the JAX package's and decode bit-exactly through both
# decoders and Pillow/OpenJPEG (tests/test_torch_jpeg2k.py).


class _MQEncoder:
    """Annex C MQ encoder (software conventions)."""

    __slots__ = ("out", "a", "c", "ct", "b")

    def __init__(self):
        self.out = bytearray()
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.b = -1      # pending byte (-1 = none yet)

    def _byteout(self):
        if self.b == 0xFF:
            self._emit(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if self.c < 0x8000000:
                self._emit(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                self.b += 1
                self.out[-1] = self.b
                if self.b == 0xFF:
                    self.c &= 0x7FFFFFF
                    self._emit(self.c >> 20)
                    self.c &= 0xFFFFF
                    self.ct = 7
                else:
                    self._emit(self.c >> 19)
                    self.c &= 0x7FFFF
                    self.ct = 8

    def _emit(self, byte):
        self.b = byte & 0xFF
        self.out.append(self.b)

    def _renorm(self):
        while True:
            if self.ct == 0:
                self._byteout()
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.a & 0x8000:
                break

    def encode(self, cx: list, d: int):
        i, mps = cx
        qe, nmps, nlps, switch = _MQ_TABLE[i]
        if d == mps:
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                cx[0] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                cx[1] = 1 - mps
            cx[0] = nlps
            self._renorm()

    def flush(self) -> bytes:
        # SETBITS: pick the codeword in [C, C+A) whose low 16 bits are
        # all ones — the decoder completes truncated codewords with
        # 1-bits, so the tail must BE ones to stay inside the interval
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        # drop a trailing 0xFF (the decoder synthesises 1-bits past the
        # end; ecosystem encoders do the same)
        if self.out and self.out[-1] == 0xFF:
            self.out.pop()
        # the first pending-byte slot was a sentinel when b started -1:
        # _emit appended real bytes only, so out is the codeword as-is
        return bytes(self.out)


class _HeaderWriter:
    """Packet-header bit writer with 0xFF stuffing (B.10.1)."""

    __slots__ = ("out", "buf", "cnt")

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.cnt = 0

    def bit(self, v: int):
        self.buf = (self.buf << 1) | (v & 1)
        self.cnt += 1
        # a byte following 0xFF carries only 7 bits (stuffed MSB 0)
        if self.cnt == (7 if (self.out and self.out[-1] == 0xFF) else 8):
            self.out.append(self.buf)
            self.buf = 0
            self.cnt = 0

    def bits(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bit((v >> k) & 1)

    def align(self) -> bytes:
        while self.cnt:
            self.bit(0)
        if self.out and self.out[-1] == 0xFF:
            # a header cannot end on 0xFF: emit the stuffed 0-bit byte
            self.out.append(0)
        return bytes(self.out)


class _TagTreeEnc(_TagTree):
    def encode(self, hw: _HeaderWriter, x: int, y: int, threshold: int):
        stack = []
        node = self._leaf(x, y)
        while node is not None:
            stack.append(node)
            node = node.parent
        low = 0
        for node in reversed(stack):
            if node.low < low:
                node.low = low
            while not node.known and node.low < threshold:
                if node.low < node.value:
                    hw.bit(0)
                    node.low += 1
                else:
                    hw.bit(1)
                    node.known = True
            low = node.low

    def finalize_values(self):
        """Recompute interior values as the min over children (call
        after set_value on every leaf)."""
        for lvl in range(len(self.nodes) - 2, -1, -1):
            for node in self.nodes[lvl]:
                node.value = 10 ** 9
        # children of level l+1 point to parents in level l
        for lvl in range(len(self.nodes) - 1, 0, -1):
            for node in self.nodes[lvl]:
                if node.parent is not None and \
                        node.value < node.parent.value:
                    node.parent.value = node.value


def _fwd_1d_53(x: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    """5/3 forward lifting on [i0, i1) along ``axis`` — the exact
    inverse of :func:`_sr_1d_53` (interleaved output, absolute-parity
    low/high placement)."""
    n = i1 - i0
    if n == 1:
        return x * 2 if i0 % 2 == 1 else x
    x = np.moveaxis(x, axis, 0)
    ext = x[_reflect(np.arange(-2, n + 2), n)]
    off = i0 - 2
    y = ext.copy()
    # odd (high) first: Y(2n+1) = X(2n+1) − ⌊(X(2n) + X(2n+2))/2⌋
    od0 = off + ((1 - off) % 2)
    ods = np.arange(od0, i1 + 2, 2)
    k = ods - off
    k = k[(k >= 1) & (k + 1 < ext.shape[0])]
    y[k] = ext[k] - ((ext[k - 1] + ext[k + 1]) >> 1)
    # even (low): Y(2n) = X(2n) + ⌊(Y(2n−1) + Y(2n+1) + 2)/4⌋
    ev0 = off + ((-off) % 2)
    evs = np.arange(ev0, i1 + 1, 2)
    k = evs - off
    k = k[(k >= 1) & (k + 1 < ext.shape[0])]
    y[k] = ext[k] + ((y[k - 1] + y[k + 1] + 2) >> 2)
    return np.moveaxis(y[2:2 + n], 0, axis)


def _forward_dwt_53(a: np.ndarray, x0: int, y0: int, levels: int):
    """Forward reversible DWT → (ll, [(hl, lh, hh) per level, fine→coarse
    reversed like the decoder expects], rects)."""
    details = []
    rects = []
    cur = a
    cx0, cy0 = x0, y0
    cx1, cy1 = x0 + a.shape[1], y0 + a.shape[0]
    for _ in range(levels):
        rects.append(((cy0, cx0), (cy1, cx1)))
        t = _fwd_1d_53(cur, cy0, cy1, axis=0)     # vertical
        t = _fwd_1d_53(t, cx0, cx1, axis=1)       # horizontal
        ys = np.arange(cy0, cy1)
        xs = np.arange(cx0, cx1)
        ey = ys % 2 == 0
        ex = xs % 2 == 0
        ll = t[np.ix_(ey, ex)]
        hl = t[np.ix_(ey, ~ex)]
        lh = t[np.ix_(~ey, ex)]
        hh = t[np.ix_(~ey, ~ex)]
        details.append((hl, lh, hh))
        cur = ll
        cx0, cy0 = _ceil_div(cx0, 2), _ceil_div(cy0, 2)
        cx1, cy1 = _ceil_div(cx1, 2), _ceil_div(cy1, 2)
    details.reverse()
    rects.reverse()
    return cur, details, rects


def _t1_encode_block(vals: np.ndarray, btype: int) -> Tuple[bytes, int,
                                                            int]:
    """Encode one code-block's coefficients → (codeword bytes, numbps,
    npasses).  Mirror image of :func:`_t1_decode_block` (no style
    flags: plain MQ, one codeword segment)."""
    h, w = vals.shape
    mag = np.abs(vals.astype(np.int64))
    neg = vals < 0
    maxmag = int(mag.max()) if mag.size else 0
    numbps = maxmag.bit_length()
    if numbps == 0:
        return b"", 0, 0

    sig = np.zeros((h + 2, w + 2), np.uint8)
    vis = np.zeros((h, w), np.uint8)
    refined = np.zeros((h, w), np.uint8)
    data = np.zeros((h, w), np.int32)   # decoder-visible signed value

    if btype == 1:
        sig_tab = _SIG_HL
    elif btype == 3:
        sig_tab = _SIG_HH
    else:
        sig_tab = _SIG_LL

    enc = _MQEncoder()
    cx = _fresh_contexts()

    def neigh(x, y):
        xs, ys = x + 1, y + 1
        hc = int(sig[ys, xs - 1]) + int(sig[ys, xs + 1])
        vc = int(sig[ys - 1, xs]) + int(sig[ys + 1, xs])
        dc = (int(sig[ys - 1, xs - 1]) + int(sig[ys - 1, xs + 1])
              + int(sig[ys + 1, xs - 1]) + int(sig[ys + 1, xs + 1]))
        return hc, vc, dc

    def sign_ctx(x, y):
        xs, ys = x + 1, y + 1
        hc = 0
        if sig[ys, xs - 1]:
            hc += -1 if (x > 0 and data[y, x - 1] < 0) else 1
        if sig[ys, xs + 1]:
            hc += -1 if (x < w - 1 and data[y, x + 1] < 0) else 1
        hc = max(-1, min(1, hc))
        vc = 0
        if sig[ys - 1, xs]:
            vc += -1 if (y > 0 and data[y - 1, x] < 0) else 1
        if sig[ys + 1, xs]:
            vc += -1 if (y < h - 1 and data[y + 1, x] < 0) else 1
        vc = max(-1, min(1, vc))
        return _SIGN_CTX[(hc, vc)]

    def set_sig(x, y, bp):
        one = 1 << bp
        val = one | (one >> 1)
        data[y, x] = -val if neg[y, x] else val
        sig[y + 1, x + 1] = 1

    def pass_sig(bp):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y + 1, x + 1]:
                        continue
                    hc, vc_, dc = neigh(x, y)
                    if hc + vc_ + dc == 0:
                        continue
                    bit = int((mag[y, x] >> bp) & 1)
                    ctx = int(sig_tab[min(hc, 2), min(vc_, 2),
                                      min(dc, 4)])
                    enc.encode(cx[ctx], bit)
                    if bit:
                        ci, xr = sign_ctx(x, y)
                        enc.encode(cx[ci], int(neg[y, x]) ^ xr)
                        set_sig(x, y, bp)
                    vis[y, x] = 1

    def pass_ref(bp):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y + 1, x + 1] or vis[y, x]:
                        continue
                    bit = int((mag[y, x] >> bp) & 1)
                    if refined[y, x]:
                        ctx = 16
                    else:
                        hc, vc_, dc = neigh(x, y)
                        ctx = 15 if hc + vc_ + dc else 14
                    enc.encode(cx[ctx], bit)
                    refined[y, x] = 1
                    vis[y, x] = 1

    def pass_cleanup(bp):
        for y0 in range(0, h, 4):
            for x in range(w):
                y = y0
                ylim = min(y0 + 4, h)
                while y < ylim:
                    if y == y0 and y0 + 4 <= h:
                        ok = True
                        for yy in range(y0, y0 + 4):
                            if sig[yy + 1, x + 1] or vis[yy, x]:
                                ok = False
                                break
                            hc, vc_, dc = neigh(x, yy)
                            if hc + vc_ + dc:
                                ok = False
                                break
                        if ok:
                            hits = [yy for yy in range(y0, y0 + 4)
                                    if (mag[yy, x] >> bp) & 1]
                            if not hits:
                                enc.encode(cx[_CTX_RL], 0)
                                y = y0 + 4
                                continue
                            enc.encode(cx[_CTX_RL], 1)
                            pos = hits[0] - y0
                            enc.encode(cx[_CTX_UNI], (pos >> 1) & 1)
                            enc.encode(cx[_CTX_UNI], pos & 1)
                            y = y0 + pos
                            ci, xr = sign_ctx(x, y)
                            enc.encode(cx[ci], int(neg[y, x]) ^ xr)
                            set_sig(x, y, bp)
                            y += 1
                            continue
                    if sig[y + 1, x + 1] or vis[y, x]:
                        y += 1
                        continue
                    bit = int((mag[y, x] >> bp) & 1)
                    hc, vc_, dc = neigh(x, y)
                    ctx = int(sig_tab[min(hc, 2), min(vc_, 2),
                                      min(dc, 4)])
                    enc.encode(cx[ctx], bit)
                    if bit:
                        ci, xr = sign_ctx(x, y)
                        enc.encode(cx[ci], int(neg[y, x]) ^ xr)
                        set_sig(x, y, bp)
                    y += 1

    npasses = 0
    for p in range(3 * numbps - 2):
        kind, bp = _pass_kind(p, numbps)
        if kind == 0:
            pass_sig(bp)
        elif kind == 1:
            pass_ref(bp)
        else:
            pass_cleanup(bp)
            vis[:] = 0
        npasses += 1
    return enc.flush(), numbps, npasses


def _enc_npasses(hw: _HeaderWriter, n: int):
    """Inverse of _Decoder._read_passes."""
    if n == 1:
        hw.bit(0)
    elif n == 2:
        hw.bits(0b10, 2)
    elif n <= 5:
        hw.bits(0b11, 2)
        hw.bits(n - 3, 2)
    elif n <= 36:
        hw.bits(0b1111, 4)
        hw.bits(n - 6, 5)
    else:
        hw.bits(0b111111111, 9)
        hw.bits(n - 37, 7)


def encode(img: np.ndarray, signed: bool = False, levels: int = 5,
           cb: int = 6) -> bytes:
    """Encode a grayscale image as a `.4.90` reversible codestream
    (single tile, one quality layer, LRCP, 5/3, code-blocks 2^cb).

    ``img``: [H, W] integer array; ``signed`` selects the SIZ sign flag
    and skips the DC level shift.  Depth is taken from the dtype
    (uint8→8, else 16).  Lossless by construction — round-trip
    bit-exactness is asserted against this module's decoder AND
    Pillow/OpenJPEG in the tests.
    """
    if img.ndim != 2:
        raise Jpeg2kError("Encoder takes a single [H, W] component.")
    h, w = img.shape
    if h == 0 or w == 0:
        raise Jpeg2kError("Empty image.")
    depth = 8 if img.dtype.itemsize == 1 else 16
    levels = max(0, min(int(levels), 32))
    # keep every resolution non-empty (ceil(dim / 2^levels) ≥ 1 always
    # holds, but tiny images waste levels): cap ~log2(min dim)
    while levels > 0 and (h >> levels) == 0 and (w >> levels) == 0 \
            and (1 << levels) > max(h, w):
        levels -= 1

    a = img.astype(np.int64)
    if not signed:
        a = a - (1 << (depth - 1))

    ll, details, rects = _forward_dwt_53(a, 0, 0, levels)

    # assemble per-resolution band list exactly like the decoder's
    # geometry (single tile at origin ⇒ band rects from the same math)
    dec_geo = _Cod(levels=levels, cbw=cb, cbh=cb, transform=1)
    bands_per_res = []
    for r in range(levels + 1):
        s = 1 << (levels - r)
        rx1, ry1 = _ceil_div(w, s), _ceil_div(h, s)
        if r == 0:
            bands_per_res.append([(0, ll)])
        else:
            hl, lh, hh = details[r - 1]
            bands_per_res.append([(1, hl), (2, lh), (3, hh)])

    guard = 2
    gain = {0: 0, 1: 1, 2: 1, 3: 2}

    # ---- markers ----------------------------------------------------
    out = bytearray()
    out += struct.pack(">H", _SOC)
    out += struct.pack(">HH", _SIZ, 38 + 3)
    out += struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, 1)
    out += bytes(((depth - 1) | (0x80 if signed else 0), 1, 1))
    cod_body = bytes((0,       # Scod: no precincts, no SOP/EPH
                      0,))     # LRCP
    cod_body += struct.pack(">H", 1)          # 1 layer
    cod_body += bytes((0,      # no MCT
                       levels, cb - 2, cb - 2,
                       0,      # cb style: plain
                       1))     # 5/3 reversible
    out += struct.pack(">HH", _COD, 2 + len(cod_body)) + cod_body
    # QCD: reversible style 0, exponent per band = depth + gain
    exps = []
    for r in range(levels + 1):
        for btype, _arr in bands_per_res[r]:
            exps.append(depth + gain[btype])
    qcd_body = bytes([(guard << 5) | 0]) + bytes(e << 3 for e in exps)
    out += struct.pack(">HH", _QCD, 2 + len(qcd_body)) + qcd_body

    # ---- tile body: encode blocks, then LRCP packets (1 layer) ------
    body = bytearray()
    cbsz = 1 << cb
    for r in range(levels + 1):
        hwr = _HeaderWriter()
        blocks_payloads = []
        any_block = False
        for btype, arr in bands_per_res[r]:
            bh, bw = arr.shape
            if bh == 0 or bw == 0:
                continue
            any_block = True
        if not any_block:
            body += b"\x00"     # empty packet: single 0 header bit
            continue
        hwr.bit(1)  # non-empty packet
        for btype, arr in bands_per_res[r]:
            bh, bw = arr.shape
            if bh == 0 or bw == 0:
                continue
            nby = _ceil_div(bh, cbsz)
            nbx = _ceil_div(bw, cbsz)
            itree = _TagTreeEnc(nbx, nby)
            ztree = _TagTreeEnc(nbx, nby)
            mb = guard + (depth + gain[btype]) - 1
            # Tier-1 encode fans out over the block pool like decode —
            # code-blocks are independent and the native kernel
            # releases the GIL (MDX_IO_THREADS convention)
            coords = [(gx, gy) for gy in range(nby)
                      for gx in range(nbx)]
            subs = [arr[gy * cbsz:(gy + 1) * cbsz,
                        gx * cbsz:(gx + 1) * cbsz].astype(np.int64)
                    for gx, gy in coords]
            encoded = _map_parallel(
                lambda s: _t1_enc_block(s, btype), subs)
            blk_info = []
            for (gx, gy), (data_, numbps, npasses) in zip(coords,
                                                          encoded):
                zbp = mb - numbps if numbps else mb
                blk_info.append((gx, gy, data_, numbps, npasses, zbp))
            for gx, gy, data_, numbps, npasses, zbp in blk_info:
                # all-zero blocks are "not included in layer 0": the
                # inclusion tag-tree value 1 exceeds the threshold
                itree._leaf(gx, gy).value = 0 if npasses else 1
                ztree._leaf(gx, gy).value = zbp
            itree.finalize_values()
            ztree.finalize_values()
            for gx, gy, data_, numbps, npasses, zbp in blk_info:
                itree.encode(hwr, gx, gy, 1)
                if npasses == 0:
                    continue                     # not included
                # zero bitplanes: encode until known
                t = 1
                while not ztree._leaf(gx, gy).known:
                    ztree.encode(hwr, gx, gy, t)
                    t += 1
                _enc_npasses(hwr, npasses)
                lblock = 3
                lenbits = lblock + _floor_log2(npasses)
                while len(data_) >= (1 << lenbits):
                    hwr.bit(1)
                    lblock += 1
                    lenbits += 1
                hwr.bit(0)
                hwr.bits(len(data_), lenbits)
                blocks_payloads.append(data_)
        body += hwr.align()
        for p in blocks_payloads:
            body += p

    psot = 12 + 2 + len(body)
    out += struct.pack(">HHHIBB", _SOT, 10, 0, psot, 0, 1)
    out += struct.pack(">H", _SOD)
    out += body
    out += struct.pack(">H", _EOC)
    return bytes(out)
