"""ctypes bindings of the port's host C++ codec loops
(``mdx_torch/csrc/host/codecs.cpp``).

The counterpart of the JAX package's ``mdx/io/native.py`` for its ten
entropy loops: JPEG Lossless's Huffman decode and bit packer
(:mod:`mdx_torch.io.jpegll`), JPEG-LS's scan decode and encode
(:mod:`mdx_torch.io.jpegls`), JPEG 2000's EBCOT Tier-1 decode and encode of
one code-block (:mod:`mdx_torch.io.jpeg2k`), DCT JPEG's sequential and
progressive restart-segment decodes (:mod:`mdx_torch.io.jpegdct`) and
PackBits decode and encode (:mod:`mdx_torch.io.rle`).  The wrappers take
the same arguments, give the same returns and raise the same errors as the
JAX package's.

At first use the source is compiled with the host C++ compiler (``$CXX``,
else ``g++``, else ``c++``) into ``build/mdx_torch_host/`` at the root of
the checkout, named by a hash of the source and the flags: an edit builds a
new library and an unchanged tree reuses the old one.  The library is built
to a temporary file in that directory and linked into place only if no
other process installed it first, so processes that build at once never
load a half-written file and an installed library is never replaced; a
lock makes one thread of a process build and bind it.  ``ctypes``
releases the GIL during each call, so the reader's frame threads decode
in parallel.

Unlike the JAX package, whose failed build falls back quietly to the Python
loops, a failed build raises :class:`NativeBuildError` with the compiler's
output.  The codecs run their Python loops only where the JAX package does
with its library built (a multi-component JPEG Lossless scan), or when the
caller sets ``MDX_NO_NATIVE=1``, the variable the JAX package reads.  (The
JAX package's rescale and normalise passes are not bound: the port does
both in numpy.)
``CALLS`` counts the calls of each wrapper that reach the library (a
JPEG 2000 code-block with no coding pass is zeros without a call, as in
the JAX package).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "host" / "codecs.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "mdx_torch_host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
SIGNATURES = {
    "mdx_torch_io_jpegll_diffs": (_P, _I64, _P, _P, _I64, _I64, _P),
    "mdx_torch_io_jpegll_pack": (_P, _P, _I64, _P, _P, _P),
    "mdx_torch_io_jpegls_decode": (_P, _I64, _I64) + (_I32,) * 8
    + (_I64, _I32, _I32, _I32, _P, ctypes.POINTER(_I64)),
    "mdx_torch_io_jpegls_encode": (_P,) + (_I32,) * 8
    + (_I64, _I32, _I32, _I32, _P, _I64),
    "mdx_torch_io_jpeg2k_t1": (_P,) * 5 + (_I32,) * 7 + (_P,),
    "mdx_torch_io_jpeg2k_t1_enc": (_P, _P, _I32, _I32, _I32, _P, _I64,
                                   ctypes.POINTER(_I32),
                                   ctypes.POINTER(_I32)),
    "mdx_torch_io_jpegdct_segment": (_P, _I64, _I32, _P, _P, _P, _P)
    + (_P,) * 4 + (_I64, _I64, _I32, _I32),
    "mdx_torch_io_jpegdct_prog_segment": (_P, _I64, _I32) + (_P,) * 5
    + (_P,) * 4 + (_I64, _I64) + (_I32,) * 7,
    "mdx_torch_io_packbits_decode": (_P, _I64, _P, _I64),
    "mdx_torch_io_packbits_encode": (_P, _I64, _P),
}

# calls of each wrapper since the last reset_calls()
CALLS = {"jpegll_diffs": 0, "jpegll_pack": 0, "jpegls_decode": 0,
         "jpegls_encode": 0, "jpeg2k_t1_block": 0, "jpeg2k_t1_encode": 0,
         "jpegdct_segment": 0, "jpegdct_prog_segment": 0,
         "packbits_decode": 0, "packbits_encode": 0}
# how the loaded library came to be: compiler, its version, build seconds
# (None where an earlier build was reused) and the library's path
BUILD: dict = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """The host C++ compiler is missing or refused the source."""


def disabled() -> bool:
    """True when the caller asked for the Python loops (``MDX_NO_NATIVE``)."""
    return bool(os.environ.get("MDX_NO_NATIVE"))


def reset_calls() -> None:
    with _count_lock:
        for k in CALLS:
            CALLS[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        CALLS[name] += 1


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise NativeBuildError(
        "no host C++ compiler: set CXX or put g++ or c++ on PATH")


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for ``source`` and the flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"libmdx_torch_host_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> dict:
    """Compile ``source`` unless its library exists; returns what
    :data:`BUILD` holds.  Raises :class:`NativeBuildError` with the
    compiler's output if the compiler is missing or fails."""
    lib = library_path(source, build_dir)
    if lib.exists():
        return {"compiler": None, "version": None, "seconds": None,
                "path": str(lib)}
    cxx = compiler()
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            raise NativeBuildError(
                f"{cxx} {' '.join(CXX_FLAGS)} {source} failed "
                f"(rc {r.returncode}):\n{r.stdout}")
        try:
            os.link(tmp, lib)
        except FileExistsError:
            pass            # a concurrent build installed the same library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    version = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True
                             ).stdout.splitlines()
    return {"compiler": cxx, "version": version[0] if version else "",
            "seconds": secs, "path": str(lib)}


def load() -> ctypes.CDLL:
    """Build if needed and load the library with every signature declared
    (once a process)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(info["path"])
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I64
            BUILD.update(info)
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def jpegll_diffs(seg: bytes, counts: np.ndarray, values: np.ndarray,
                 count: int) -> tuple[int, np.ndarray]:
    """JPEG Lossless entropy decode (destuffed scan bytes → int32 diffs).
    Returns ``(rc, diffs)``: rc == count on success, -1 truncated, -2
    invalid code, -3 table mismatch — the caller (``jpegll``) maps rc to
    the same JpegLLError taxonomy as the Python loop."""
    src = np.frombuffer(seg, np.uint8)
    c = np.ascontiguousarray(counts, dtype=np.uint8)
    v = np.ascontiguousarray(values, dtype=np.uint8)
    if c.size != 16 or count < 0:
        raise ValueError(f"jpegll_diffs: {c.size} code counts (16 wanted), "
                         f"count {count}")
    lib = load()
    out = np.empty(max(count, 1), np.int32)
    _count("jpegll_diffs")
    rc = lib.mdx_torch_io_jpegll_diffs(_ptr(src), src.size, _ptr(c),
                                       _ptr(v), v.size, count, _ptr(out))
    return int(rc), out[:count]


def jpegll_pack(ssss: np.ndarray, evals: np.ndarray, code_of: np.ndarray,
                len_of: np.ndarray) -> bytes:
    """JPEG Lossless bit packer, bit-identical to ``_pack_segment_py``
    (codes MSB-first, 1-padded to a byte, 0xFF stuffed)."""
    s = np.ascontiguousarray(ssss.ravel(), dtype=np.uint8)
    v = np.ascontiguousarray(evals.ravel(), dtype=np.int64)
    c = np.ascontiguousarray(code_of, dtype=np.int64)
    ln = np.ascontiguousarray(len_of, dtype=np.int64)
    if v.size != s.size or min(c.size, ln.size) < 17 or (
            s.size and int(s.max()) > 16):
        raise ValueError("jpegll_pack: categories beyond 16 or arrays of "
                         "unequal length")
    lib = load()
    out = np.empty(s.size * 8 + 2, np.uint8)
    _count("jpegll_pack")
    n = lib.mdx_torch_io_jpegll_pack(_ptr(s), _ptr(v), s.size, _ptr(c),
                                     _ptr(ln), _ptr(out))
    return out[:n].tobytes()


_JPEGLS_ERRORS = {
    -1: "Truncated JPEG-LS entropy segment.",
    -2: "Corrupt Golomb code (unary overflow).",
    -3: "Run length exceeds the line.",
    -4: "Entropy segment ended at a marker mid-symbol (truncated scan).",
    -5: "JPEG-LS encode output overflow.",
}


def _jpegls_raise(rc: int):
    from mdx_torch.io.jpegls import JpegLSError

    raise JpegLSError(_JPEGLS_ERRORS.get(rc, f"native error {rc}"))


def _check_plane(width: int, height: int) -> None:
    if width < 1 or height < 0:
        from mdx_torch.io.jpegls import JpegLSError

        raise JpegLSError(f"JPEG-LS plane of {height} x {width} samples.")


def jpegls_decode(buf: bytes, pos: int, width: int, height: int,
                  params) -> tuple[np.ndarray, int]:
    """JPEG-LS scan decode, bit-identical to ``_decode_scan_python`` (same
    control flow, same error taxonomy).  Returns ``(plane int64 [H, W],
    end_offset)``."""
    _check_plane(width, height)
    src = np.frombuffer(buf, np.uint8)
    if not 0 <= pos <= src.size:
        raise ValueError(f"jpegls_decode: offset {pos} outside the buffer")
    lib = load()
    out = np.empty((height, width), np.int32)
    end = _I64(0)
    _count("jpegls_decode")
    rc = lib.mdx_torch_io_jpegls_decode(
        _ptr(src), src.size, pos, width, height, params.maxval, params.near,
        params.t1, params.t2, params.t3, params.reset, params.range,
        params.limit, params.qbpp, params.a_init, _ptr(out),
        ctypes.byref(end))
    if rc != 0:
        _jpegls_raise(int(rc))
    return out.astype(np.int64), int(end.value)


def jpegls_encode(plane: np.ndarray, params) -> bytes:
    """JPEG-LS scan encode, bit-identical to ``_encode_scan_python``."""
    img = np.ascontiguousarray(plane, dtype=np.int32)
    height, width = img.shape
    _check_plane(width, height)
    lib = load()
    # worst case ≈ LIMIT bits/sample (≤ 64) + stuffing; 10 B/sample is safe
    cap = img.size * 10 + 64
    out = np.empty(cap, np.uint8)
    _count("jpegls_encode")
    rc = lib.mdx_torch_io_jpegls_encode(
        _ptr(img), width, height, params.maxval, params.near, params.t1,
        params.t2, params.t3, params.reset, params.range, params.limit,
        params.qbpp, params.a_init, _ptr(out), cap)
    if rc < 0:
        _jpegls_raise(int(rc))
    return out[:int(rc)].tobytes()


def _check_block(w: int, h: int, btype: int) -> None:
    if w < 1 or h < 1 or not 0 <= btype <= 3:
        raise ValueError(f"jpeg2k Tier-1: code-block of {h} x {w} "
                         f"samples, band type {btype}")


def jpeg2k_t1_block(chunks, btype: int, mb: int, zbp: int, total: int,
                    w: int, h: int, cb_style: int) -> np.ndarray:
    """EBCOT Tier-1 decode of one code-block, bit-identical values
    (including the in-loop half-LSB reconstruction) and errors to
    ``jpeg2k._t1_decode_block``, its plain version."""
    from mdx_torch.io.jpeg2k import Jpeg2kError, _Block, _codeword_segments

    numbps = mb - zbp
    if total <= 0 or numbps <= 0 or not chunks:
        return np.zeros((h, w), np.int32)
    _check_block(w, h, btype)
    blk = _Block(0, 0, w, h)
    blk.chunks = chunks
    segments = _codeword_segments(blk, cb_style, numbps)
    seg_data = b"".join(s[0] for s in segments)
    lens = np.array([len(s[0]) for s in segments], np.int64)
    firsts = np.array([s[1] for s in segments], np.int32)
    npasses = np.array([s[2] for s in segments], np.int32)
    raws = np.array([1 if s[3] else 0 for s in segments], np.uint8)
    buf = np.frombuffer(seg_data, np.uint8) if seg_data else \
        np.zeros(1, np.uint8)
    lib = load()
    out = np.zeros((h, w), np.int32)
    _count("jpeg2k_t1_block")
    rc = lib.mdx_torch_io_jpeg2k_t1(
        _ptr(buf), _ptr(lens), _ptr(firsts), _ptr(npasses), _ptr(raws),
        len(segments), w, h, btype, numbps, total, cb_style, _ptr(out))
    if rc == -1:
        raise Jpeg2kError(
            "Segmentation symbol mismatch (corrupt entropy data).")
    if rc != 0:
        raise Jpeg2kError(f"native Tier-1 error {rc}")
    return out


def jpeg2k_t1_encode(vals: np.ndarray, btype: int):
    """EBCOT Tier-1 encode of one code-block, byte-identical codewords to
    ``jpeg2k._t1_encode_block``, its plain version.  Returns ``(bytes,
    numbps, npasses)``."""
    v = np.asarray(vals).astype(np.int64)
    if v.ndim != 2:
        raise ValueError(f"jpeg2k Tier-1: a code-block of {v.ndim} axes")
    h, w = v.shape
    _check_block(w, h, btype)
    mag = np.abs(v)
    if mag.size and int(mag.max()) >= 1 << 30:
        raise ValueError("jpeg2k Tier-1: a coefficient of 31 bits or more")
    mag = np.ascontiguousarray(mag, dtype=np.int32)
    neg = np.ascontiguousarray(v < 0, dtype=np.uint8)
    lib = load()
    cap = int(h * w * 8 + 4096)
    out = np.empty(cap, np.uint8)
    numbps, npasses = _I32(), _I32()
    _count("jpeg2k_t1_encode")
    rc = lib.mdx_torch_io_jpeg2k_t1_enc(
        _ptr(mag), _ptr(neg), w, h, btype, _ptr(out), cap,
        ctypes.byref(numbps), ctypes.byref(npasses))
    if rc < 0:
        raise RuntimeError("native Tier-1 encode overflow")
    return bytes(out[:rc]), int(numbps.value), int(npasses.value)


def packbits_decode(data: bytes, expected: int) -> tuple[int, bytes]:
    """PackBits decode.  Returns ``(rc, out)``: rc == expected on success,
    rc < expected for a short stream, -1/-2 for a truncated literal/replicate
    run; the caller (``rle``) maps rc to the Python loop's RleError."""
    src = np.frombuffer(data, np.uint8)
    lib = load()
    out = np.empty(max(expected, 1), np.uint8)
    _count("packbits_decode")
    rc = lib.mdx_torch_io_packbits_decode(_ptr(src), src.size, _ptr(out),
                                          expected)
    return int(rc), out[:expected].tobytes()


def packbits_encode(data: bytes) -> bytes:
    """PackBits encode, byte-identical to ``rle._packbits_encode_py``."""
    src = np.frombuffer(data, np.uint8)
    lib = load()
    out = np.empty(src.size + src.size // 128 + 2, np.uint8)
    _count("packbits_encode")
    n = lib.mdx_torch_io_packbits_encode(_ptr(src), src.size, _ptr(out))
    return out[:int(n)].tobytes()


_JPEGDCT_ERRORS = {
    -1: "Truncated JPEG entropy segment.",
    -2: "Invalid Huffman code in scan data.",
    -3: "AC run overflows the block.",
    -4: "Invalid DC category.",
    -5: "Invalid progressive refinement symbol.",
}


def _jpegdct_marshal(seg, scan_comps, dc_tabs, ac_tabs, grids, coeffs):
    """The arguments both DCT segment loops share: the segment, per scan
    component its sampling factors, block-grid width and coefficient array,
    and its Huffman tables flattened (16 code counts and 256 values a
    table, zeros for a table the scan mode never reads).  The arrays are
    returned so that they live through the call."""
    from mdx_torch.io.jpegdct import JpegDctError

    ncomp = len(scan_comps)
    if not 1 <= ncomp <= 4:
        raise JpegDctError(f"A scan of {ncomp} components.")
    hs = np.array([c.h for c in scan_comps], np.int32)
    vs = np.array([c.v for c in scan_comps], np.int32)
    bxs = np.array([grids[c.cid][1] for c in scan_comps], np.int32)
    dc_counts = np.zeros((ncomp, 16), np.uint8)
    dc_values = np.zeros((ncomp, 256), np.uint8)
    ac_counts = np.zeros((ncomp, 16), np.uint8)
    ac_values = np.zeros((ncomp, 256), np.uint8)
    outs = (ctypes.c_void_p * ncomp)()
    for i, c in enumerate(scan_comps):
        for tab, counts, values in ((dc_tabs.get(c.td), dc_counts, dc_values),
                                    (ac_tabs.get(c.ta), ac_counts, ac_values)):
            if tab is None:
                continue
            counts[i, :] = [
                tab.maxcode[L] - tab.mincode[L] + 1
                if tab.maxcode[L] >= 0 else 0 for L in range(1, 17)]
            values[i, :len(tab.values)] = np.frombuffer(
                bytes(tab.values), np.uint8)
        arr = coeffs[c.cid]
        if arr.dtype != np.int32 or not arr.flags.c_contiguous:
            raise ValueError("jpegdct: coefficients must be C-contiguous "
                             "int32")
        outs[i] = arr.ctypes.data
    src = np.frombuffer(seg, np.uint8) if seg else np.zeros(1, np.uint8)
    return (src, len(seg), ncomp, hs, vs, bxs, outs,
            dc_counts, dc_values, ac_counts, ac_values)


def _jpegdct_raise(rc: int) -> None:
    from mdx_torch.io.jpegdct import JpegDctError

    raise JpegDctError(_JPEGDCT_ERRORS.get(rc, f"native error {rc}"))


def jpegdct_segment(seg: bytes, scan_comps, dc_tabs, ac_tabs, grids,
                    coeffs, mcu0: int, cnt: int, interleaved: bool,
                    mcus_x: int) -> None:
    """Sequential DCT restart-segment decode into ``coeffs``, bit-identical
    coefficients and errors to ``jpegdct._decode_segment_py``."""
    (src, n, ncomp, hs, vs, bxs, outs, dcc, dcv, acc, acv) = \
        _jpegdct_marshal(seg, scan_comps, dc_tabs, ac_tabs, grids, coeffs)
    lib = load()
    _count("jpegdct_segment")
    rc = lib.mdx_torch_io_jpegdct_segment(
        _ptr(src), n, ncomp, _ptr(hs), _ptr(vs), _ptr(bxs), outs,
        _ptr(dcc), _ptr(dcv), _ptr(acc), _ptr(acv), mcu0, cnt,
        int(interleaved), mcus_x)
    if rc != 0:
        _jpegdct_raise(int(rc))


def jpegdct_prog_segment(seg: bytes, scan_comps, dc_tabs, ac_tabs, grids,
                         coeffs, mcu0: int, cnt: int, interleaved: bool,
                         mcus_x: int, ss: int, se: int, ah: int, al: int,
                         dc_scan: bool) -> None:
    """Progressive (Annex G) restart-segment decode into ``coeffs``,
    bit-identical coefficients to ``jpegdct._decode_prog_segment_py``."""
    (src, n, ncomp, hs, vs, bxs, outs, dcc, dcv, acc, acv) = \
        _jpegdct_marshal(seg, scan_comps, dc_tabs, ac_tabs, grids, coeffs)
    # a coefficient array may be wider than this scan's block grid (it is
    # allocated at the interleaved grid): rows step by the array's width
    strides = np.array([coeffs[c.cid].shape[1] for c in scan_comps],
                       np.int32)
    lib = load()
    _count("jpegdct_prog_segment")
    rc = lib.mdx_torch_io_jpegdct_prog_segment(
        _ptr(src), n, ncomp, _ptr(hs), _ptr(vs), _ptr(bxs), _ptr(strides),
        outs, _ptr(dcc), _ptr(dcv), _ptr(acc), _ptr(acv), mcu0, cnt,
        int(interleaved), mcus_x, ss, se, ah, al, int(dc_scan))
    if rc != 0:
        _jpegdct_raise(int(rc))
