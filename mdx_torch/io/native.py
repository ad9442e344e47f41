"""ctypes bindings of the port's host C++ codec loops
(``mdx_torch/csrc/host/codecs.cpp``).

The counterpart of the JAX package's ``mdx/io/native.py`` for the four
entropy loops of the lossless JPEG codecs: JPEG Lossless's Huffman decode
and bit packer (:mod:`mdx_torch.io.jpegll`) and JPEG-LS's scan decode and
encode (:mod:`mdx_torch.io.jpegls`).  The wrappers take the same arguments,
give the same returns and raise the same errors as the JAX package's.

At first use the source is compiled with the host C++ compiler (``$CXX``,
else ``g++``, else ``c++``) into ``build/mdx_torch_host/`` at the root of
the checkout, named by a hash of the source and the flags: an edit builds a
new library and an unchanged tree reuses the old one.  The library is built
to a temporary file in that directory and renamed into place, so processes
that build at once never load a half-written file, and a lock makes one
thread of a process build and bind it.  ``ctypes`` releases the GIL during
each call, so the reader's frame threads decode in parallel.

Unlike the JAX package, whose failed build falls back quietly to the Python
loops, a failed build raises :class:`NativeBuildError` with the compiler's
output.  The codecs run their Python loops only where the JAX package does
with its library built (a multi-component JPEG Lossless scan), or when the
caller sets ``MDX_NO_NATIVE=1``, the variable the JAX package reads.
``CALLS`` counts the calls of each wrapper.
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
}

# calls of each wrapper since the last reset_calls()
CALLS = {"jpegll_diffs": 0, "jpegll_pack": 0, "jpegls_decode": 0,
         "jpegls_encode": 0}
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
        os.replace(tmp, lib)
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
