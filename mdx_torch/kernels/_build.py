"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All ``mdx_torch/csrc/*.cu`` sources compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  The library lands in ``build/mdx_torch_kernels/`` at the root of
the checkout, named by a hash of the sources and the flags, so an edit to
any source builds a new library and an unchanged tree reuses the old one.
Nothing is built at import: the first kernel call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "mdx_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of every C entry point (all return cudaGetLastError())
SIGNATURES = {
    "mdx_box_stats": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mdx_unsharp": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mdx_clahe": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mdx_tv_iteration": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _F, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmdx_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path.  nvcc's output (ptxas register and shared-memory counts) is kept
    beside it as ``<library>.log``.  Raises if nvcc fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        secs = time.perf_counter() - t0
        log = f"# nvcc {secs:.1f} s, rc {proc.returncode}\n{proc.stdout}{proc.stderr}"
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the library with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
