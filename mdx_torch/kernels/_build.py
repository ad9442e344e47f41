"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``mdx_torch/csrc/*.cu`` source compiles to an object in its own
``nvcc`` process, all started together, and the objects link into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  The library lands in
``build/mdx_torch_kernels/`` at the root of the checkout, named by a hash
of the sources and the flags, so an edit to any source builds a new
library and an unchanged tree reuses the old one.
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
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of every C entry point (all return cudaGetLastError(),
# apart from mdx_tv_blocked_steps: kernel T's iterations a launch)
SIGNATURES = {
    "mdx_box_stats": (_P, _P, _P, _I, _I, _I, _P),
    "mdx_unsharp": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mdx_clahe": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mdx_clahe_luts": (_P, _P, _P, _I, _I, _I, _I, _P),
    "mdx_clahe_remap_ext": (_P, _P, _P, _I, _I, _I, _I, _P),
    "mdx_tv_blocked_steps": (),
    "mdx_tv_blocked_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _F, _P),
    "mdx_tv_blocked_rebuild": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "mdx_tv_shard_blocked_step": (_P,) * 15 + (_I,) * 9 + (_P,),
    "mdx_tv_shard_blocked_finalize": (_P,) * 7 + (_I, _I, _I, _F, _F, _P),
    "mdx_tv_shard_blocked_rebuild": (_P,) * 19 + (_I,) * 9 + (_P,),
    "mdx_bilateral": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mdx_wavelet_analysis": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                             _I, _P),
    "mdx_wavelet_synthesis": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
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
    beside it as ``<library>.log``.  Raises if any nvcc fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [src for src in _sources() if src.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(cu, objs)]
        outs = [(src.name, p.communicate()[0], p.returncode)
                for src, p in zip(cu, procs)]
        so = Path(tmp) / "lib.so"
        if all(rc == 0 for _, _, rc in outs):
            link = subprocess.run(
                [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(so),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            outs.append(("link", link.stdout, link.returncode))
        secs = time.perf_counter() - t0
        log = (f"# nvcc {secs:.1f} s, {len(cu)} sources in parallel\n"
               + "".join(f"# {name}: rc {rc}\n{out}"
                         for name, out, rc in outs))
        lib.with_suffix(".log").write_text(log)
        if any(rc != 0 for _, _, rc in outs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(so, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the library with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
