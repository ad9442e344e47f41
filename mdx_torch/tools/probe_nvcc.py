"""Probe what nvcc, ptxas and the card make of the TPU probe's data
movements: the Hopper counterpart of ``tools/probe_mosaic.py``.

    python -m mdx_torch.tools.probe_nvcc [--only substr] [--json] [--time]

The TPU tool wraps one single-block ``pallas_call`` (``_run``) around each
of 18 one-op bodies (lane and sublane gathers, a split 256-entry LUT
select, reshapes, interleaves, transposes, strided slices, an iota-select
matmul) on fixed arange inputs, and prints whether Mosaic compiled each and
got the numpy answer.  Here each probe is one CUDA kernel in
``mdx_torch/csrc/probes/<name>.cu`` with the same input and output, written
in the form a Hopper kernel uses for that movement (see ``probe.cuh``).
Every probe builds in its own ``nvcc`` process (the kernel library's
``NVCC_FLAGS``), all started together, into ``build/mdx_torch_probes/``,
named by a hash of its source, the shared header and the flags; one that
nvcc or ptxas refuses fails alone.

Each probe prints ``name  ok | WRONG RESULT | FAIL: <first nvcc/ptxas error
line>`` and its ptxas registers and spills; ``--json`` prints one JSON
object instead; ``--time`` adds each probe's device time a launch and its
PyTorch call's (``mdx_torch.tools.device_ms``; a copy of this file and of
``tools/__init__.py`` times a parent checkout's probes too).  ``PLAIN``
holds the plain PyTorch version of each probe:
the numpy check of ``tools/probe_mosaic.py`` on tensors.  The result must
equal it exactly where the TPU tool uses ``np.array_equal`` and to
``np.allclose`` where it uses that.  Without a CUDA card the tool exits
non-zero.  ``chip_smoke.py`` phase 11 drives the same functions.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
PROBE_DIR = _PKG_DIR / "csrc" / "probes"
BUILD_DIR = _PKG_DIR.parent / "build" / "mdx_torch_probes"

# the TPU probe's inputs: aranges of three shapes
_BASES = {"x128": (8, 128), "x256": (16, 256), "x512": (256, 512)}


def _base(name: str, device) -> torch.Tensor:
    h, w = _BASES[name]
    return torch.arange(h * w, dtype=torch.float32, device=device).reshape(
        h, w)


def _idx(values, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, device=x.device)


def _pair_sum(x):
    return x[:, ::2] + x[:, 1::2]


def _interleave_halves(x):
    return torch.stack([x[:, :256], x[:, 256:]], dim=-1).reshape(256, 512)


# name → (base, rows/columns of the base it reads, output shape, exact,
#         plain version, one PyTorch call that computes it)
# ``exact``: the TPU tool checks with np.array_equal (else np.allclose).
PROBES = {
    "gather_narrow_idx_16lane": (
        "x128", (slice(None), slice(None)), (8, 128), True,
        lambda x: x[:, _idx((torch.arange(16) * 7) % 128, x)].repeat(1, 8),
        lambda x: torch.index_select(
            x, 1, _idx(((torch.arange(128) % 16) * 7) % 128, x))),
    "gather_many_sublane_vregs": (
        "x512", (slice(None), slice(0, 128)), (256, 128), True,
        lambda x: x.flip(1), lambda x: torch.flip(x, [1])),
    "split_lut_256_select": (
        "x256", (slice(0, 8), slice(None)), (8, 512), True,
        lambda x: x[:, _idx(torch.arange(512) % 256, x)],
        lambda x: torch.index_select(x, 1, _idx(torch.arange(512) % 256, x))),
    "gather_lanes_within_vreg": (
        "x128", (slice(None), slice(None)), (8, 128), True,
        lambda x: x.flip(1), lambda x: torch.flip(x, [1])),
    "gather_lanes_2vreg": (
        "x256", (slice(None), slice(None)), (16, 256), True,
        lambda x: x.flip(1), lambda x: torch.flip(x, [1])),
    "gather_sublanes_within_vreg": (
        "x128", (slice(None), slice(None)), (8, 128), True,
        lambda x: x.flip(0), lambda x: torch.flip(x, [0])),
    "gather_sublanes_2vreg": (
        "x256", (slice(None), slice(None)), (16, 256), True,
        lambda x: x.flip(0), lambda x: torch.flip(x, [0])),
    "gather_lanes_wide_idx_narrow_src": (
        "x512", (slice(0, 8), slice(None)), (8, 512), True,
        lambda x: x[:, :128][:, _idx(torch.arange(512) % 128, x)],
        lambda x: torch.index_select(x, 1, _idx(torch.arange(512) % 128, x))),
    "reshape_split_sublanes": (
        "x512", (slice(None), slice(None)), (128, 512), False,
        lambda x: x.reshape(128, 2, 512).sum(1),
        lambda x: torch.sum(x.view(128, 2, 512), 1)),
    "reshape_split_lanes": (
        "x512", (slice(None), slice(None)), (256, 256), False,
        lambda x: x.reshape(256, 256, 2).sum(-1),
        lambda x: torch.sum(x.view(256, 256, 2), -1)),
    "stack_interleave_lanes": (
        "x512", (slice(None), slice(None)), (256, 512), False,
        _interleave_halves,
        lambda x: torch.stack([x[:, :256], x[:, 256:]], dim=-1)),
    "stack_interleave_sublanes": (
        "x512", (slice(None), slice(None)), (256, 512), False,
        lambda x: torch.stack([x[128:], x[:128]], dim=1).reshape(256, 512),
        lambda x: torch.stack([x[128:], x[:128]], dim=1)),
    "transpose_2d": (
        "x512", (slice(None), slice(None)), (512, 256), True,
        lambda x: x.T, lambda x: x.T.contiguous()),
    "strided_slice_lanes": (
        "x512", (slice(None), slice(None)), (256, 256), False,
        _pair_sum, lambda x: torch.sum(x.view(256, 256, 2), -1)),
    "transpose_bridge_deint_cols": (
        "x512", (slice(None), slice(None)), (256, 256), False,
        _pair_sum, lambda x: torch.sum(x.view(256, 256, 2), -1)),
    "transpose_bridge_int_cols": (
        "x512", (slice(None), slice(None)), (256, 512), False,
        _interleave_halves,
        lambda x: torch.stack([x[:, :256], x[:, 256:]], dim=-1)),
    "transpose_small_16x16": (
        "x256", (slice(None), slice(None)), (16, 16), True,
        lambda x: x[:16, :16].T, lambda x: x[:16, :16].T.contiguous()),
    "iota_select_matmul_deinterleave": (
        "x512", (slice(None), slice(None)), (256, 256), False,
        _pair_sum, lambda x: torch.sum(x.view(256, 256, 2), -1)),
}

PLAIN = {name: spec[4] for name, spec in PROBES.items()}
LIBRARY = {name: spec[5] for name, spec in PROBES.items()}

# launches of each probe's kernel through :func:`launch`
LAUNCHES: dict[str, int] = {name: 0 for name in PROBES}


def probe_input(name: str, device="cpu") -> torch.Tensor:
    """The probe's input: the TPU tool's arange (or its slice), contiguous."""
    base, sl = PROBES[name][0], PROBES[name][1]
    return _base(base, device)[sl].contiguous()


# each probe's input shape, for the launch's check
INPUT_SHAPE = {name: tuple(probe_input(name, "meta").shape)
               for name in PROBES}


def plain_output(name: str, x: torch.Tensor) -> torch.Tensor:
    return PLAIN[name](x).contiguous()


def matches(name: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    """The TPU tool's check: exactly equal, or ``np.allclose``'s bound
    (rtol 1e-5, atol 1e-8)."""
    if tuple(got.shape) != tuple(want.shape):
        return False
    if PROBES[name][3]:
        return bool(torch.equal(got, want))
    return bool(torch.allclose(got, want, rtol=1e-5, atol=1e-8))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


@dataclass
class Built:
    """One probe's build: the library (None if nvcc failed), the first
    error line, ptxas registers and spill bytes, nvcc's output."""

    name: str
    library: Path | None
    error: str
    registers: int | None
    spill_stores: int | None
    spill_loads: int | None
    log: str


def _library_path(name: str) -> Path:
    from mdx_torch.kernels import _build

    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update((PROBE_DIR / f"{name}.cu").read_bytes())
    h.update((PROBE_DIR / "probe.cuh").read_bytes())
    return BUILD_DIR / f"probe_{name}_{h.hexdigest()[:16]}.so"


def _ptxas(log: str):
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    return ((int(regs[-1]) if regs else None),
            *((int(spills[-1][0]), int(spills[-1][1])) if spills
              else (None, None)))


def _first_error(log: str) -> str:
    for line in log.splitlines():
        if "error" in line.lower():
            return line.strip()[:200]
    return (log.strip().splitlines() or ["nvcc failed"])[0][:200]


def build(names=None) -> dict[str, Built]:
    """Build the probes (all by default), one nvcc each, all started
    together; a library that exists for the current source is reused."""
    from mdx_torch.kernels import _build

    names = list(PROBES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}          # name → (library, its temporary name, nvcc or None)
    for name in names:
        lib = _library_path(name)
        tmp = lib.with_suffix(f".tmp{time.monotonic_ns()}.so")
        procs[name] = (lib, tmp, None if lib.exists() else subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(tmp),
             str(PROBE_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, tmp, proc) in procs.items():
        if proc is None:
            log, rc = lib.with_suffix(".log").read_text(), 0
        else:
            log, rc = proc.communicate()[0], proc.returncode
            lib.with_suffix(".log").write_text(log)
            if rc == 0:
                tmp.replace(lib)
            else:
                tmp.unlink(missing_ok=True)
        regs, stores, loads = _ptxas(log)
        out[name] = Built(name, lib if rc == 0 else None,
                          "" if rc == 0 else _first_error(log), regs, stores,
                          loads, log)
    return out


# ---------------------------------------------------------------------------
# Run
# ---------------------------------------------------------------------------

_LOADED: dict[Path, ctypes.CDLL] = {}


def _load(path: Path) -> ctypes.CDLL:
    if path not in _LOADED:
        lib = ctypes.CDLL(str(path))
        lib.mdx_probe.argtypes = (ctypes.c_void_p,) * 3
        lib.mdx_probe.restype = ctypes.c_int
        _LOADED[path] = lib
    return _LOADED[path]


def launch(name: str, built: Built, x: torch.Tensor) -> torch.Tensor:
    """One launch of the probe's kernel on the CUDA tensor ``x`` (its
    input) → a new output tensor; raises on a refused launch."""
    if x.device.type != "cuda" or not x.is_contiguous() \
            or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected a contiguous float32 CUDA tensor")
    if tuple(x.shape) != INPUT_SHAPE[name]:
        raise ValueError(f"{name}: expected shape {INPUT_SHAPE[name]}, "
                         f"got {tuple(x.shape)}")
    if built.library is None:
        raise RuntimeError(f"{name}: not built: {built.error}")
    out = torch.empty(PROBES[name][2], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _load(built.library).mdx_probe(
            x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
    return out


def bound_ms(name: str) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the input
    read once and the output written once at 3.35 TB/s, against the
    float32 operations at 67 TFLOP/s (the pair sums one an output; the
    select matmul three, the two products its selection matrices keep and
    their sum: its other terms are products with zeros)."""
    n_in = probe_input(name).numel()
    rows, cols = PROBES[name][2]
    n_out = rows * cols
    if name == "iota_select_matmul_deinterleave":
        ops = 3 * n_out
    elif PROBES[name][3]:
        ops = 0
    else:
        ops = n_out
    t_bytes = 4 * (n_in + n_out) / 3.35e12
    t_ops = ops / 67e12
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _events_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_probe(name: str, built: Built, x: torch.Tensor,
               reps: int = 200) -> dict:
    """ms per launch of the kernel, the plain version and the one PyTorch
    call (CUDA events; plain, kernel, kernel, plain), with the bound."""
    kern = lambda: launch(name, built, x)          # noqa: E731
    plain = lambda: PLAIN[name](x).contiguous()    # noqa: E731
    lib = lambda: LIBRARY[name](x)                 # noqa: E731
    p1 = _events_ms(plain, reps)
    k1 = _events_ms(kern, reps)
    k2 = _events_ms(kern, reps)
    p2 = _events_ms(plain, reps)
    b, by = bound_ms(name)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "library_ms": _events_ms(lib, reps), "bound_ms": b,
            "bound_by": by}


def run_suite(names=None, device="cuda") -> dict[str, dict]:
    """Build and run each probe once → {name: {"result", "registers",
    "spill_stores", "spill_loads", "max_abs_err", "library_equal"}}.
    ``result`` is "ok", "WRONG RESULT" or "FAIL: <error>"."""
    built = build(names)
    out = {}
    for name, b in built.items():
        row = {"registers": b.registers, "spill_stores": b.spill_stores,
               "spill_loads": b.spill_loads}
        if b.library is None:
            row["result"] = f"FAIL: {b.error}"
        else:
            x = probe_input(name, device)
            got = launch(name, b, x)
            torch.cuda.synchronize()
            want = plain_output(name, x)
            row["max_abs_err"] = (float((got - want).abs().max())
                                  if got.shape == want.shape else None)
            row["result"] = "ok" if matches(name, got, want) else \
                "WRONG RESULT"
            row["library_equal"] = bool(torch.equal(
                LIBRARY[name](x).reshape(want.shape), want))
        out[name] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--time", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_nvcc: needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    names = [n for n in PROBES if a.only in n]
    res = run_suite(names)
    if a.time:
        from mdx_torch.tools import device_ms

        built = build(names)
        for name in names:
            x = probe_input(name, "cuda")
            res[name]["device_ms"] = device_ms(
                lambda: launch(name, built[name], x), 20,
                ("k(float const*, float*)",))
            res[name]["library_device_ms"] = device_ms(
                lambda: LIBRARY[name](x), 20)
    if a.json:
        print(json.dumps(res))
    else:
        for name, r in res.items():
            print(f"{name:38s} {r['result']}  (registers {r['registers']}, "
                  f"spill {r['spill_stores']}/{r['spill_loads']} B)"
                  + (f"; device {r['device_ms']!r} ms, its PyTorch call "
                     f"{r['library_device_ms']!r} ms" if a.time else ""))
    return 0 if all(r["result"] == "ok" for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
