#!/usr/bin/env python3
"""Smoke run of mdx_torch's fused QA pass on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  Phases, each reported on its own lines:

1. device  — the card's name and power limit; TF32 off.
2. build   — nvcc builds the kernels from ``mdx_torch/csrc``.
3. kernels — each CUDA kernel (box stats, unsharp, CLAHE, TV) against its
   plain PyTorch version on the card at [4,512,512], held to
   ``mdx_torch.parity.KERNEL_TOL``; TV's per-image iteration counts must be
   equal.
4. slice   — ``qa_plan`` with the bench plan and ``qa_deterministic`` on
   [2,512,512], on the card (kernels) against the CPU (plain versions),
   within the tolerances of ``mdx_torch.parity``.
5. size    — ``qa_plan`` and ``qa_deterministic`` on bench.py's 32x512^2
   batch with every launch counter reset first; every kernel must have
   launched and every output must be finite.  Every kernel call of that run
   is recorded and replayed against the plain version on the same inputs
   (TV on the chain's intermediate, as the main path gives it).  Then
   times: img/s (median of synchronised reps) and each kernel against its
   plain version at 32x512^2, whose outputs are compared too.

The second-last line is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed.  Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

SOURCE = {"box_stats": "mdx_torch/csrc/box_stats.cu",
          "unsharp": "mdx_torch/csrc/unsharp.cu",
          "clahe": "mdx_torch/csrc/clahe.cu",
          "tv_chambolle": "mdx_torch/csrc/tv.cu"}
REPLACES = {"box_stats": "mdx/ops/pallas_kernels.py:792",
            "unsharp": "mdx/ops/pallas_kernels.py:1126",
            "clahe": "mdx/ops/pallas_kernels.py:371",
            "tv_chambolle": "mdx/ops/pallas_kernels.py:511"}
SIZE_N = 32
REPS = 7


class SmokeFailure(Exception):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _bench_plan(device):
    from mdx_torch.tools import bench_plan

    return bench_plan(device)


def _sync_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _plain_versions():
    from mdx_torch.core import metrics as M
    from mdx_torch.ops import clahe as C
    from mdx_torch.ops import filters as F
    from mdx_torch.ops import tv as T

    return {"box_stats": M._lv_box_stats_plain,
            "unsharp": F.unsharp_mask_plain,
            "clahe": C.clahe_plain,
            "tv_chambolle": T.tv_chambolle_plain}


@contextlib.contextmanager
def _recording(torch, kernels, calls: list):
    """Record (name, args, kwargs) of every kernel wrapper call, with the
    tensors cloned, while the wrappers run as usual."""
    originals = {k: getattr(kernels, k) for k in kernels.LAUNCHES}

    def recorder(name, fn):
        def call(*args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args), dict(kw)))
            return fn(*args, **kw)
        return call

    for k, fn in originals.items():
        setattr(kernels, k, recorder(k, fn))
    try:
        yield
    finally:
        for k, fn in originals.items():
            setattr(kernels, k, fn)


class KernelCheck:
    """Runs a kernel and its plain version on the same inputs, holds them to
    ``parity.KERNEL_TOL`` (and TV's iteration counts to equality), prints
    one line per comparison and keeps the worst error per kernel."""

    def __init__(self, torch, kernels, parity):
        self.torch, self.kernels, self.parity = torch, kernels, parity
        self.plain = _plain_versions()
        self.errs = {k: 0.0 for k in kernels.LAUNCHES}
        self.failed: list[str] = []

    def compare(self, label: str, name: str, got, want) -> None:
        self.torch.cuda.synchronize()
        extra = ""
        if name == "tv_chambolle":
            (got, it_k), (want, it_p) = got, want
            extra = (f"; iterations kernel {it_k.tolist()}, "
                     f"plain {it_p.tolist()}")
            if it_k.tolist() != it_p.tolist():
                self.failed.append(f"{label} {name}: iteration counts differ")
        err, ok = self.parity.kernel_parity(name, got, want)
        self.errs[name] = max(self.errs[name], err)
        rtol, atol = self.parity.KERNEL_TOL[name]
        print(f"kernel parity {label} {name}: max|d| {err!r} "
              f"(tol {atol} + {rtol}*|plain|){extra}")
        if not ok:
            self.failed.append(f"{label} {name}: max|d| {err!r}")

    def run(self, label: str, name: str, args, kw=None) -> None:
        kw = kw or {}
        self.compare(label, name, getattr(self.kernels, name)(*args, **kw),
                     self.plain[name](*args, **kw))

    def require_ok(self) -> None:
        _require(not self.failed,
                 "kernel off its plain version: " + "; ".join(self.failed))


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card and has no CPU mode", file=sys.stderr)
        return 2
    from bench import _make_batch

    from mdx_torch import kernels, parity
    from mdx_torch.core import qa
    from mdx_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, count {torch.cuda.device_count()})")
    print(f"nvidia-smi name, power.limit: {card}")
    print(f"tf32 before: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; set both False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

    # ---- 3. kernel parity at [4,512,512] ---------------------------------
    from bench import _PLAN_PARAMS as P

    def args_for(x):
        full = lambda v: torch.full((x.shape[0],), float(v), device=dev)  # noqa: E731
        return {
            "box_stats": (x,),
            "unsharp": (x, full(P["unsharp_radius"]),
                        full(P["unsharp_amount"])),
            "clahe": (x, full(P["clahe_clip_limit"]), P["clahe_tile_size"]),
            "tv_chambolle": (x, full(P["tv_denoise_weight"]), 2e-4, 200),
        }

    check = KernelCheck(torch, kernels, parity)
    for k, args in args_for(torch.from_numpy(_make_batch(4)).to(dev)).items():
        check.run("[4,512,512]", k, args)
    check.require_ok()

    # ---- 4. slice parity, card vs CPU, at [2,512,512] ---------------------
    x2 = _make_batch(2)
    failed = []
    # the bench plan runs tv_denoise; the issue-driven chain never does
    for label, fields, tv_ran, run in (
            ("qa_plan", parity.QA_PLAN_FIELDS,
             "tv_denoise" in _bench_plan("cpu")[0].ops,
             lambda x, d: qa.qa_plan(x, *_bench_plan(d))),
            ("qa_deterministic", parity.QA_DETERMINISTIC_FIELDS, False,
             lambda x, d: qa.qa_deterministic(x))):
        on_card = parity.flatten_result(
            run(torch.from_numpy(x2).to(dev), dev), fields)
        on_cpu = parity.flatten_result(
            run(torch.from_numpy(x2.copy()), "cpu"), fields)
        bad = parity.breaches(on_card, on_cpu, tv_ran=tv_ran)
        print(f"slice parity {label} [2,512,512] card vs cpu: "
              f"{len(on_cpu)} fields, enhanced max|d| "
              f"{parity.max_abs(on_card, on_cpu, 'enhanced')!r}, "
              f"score card {on_card['score'].tolist()} "
              f"cpu {on_cpu['score'].tolist()}, breaches {len(bad)}")
        for line in bad:
            print("  " + line)
        if bad:
            failed.append(label)
    _require(not failed, f"card and CPU disagree in {failed}")

    # ---- 5. the main path at 32x512^2 -------------------------------------
    x32 = torch.from_numpy(_make_batch(SIZE_N)).to(dev)
    static, dyn = _bench_plan(dev)
    calls: list = []
    torch.cuda.synchronize()
    with _recording(torch, kernels, calls):
        kernels.reset_launches()
        res_plan = qa.qa_plan(x32, static, dyn)
        res_det = qa.qa_deterministic(x32)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    print(f"launches in qa_plan + qa_deterministic at [{SIZE_N},512,512]: "
          f"{launches}")
    for k, v in launches.items():
        _require(v > 0, f"kernel {k} was not launched by the main path")
    for label, res, fields in (
            ("qa_plan", res_plan, parity.QA_PLAN_FIELDS),
            ("qa_deterministic", res_det, parity.QA_DETERMINISTIC_FIELDS)):
        flat = parity.flatten_result(res, fields)
        _require(flat["enhanced"].shape == (SIZE_N, 512, 512),
                 f"{label}: enhanced shape {flat['enhanced'].shape}")
        _require(flat["score"].shape == (SIZE_N,), f"{label}: score shape")
        for k, v in flat.items():
            _require(v.dtype == bool or k.endswith("psnr")
                     or bool(((v == v) & (abs(v) != math.inf)).all()),
                     f"{label}: non-finite values in {k}")
        print(f"{label} [{SIZE_N},512,512]: finite, mean score "
              f"{float(flat['score'].mean())!r}")
    del res_plan, res_det

    # every kernel call of the main path, replayed on its own inputs
    seen: dict[str, int] = {}
    for k, args, kw in calls:
        seen[k] = seen.get(k, 0) + 1
        shape = "x".join(map(str, args[0].shape))
        check.run(f"main path call {seen[k]} [{shape}]", k, args, kw)
    del calls
    check.require_ok()

    for label, fn in (("qa_plan", lambda: qa.qa_plan(x32, static, dyn)),
                      ("qa_deterministic", lambda: qa.qa_deterministic(x32))):
        fn()
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(f"{label} [{SIZE_N},512,512] on {card}: median {med * 1e3!r} ms "
              f"of {REPS} reps (min {min(times) * 1e3!r}, max "
              f"{max(times) * 1e3!r}), {SIZE_N / med!r} img/s")

    rows = []
    for k, args in args_for(x32).items():
        outs = {}

        def kern(k=k, args=args):
            outs["kernel"] = getattr(kernels, k)(*args)

        def plain(k=k, args=args):
            outs["plain"] = check.plain[k](*args)

        reps = 3 if k == "tv_chambolle" else 20
        p1 = _sync_ms(torch, plain, reps)
        k1 = _sync_ms(torch, kern, reps)
        k2 = _sync_ms(torch, kern, reps)
        p2 = _sync_ms(torch, plain, reps)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"time [{SIZE_N},512,512] {k} on {card}: kernel {ms!r} ms "
              f"({k1!r}, {k2!r}), plain {plain_ms!r} ms ({p1!r}, {p2!r})")
        check.compare(f"[{SIZE_N},512,512] raw batch", k, outs["kernel"],
                      outs["plain"])
        rows.append({"name": k, "route": "cuda", "source": SOURCE[k],
                     "replaces": REPLACES[k], "launches": launches[k],
                     "max_abs_err": check.errs[k], "ms": ms,
                     "plain_ms": plain_ms})
    check.require_ok()

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
