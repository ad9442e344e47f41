#!/usr/bin/env python3
"""Smoke run of mdx_torch's fused QA pass on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  Phases, each reported on its own lines:

1. device  — the card's name and power limit; TF32 off.
2. build   — nvcc builds the kernels from ``mdx_torch/csrc``.
3. kernels — each CUDA kernel (box stats, unsharp, CLAHE, TV, bilateral)
   against its plain PyTorch version on the card at [4,512,512], held to
   ``mdx_torch.parity.KERNEL_TOL``; TV's per-image iteration counts must be
   equal.
4. slice   — ``qa_plan`` with the bench plan and ``qa_deterministic`` on
   [2,512,512], on the card (kernels) against the CPU (plain versions),
   within the tolerances of ``mdx_torch.parity``.
5. 512^2   — ``qa_plan`` and ``qa_deterministic`` on the bench's 32x512^2
   batch with every launch counter reset first; every kernel must have
   launched and every output must be finite.  Every kernel call of that run
   is recorded and replayed against the plain version on the same inputs
   (TV on the chain's intermediate, as the main path gives it).  Then
   times: img/s (median of synchronised reps) and each kernel against its
   plain version at 32x512^2, whose outputs are compared too.
6. 2048^2  — BASELINE config 2 and the large-slice path:
   1. each kernel against its plain version at [1,2048,2048];
   2. config 2 (``mdx_torch.tools.bench_config2``: denoise, CLAHE, unsharp
      and the guards, in groups of ``group_limit``) on 64x2048^2, counters
      reset first: box stats, CLAHE and unsharp must launch, the output
      must be finite; the kernel calls of the first group are recorded and
      replayed against the plain versions;
   3. ``qa_plan`` with the bench plan at 16x2048^2 (one group; the batch
      cut from 64 so that TV and bilateral run at 2048^2): all five kernels
      must launch, outputs finite, every kernel call replayed;
   4. config 2's ``apply_plan`` at [1,2048,2048] on the card against the
      CPU, within ``parity.breaches``;
   5. times: config 2 at 64x2048^2 (ms per batch, img/s, peak memory) and
      each kernel against its plain version at 16x2048^2, the group the
      2048^2 path hands each kernel.

The second-last line is one JSON object with a row per kernel (times at
16x2048^2, with the 32x512^2 times under ``by_size``; ``bound_ms`` from
this run's shapes, and for TV its iteration counts); the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import sys
import time

SOURCE = {"box_stats": "mdx_torch/csrc/box_stats.cu",
          "unsharp": "mdx_torch/csrc/unsharp.cu",
          "clahe": "mdx_torch/csrc/clahe.cu",
          "tv_chambolle": "mdx_torch/csrc/tv.cu",
          "bilateral": "mdx_torch/csrc/bilateral.cu"}
_PK = "mdx/ops/pallas_kernels.py"
REPLACES = {"box_stats": [f"{_PK}:792"],
            "unsharp": [f"{_PK}:1126", f"{_PK}:1388"],
            "clahe": [f"{_PK}:371", f"{_PK}:654"],
            "tv_chambolle": [f"{_PK}:511", f"{_PK}:906"],
            "bilateral": [f"{_PK}:1229", f"{_PK}:1301"]}
SIZE_N = 32
BIG, CONFIG2_N, QA_BIG_N = 2048, 64, 16
REPS = 7

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per pixel each kernel's function needs, counted from
# its arithmetic (TV: per pixel and iteration; bilateral: 8 per window tap,
# the exp counted as one, plus 2): box stats 7x7 and 16x16 sums of x and
# x^2 both ways, scales, variances, sqrt, and the two reduction passes;
# unsharp 25-tap rows and columns and the combine; CLAHE the bin index,
# the clipped LUT per bin (256 bins per 16x16 tile) and the 4-LUT blend.
OPS_PER_PIXEL = {"box_stats": 130, "unsharp": 103, "clahe": 47,
                 "tv_chambolle": 23}


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


def _median_ms(torch, fn, reps: int) -> tuple[float, list[float]]:
    """Median ms of ``reps`` synchronised calls on the host clock, after one
    warm-up, and all the times."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _plain_versions():
    from mdx_torch.core import metrics as M
    from mdx_torch.ops import bilateral as B
    from mdx_torch.ops import clahe as C
    from mdx_torch.ops import filters as F
    from mdx_torch.ops import tv as T

    return {"box_stats": M._lv_box_stats_plain,
            "unsharp": F.unsharp_mask_plain,
            "clahe": C.clahe_plain,
            "tv_chambolle": T.tv_chambolle_plain,
            "bilateral": B.bilateral_plain}


def _bound(torch, name: str, args, result) -> tuple[float, str]:
    """(least ms the card could take for this call, "bytes" or
    "operations"): each input read once and each output written once over
    the memory rate, against the operations over the float32 peak."""
    n, h, w = args[0].shape
    px = n * h * w
    moved = sum(a.numel() * a.element_size() for a in args
                if torch.is_tensor(a))
    if name == "box_stats":
        moved += 3 * 4 * n
    else:
        moved += 4 * px + (4 * n if name == "tv_chambolle" else 0)
    if name == "bilateral":
        ops = px * (8 * args[1] ** 2 + 2)
    elif name == "tv_chambolle":
        ops = h * w * int(result[1].sum()) * OPS_PER_PIXEL[name]
    else:
        ops = px * OPS_PER_PIXEL[name]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def _recording(torch, kernels, calls: list, when=lambda: True):
    """Record (name, args, kwargs) of every kernel wrapper call made while
    ``when()`` is true, with the tensors cloned, while the wrappers run as
    usual."""
    originals = {k: getattr(kernels, k) for k in kernels.LAUNCHES}

    def recorder(name, fn):
        def call(*args, **kw):
            if when():
                calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                          else a for a in args), dict(kw)))
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

    def replay(self, label: str, calls: list) -> None:
        """Each recorded main-path call against the plain version."""
        seen: dict[str, int] = {}
        for k, args, kw in calls:
            seen[k] = seen.get(k, 0) + 1
            shape = "x".join(map(str, args[0].shape))
            self.run(f"{label} call {seen[k]} [{shape}]", k, args, kw)
        print(f"replayed {label}: {seen}")

    def require_ok(self) -> None:
        _require(not self.failed,
                 "kernel off its plain version: " + "; ".join(self.failed))


def _args_for(torch, x, params):
    """Each kernel's arguments at the bench plan's parameters."""
    full = lambda v: torch.full((x.shape[0],), float(v), device=x.device)  # noqa: E731
    return {
        "box_stats": (x,),
        "unsharp": (x, full(params["unsharp_radius"]),
                    full(params["unsharp_amount"])),
        "clahe": (x, full(params["clahe_clip_limit"]),
                  params["clahe_tile_size"]),
        "tv_chambolle": (x, full(params["tv_denoise_weight"]), 2e-4, 200),
        "bilateral": (x, params["bilateral_d"],
                      full(params["bilateral_sigma_color"]),
                      full(params["bilateral_sigma_space"])),
    }


def _require_finite(label: str, flat: dict, n: int, hw: int) -> None:
    _require(flat["enhanced"].shape == (n, hw, hw),
             f"{label}: enhanced shape {flat['enhanced'].shape}")
    _require(flat["score"].shape == (n,), f"{label}: score shape")
    for k, v in flat.items():
        _require(v.dtype == bool or k.endswith("psnr")
                 or bool(((v == v) & (abs(v) != math.inf)).all()),
                 f"{label}: non-finite values in {k}")
    print(f"{label} [{n},{hw},{hw}]: finite, mean score "
          f"{float(flat['score'].mean())!r}")


def _time_kernels(torch, kernels, check, x, params, card: str) -> dict:
    """Each kernel against its plain version on ``x`` (plain, kernel,
    kernel, plain; CUDA events), outputs compared; per kernel: ms,
    plain_ms, bound_ms, bound_by (and TV's iterations)."""
    label = "x".join(map(str, x.shape))
    out = {}
    for k, args in _args_for(torch, x, params).items():
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
        bound_ms, bound_by = _bound(torch, k, args, outs["kernel"])
        print(f"time [{label}] {k} on {card}: kernel {ms!r} ms "
              f"({k1!r}, {k2!r}), plain {plain_ms!r} ms ({p1!r}, {p2!r}), "
              f"bound {bound_ms!r} ms ({bound_by})")
        check.compare(f"[{label}] raw batch", k, outs["kernel"],
                      outs["plain"])
        out[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by}
        if k == "tv_chambolle":
            out[k]["iterations"] = outs["kernel"][1].tolist()
        del outs
    check.require_ok()
    return out


def _run_path(torch, kernels, label: str, fn):
    """``fn()`` with every launch counter reset just before and read just
    after; returns (result, launches)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches in {label}: {launches}")
    return res, launches


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card and has no CPU mode", file=sys.stderr)
        return 2
    from mdx_torch import kernels, parity
    from mdx_torch.core import enhance as E
    from mdx_torch.core import qa
    from mdx_torch.core.batching import group_limit, map_subbatches
    from mdx_torch.kernels import _build
    from mdx_torch.tools import (PLAN_PARAMS, bench_config2, card_line,
                                 config2_plan, make_batch)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
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
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or line.startswith("#")):
            print("  " + line.strip())

    # ---- 3. kernel parity at [4,512,512] ---------------------------------
    check = KernelCheck(torch, kernels, parity)
    x4 = torch.from_numpy(make_batch(4)).to(dev)
    for k, args in _args_for(torch, x4, PLAN_PARAMS).items():
        check.run("[4,512,512]", k, args)
    check.require_ok()
    del x4

    # ---- 4. slice parity, card vs CPU, at [2,512,512] ---------------------
    x2 = make_batch(2)
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
    x32 = torch.from_numpy(make_batch(SIZE_N)).to(dev)
    static, dyn = _bench_plan(dev)
    calls: list = []
    paths: dict[str, dict] = {}
    with _recording(torch, kernels, calls):
        (res_plan, res_det), paths["qa_512"] = _run_path(
            torch, kernels, f"qa_plan + qa_deterministic at "
            f"[{SIZE_N},512,512]",
            lambda: (qa.qa_plan(x32, static, dyn), qa.qa_deterministic(x32)))
    for k, v in paths["qa_512"].items():
        _require(v > 0, f"kernel {k} was not launched by the 512^2 path")
    for label, res, fields in (
            ("qa_plan", res_plan, parity.QA_PLAN_FIELDS),
            ("qa_deterministic", res_det, parity.QA_DETERMINISTIC_FIELDS)):
        _require_finite(label, parity.flatten_result(res, fields), SIZE_N,
                        512)
    del res_plan, res_det
    check.replay("512^2 main path", calls)
    del calls
    check.require_ok()

    for label, fn in (("qa_plan", lambda: qa.qa_plan(x32, static, dyn)),
                      ("qa_deterministic", lambda: qa.qa_deterministic(x32))):
        med, times = _median_ms(torch, fn, REPS)
        print(f"{label} [{SIZE_N},512,512] on {card}: median {med!r} ms "
              f"of {REPS} reps (min {min(times)!r}, max {max(times)!r}), "
              f"{SIZE_N / med * 1e3!r} img/s")
    times_512 = _time_kernels(torch, kernels, check, x32, PLAN_PARAMS, card)
    del x32
    print(f"phases 1-5: {time.perf_counter() - t_start:.1f} s")

    # ---- 6. the 2048^2 path ------------------------------------------------
    t6 = time.perf_counter()
    x64 = torch.from_numpy(make_batch(CONFIG2_N, BIG)).to(dev)
    print(f"make_batch({CONFIG2_N}, {BIG}) to the card: "
          f"{time.perf_counter() - t6:.1f} s")
    x1 = x64[:1]

    # 6.1 each kernel against its plain version at [1,2048,2048]
    for k, args in _args_for(torch, x1, PLAN_PARAMS).items():
        check.run(f"[1,{BIG},{BIG}]", k, args)
    check.require_ok()

    # 6.2 config 2 at 64x2048^2; the first group's kernel calls recorded
    static2, dyn2 = config2_plan(dev)
    group = group_limit(x64.shape)
    step = bench_config2.step_fn(static2, bare=False)
    groups_run = [0]

    def counted_step(x, d):
        groups_run[0] += 1
        return step(x, d)

    calls = []
    with _recording(torch, kernels, calls, when=lambda: groups_run[0] == 1):
        out2, paths["config2_2048"] = _run_path(
            torch, kernels, f"config 2 at [{CONFIG2_N},{BIG},{BIG}] in "
            f"groups of {group}",
            lambda: map_subbatches(counted_step, x64, dyn2, groups=(group,)))
    for k in ("box_stats", "clahe", "unsharp"):
        _require(paths["config2_2048"][k] > 0,
                 f"kernel {k} was not launched by config 2")
    _require(tuple(out2.shape) == tuple(x64.shape),
             f"config 2: output shape {tuple(out2.shape)}")
    _require(bool(torch.isfinite(out2).all()), "config 2: non-finite output")
    print(f"config 2 [{CONFIG2_N},{BIG},{BIG}]: finite, {groups_run[0]} "
          f"groups, mean {float(out2.mean())!r}")
    del out2
    check.replay(f"config 2 group 1 of {groups_run[0]}", calls)
    del calls
    check.require_ok()

    # 6.3 qa_plan with the bench plan at 16x2048^2
    x16 = x64[:QA_BIG_N]
    calls = []
    with _recording(torch, kernels, calls):
        res, paths["qa_plan_2048"] = _run_path(
            torch, kernels, f"qa_plan at [{QA_BIG_N},{BIG},{BIG}]",
            lambda: qa.qa_plan(x16, static, dyn))
    for k, v in paths["qa_plan_2048"].items():
        _require(v > 0, f"kernel {k} was not launched by qa_plan at 2048^2")
    _require_finite("qa_plan", parity.flatten_result(
        res, parity.QA_PLAN_FIELDS), QA_BIG_N, BIG)
    del res
    check.replay(f"qa_plan [{QA_BIG_N},{BIG},{BIG}]", calls)
    del calls
    check.require_ok()
    torch.cuda.empty_cache()

    # 6.4 config 2, card against CPU at [1,2048,2048]
    t0 = time.perf_counter()
    x1_cpu = x1.cpu()
    fields = ("enhanced", "flags")
    on_card = parity.flatten_result(E.apply_plan(x1, static2, dyn2), fields)
    on_cpu = parity.flatten_result(
        E.apply_plan(x1_cpu, *config2_plan("cpu")), fields)
    bad = parity.breaches(on_card, on_cpu)
    print(f"slice parity config 2 [1,{BIG},{BIG}] card vs cpu: "
          f"{len(on_cpu)} fields, enhanced max|d| "
          f"{parity.max_abs(on_card, on_cpu, 'enhanced')!r}, breaches "
          f"{len(bad)} ({time.perf_counter() - t0:.1f} s)")
    for line in bad:
        print("  " + line)
    _require(not bad, "card and CPU disagree on config 2 at 2048^2")

    # 6.5 times
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, times = _median_ms(
        torch, lambda: bench_config2.run_config2(x64, static2, dyn2, group),
        REPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"config 2 [{CONFIG2_N},{BIG},{BIG}] groups of {group} on {card}: "
          f"median {med!r} ms per batch of {REPS} reps (min {min(times)!r}, "
          f"max {max(times)!r}), {CONFIG2_N / med * 1e3!r} img/s, peak "
          f"memory {peak!r} GiB")
    times_big = _time_kernels(torch, kernels, check, x16, PLAN_PARAMS, card)
    del x64, x1, x16
    print(f"phase 6: {time.perf_counter() - t6:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s")

    rows = []
    shape_512 = f"{SIZE_N}x512x512"
    shape_big = f"{QA_BIG_N}x{BIG}x{BIG}"
    for k in kernels.LAUNCHES:
        big = times_big[k]
        rows.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k],
            "launches": sum(p[k] for p in paths.values()),
            "launches_by_path": {p: v[k] for p, v in paths.items()},
            "max_abs_err": check.errs[k], "shape": shape_big,
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None,
            "by_size": {shape_512: times_512[k], shape_big: big}})
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
