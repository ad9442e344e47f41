"""Where the time of one ``qa_plan`` pass goes, on a CUDA card.

    python -m mdx_torch.tools.profile_pass [--n 32] [--size 512] [--trace PATH]

Run from the root of a checkout.  The batch (by default 32x512^2, the TPU
headline's) and the plan are ``mdx_torch.tools.make_batch`` and
``bench_plan``.  It prints:

1. ms per phase, each the median of ``REPS`` synchronised calls on the
   host clock: the whole ``qa_plan`` pass; ``image_stats`` and three of its
   parts; each op of the bench plan's chain on the previous op's output
   (the wavelet denoise also as its kernel and as its plain version with
   sigma given); the three guards; validation; ``qa_deterministic``.
2. One ``qa_plan`` pass under ``torch.profiler``: its wall time (host
   clock, synchronised, profiler on), the number of device kernels, their
   summed time, the busy time (the union of the kernel intervals) and the
   idle share, 1 - busy / wall, all of that same traced pass.  Then the
   ``TOP`` kernels by time and the time per kernel family.  The chrome
   trace goes to ``--trace`` (default ``build/profile_pass_trace.json``).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
N, SIZE, REPS, TOP = 32, 512, 5, 30
FAMILIES = (
    ("sort", ("RadixSort", "sort")),
    ("histogram", ("Histogram",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
    ("index/gather/cat", ("gather", "index", "Cat", "scatter")),
)


def _our_kernels() -> set[str]:
    """Names of the ``__global__`` functions in ``mdx_torch/csrc``."""
    pattern = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
               r"(\w+)\s*\(")
    names = set()
    for src in (ROOT / "mdx_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(pattern, src.read_text()))
    return names


def _family(name: str, ours: set[str]) -> str:
    if any(f"{k}(" in name or f"{k}<" in name for k in ours):
        return "mdx_torch kernels"
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phases(x, static, dyn, reps: int,
           only=None) -> list[tuple[str, float]]:
    """(label, ms) per phase; ``only``: the labels to time (the chain still
    runs each op once, so every op gets its real input)."""
    from mdx_torch.core import enhance as E
    from mdx_torch.core import metrics as M
    from mdx_torch.core import qa
    from mdx_torch import kernels
    from mdx_torch.core.validate import validate
    from mdx_torch.ops import wavelet as W
    from mdx_torch.tools import all_ops_masks

    rows = []

    def timed(label, fn):
        if only is None or label in only:
            rows.append((label, _median_ms(fn, reps)))

    timed("qa_plan total", lambda: qa.qa_plan(x, static, dyn))
    timed("image_stats", lambda: M.image_stats(x))
    timed("  estimate_sigma", lambda: W.estimate_sigma(x))
    timed("  percentiles x4",
          lambda: M._percentiles(x, [5.0, 25.0, 75.0, 95.0]))
    timed("  box stats", lambda: M._lv_box_stats(x))
    masks = all_ops_masks(x.shape[0], x.device)
    out = x
    for op in (o for o in E.OP_ORDER if o in static.ops):
        def run(op=op, inp=out):
            return E._run_chain(inp, (op,), static, dyn, masks,
                                dyn.unsharp_amount)
        timed(f"op {op}", run)
        if op == "denoise":
            sig = W.mad_sigma_from_hh(W.dwt2(out, "db1")[1][2]).contiguous()
            soft = torch.ones(out.shape[0], dtype=torch.bool,
                              device=out.device)
            lv = W.default_levels(out.shape[-2:])
            timed("  wavelet_denoise kernel, sigma given",
                  lambda inp=out: kernels.wavelet_denoise(inp, sig, soft, lv))
            timed("  denoise_wavelet_plain, sigma given",
                  lambda inp=out: W.denoise_wavelet_plain(
                      inp, sig, wavelet_levels=lv, soft_mask=soft))
        out = run()
    out = torch.clamp(out, 0.0, 1.0)
    stats = M.image_stats(x)
    timed("guard halo (edge ratio)", lambda: M.compute_edge_ratio(out))
    timed("guard noise (2x estimate_sigma)", lambda: E._noise_amp(x, out))
    timed("guard over-processing (niqe)", lambda: M.compute_niqe(out))
    timed("validate (image_stats + ssim + psnr)",
          lambda: validate(x, out, stats_before=stats))
    timed("qa_deterministic total", lambda: qa.qa_deterministic(x))
    return rows


def traced_pass(x, static, dyn, trace: Path) -> dict:
    """One qa_plan pass under torch.profiler; numbers of that pass only."""
    from torch.profiler import ProfilerActivity, profile

    from mdx_torch.core import qa

    qa.qa_plan(x, static, dyn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qa.qa_plan(x, static, dyn)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())
    events = events.get("traceEvents", events)
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, -float("inf")
    for s, e, _ in kern:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"wall_us": wall_us, "kernels": kern, "busy_us": busy,
            "summed_us": sum(e - s for s, e, _ in kern)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--trace", type=Path,
                    default=ROOT / "build" / "profile_pass_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pass needs a CUDA card")

    from mdx_torch.tools import bench_plan, card_line, make_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    x = torch.from_numpy(make_batch(args.n, args.size)).to(dev)
    static, dyn = bench_plan(dev)
    print(f"ms per phase, [{args.n},{args.size},{args.size}], median of "
          f"{REPS} synchronised calls:")
    for label, ms in phases(x, static, dyn, REPS):
        print(f"{label:<45} {ms:9.3f} ms")

    t = traced_pass(x, static, dyn, args.trace)
    print(f"traced qa_plan pass: wall {t['wall_us'] / 1e3:.3f} ms, "
          f"{len(t['kernels'])} device kernels, summed kernel time "
          f"{t['summed_us'] / 1e3:.3f} ms, busy {t['busy_us'] / 1e3:.3f} ms, "
          f"idle share {1 - t['busy_us'] / t['wall_us']:.3f}")
    by_name: dict[str, list[float]] = {}
    for s, e, name in t["kernels"]:
        by_name.setdefault(name, []).append(e - s)
    total = t["summed_us"]
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[
            :TOP]:
        print(f"{sum(durs) / 1e3:9.3f} ms {100 * sum(durs) / total:5.1f}% "
              f"x {len(durs):4d}  {name[:90]}")
    ours = _our_kernels()
    fams: dict[str, float] = {}
    for s, e, name in t["kernels"]:
        fam = _family(name, ours)
        fams[fam] = fams.get(fam, 0.0) + (e - s) / 1e3
    fams = dict(sorted(fams.items(), key=lambda kv: -kv[1]))
    print("ms per kernel family: " + json.dumps(
        {k: round(v, 3) for k, v in fams.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
