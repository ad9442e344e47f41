"""Per-launch device times of the wavelet denoise (kernel 10), CLAHE
(kernel C), unsharp (kernel U) and bilateral (kernel 5) wrappers, from a
``torch.profiler`` trace of the card.

    python -m mdx_torch.tools.profile_kernels [--n 32] [--hw 512]
        [--reps 20] [--only wavelet_sigma,wavelet_none,clahe,unsharp,
        bilateral]

On the bench batch (``mdx_torch.tools.make_batch``) it runs each case
``--reps`` times after a warm-up and prints, per case:

* host ms per call: the host clock around ``--reps`` calls that are not
  synchronised (the wrappers' own host work; the queue never fills at
  these counts), and CUDA-event ms per call;
* each launch of a ``__global__`` function of ``mdx_torch/csrc`` in one
  call, in launch order, with its mean device time over the reps; the
  call's other device operations (PyTorch's kernels, memsets, copies)
  summed by kind;
* one JSON line per case with the same numbers and the card's ``name,
  power.limit``.

Cases: ``wavelet_sigma`` — ``kernels.wavelet_denoise`` with the MAD sigma
given, soft, default levels; ``wavelet_none`` — the same with
``sigma=None`` (the wrapper estimates sigma from the kernel's finest HH);
``clahe`` — ``kernels.clahe`` at clip 0.02, tile 16; ``unsharp`` —
``kernels.unsharp`` at the bench radius 1.0 and amount 0.6 (the taps'
PyTorch launches are the call's other device operations); ``bilateral`` —
``kernels.bilateral`` at d = 5, both sigmas 0.05.

It imports only what every tree of the port has had since the wavelet
kernel, so it also profiles an older checkout: copy it into that
checkout's ``mdx_torch/tools/`` and run it there (see ``time_kernels``).
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CASES = ("wavelet_sigma", "wavelet_none", "clahe", "unsharp", "bilateral")
_DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def _our_kernels() -> set[str]:
    pattern = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
               r"(\w+)\s*[(<]")
    names = set()
    for src in (ROOT / "mdx_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(pattern, src.read_text()))
    return names


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and argument
    list, with its template arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()[:80]


def _case_fn(case: str, x: torch.Tensor):
    from mdx_torch import kernels
    from mdx_torch.ops import wavelet as W

    n = x.shape[0]
    full = lambda v: torch.full((n,), v, device=x.device)  # noqa: E731
    if case == "clahe":
        clip = full(0.02)
        return lambda: kernels.clahe(x, clip, 16)
    if case == "unsharp":
        rad, amt = full(1.0), full(0.6)
        return lambda: kernels.unsharp(x, rad, amt)
    if case == "bilateral":
        sc = full(0.05)
        return lambda: kernels.bilateral(x, 5, sc, sc)
    soft = torch.ones(n, dtype=torch.bool, device=x.device)
    levels = W.default_levels(x.shape[-2:])
    sigma = (W.mad_sigma_from_hh(W.dwt2(x, "db1")[1][2]).contiguous()
             if case == "wavelet_sigma" else None)
    return lambda: kernels.wavelet_denoise(x, sigma, soft, levels)


def profile_case(fn, reps: int) -> dict:
    """Host and event ms per call, and the device operations of one call
    (name, category, mean device us over ``reps`` calls, ours or torch)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    ops = sorted((e["ts"], e["dur"], e["name"], e["cat"]) for e in events
                 if e.get("cat") in _DEVICE_CATS and "dur" in e)
    if len(ops) % reps:
        raise RuntimeError(f"{len(ops)} device operations over {reps} calls")
    per = len(ops) // reps
    ours = _our_kernels()
    mine, other = [], {}
    for i in range(per):
        us = sum(ops[r * per + i][1] for r in range(reps)) / reps
        _, _, name, cat = ops[i]
        short = _short(name)
        if cat == "kernel" and short.split("<")[0] in ours:
            mine.append({"name": short, "device_us": us, "order": i})
        else:
            key = "sort" if "Sort" in name else cat
            count, total = other.get(key, (0, 0.0))
            other[key] = (count + 1, total + us)
    device_us = sum(op["device_us"] for op in mine) + sum(
        t for _, t in other.values())
    return {"host_ms": host_ms, "event_ms": event_ms,
            "device_ms": device_us / 1e3, "device_ops": per,
            "ours": mine, "torch": {k: {"count": c, "device_us": t}
                                    for k, (c, t) in other.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--hw", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA card")
    from mdx_torch.tools import card_line, make_batch

    card = card_line()
    x = torch.from_numpy(make_batch(args.n, args.hw)).cuda()
    shape = [args.n, args.hw, args.hw]
    for case in args.only.split(","):
        res = profile_case(_case_fn(case, x), args.reps)
        print(f"{case} {shape} on {card}: host {res['host_ms']:.4f} ms a "
              f"call, events {res['event_ms']:.4f} ms, device "
              f"{res['device_ms']:.4f} ms in {res['device_ops']} device "
              f"operations ({len(res['ours'])} launches of ours)")
        for op in res["ours"]:
            print(f"  {op['device_us']:9.2f} us  #{op['order']:<3d} "
                  f"{op['name']}")
        for key, v in res["torch"].items():
            print(f"  {v['device_us']:9.2f} us  torch {key} x {v['count']}")
        print(json.dumps({"case": case, "shape": shape, "card": card,
                          **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
