"""Time whole sharded TV solves (kernel 12) on the card.

    python -m mdx_torch.tools.time_tv_shard [--size 2048] [--reps 5]
                                            [--layouts 1,4,2x2]

For each layout (k row blocks, or an SYxSX grid of tiles; one rank each,
NCCL with one card per rank, gloo when ranks share the card) every rank
solves TV (weight 0.05) on its block of one ``make_batch`` frame: a warm-up
solve, ``--reps`` solves timed by CUDA events (the host's halo exchanges,
all-reduces and flag reads included), then ``--reps`` more that rank 0
traces (``torch.profiler``) for the device time of the TV kernels (every
kernel whose name holds ``tv_``; the kernels the trace kept are counted
beside it).  Prints one JSON line a layout, rank 0's:
the block's shape, iterations, kernel-12 launches and host round trips a
solve, ms a solve and an iteration (events and device), and the bound of a
solve counted as kernel T's is (x read and out written once against 23
float32 operations a pixel and iteration) beside the bound of a launch an
iteration (24 bytes a pixel and iteration).  The file uses only
``tv_sp.tv_sharded`` and the launch and counter interfaces, so a copy of it
times a parent checkout too.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

HBM_BYTES_PER_S = 3.35e12    # NVIDIA H100 SXM data sheet
F32_OPS_PER_S = 67e12
OPS_PER_PIXEL_ITERATION = 23


def rank_solves(x, weight, *, mesh, reps: int = 5) -> dict:
    """On every rank: one warm-up solve, ``reps`` timed, ``reps`` more that
    rank 0 traces (the others run them untraced: every solve holds
    collectives)."""
    from mdx_torch import kernels
    from mdx_torch.parallel import comm, tv_sp

    y = torch.clamp(x, 0.0, 1.0)

    def solve():
        return tv_sp.tv_sharded(y, weight, mesh)

    _, iters = solve()
    ms, launches, trips = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        comm.barrier(mesh)
        torch.cuda.synchronize(x.device)
        kernels.reset_launches()
        t0 = mesh.host_round_trips
        start.record()
        solve()
        end.record()
        torch.cuda.synchronize(x.device)
        ms.append(start.elapsed_time(end))
        launches.append(kernels.LAUNCHES["tv_shard_step"])
        trips.append(mesh.host_round_trips - t0)
    comm.barrier(mesh)
    if mesh.rank == 0:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(x.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                solve()
            torch.cuda.synchronize(x.device)
        tv = [e for e in prof.key_averages() if "tv_" in e.key]
        dev = sum(e.device_time_total for e in tv) / reps / 1e3
        recorded = sum(e.count for e in tv)
    else:
        for _ in range(reps):
            solve()
        dev = recorded = None
    return {"shape": list(x.shape), "iters": iters, "events_ms": ms,
            "device_ms": dev, "kernels_traced": recorded,
            "launches": launches, "round_trips": trips}


def bounds(shape, iters: int) -> dict:
    """A solve's bound counted as kernel T's, and a launch an iteration's
    (ms, and which of bytes and operations bounds it)."""
    px = shape[0] * shape[1] * shape[2]
    t_bytes = 8 * px / HBM_BYTES_PER_S
    t_ops = OPS_PER_PIXEL_ITERATION * px * iters / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_per_step_ms": 24 * px * iters / HBM_BYTES_PER_S * 1e3}


def summary(r0: dict, layout: str, backend: str) -> dict:
    """Rank 0's readings of one :func:`rank_solves` run."""
    iters = int(max(r0["iters"]))
    ev = statistics.median(r0["events_ms"])
    out = {"layout": layout, "backend": backend, "shape": r0["shape"],
           "iters": iters, "launches": int(statistics.median(r0["launches"])),
           "round_trips": int(statistics.median(r0["round_trips"])),
           "events_ms": ev, "events_ms_all": [float(v) for v in
                                              r0["events_ms"]],
           "device_ms": r0["device_ms"],
           "kernels_traced": r0["kernels_traced"],
           "events_ms_iteration": ev / iters,
           "device_ms_iteration": (None if r0["device_ms"] is None
                                   else r0["device_ms"] / iters)}
    out.update(bounds(r0["shape"], iters))
    return out


def main() -> None:
    from mdx_torch.parallel import launch
    from mdx_torch.tools import card_line, make_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--layouts", type=str, default="1,4,2x2")
    a = ap.parse_args()
    x = make_batch(1, a.size, seed=4)
    card = card_line()
    for layout in a.layouts.split(","):
        n_space = (tuple(int(v) for v in layout.split("x")) if "x" in layout
                   else int(layout))
        res = launch.run(rank_solves, x, 0.05, n_space=n_space,
                         device="cuda", timeout_s=600, reps=a.reps)
        print(json.dumps(dict(summary(res.results[0], layout, res.backend),
                              card=card)), flush=True)


if __name__ == "__main__":
    main()
