"""Check and time the spatially-sharded QA path on the card.

    python -m mdx_torch.tools.spatial_check [--n-space 4 | --layout 2x2]
                                            [--size 2048] [--trace]

Runs :func:`rank_check` on ``--n-space`` row blocks or a ``--layout SYxSX``
grid of tiles, one rank each (the backend rule of
``mdx_torch.parallel.mesh``: NCCL with one card per rank, gloo when they
share one) on one ``make_batch`` frame and prints one JSON line: per-call
ms of ``qa_plan_spatial`` (median of synchronised reps inside the ranks,
spawn excluded), the backend, host round trips per call, kernel launches
and the replay errors of the recorded kernels; with ``--trace`` also rank
0's device time, idle share and top kernels of one traced call.
``chip_smoke.py`` phases 9 (row blocks) and 10 (tiles) run the same rank
function.

:func:`rank_check` runs on every rank: the bench plan's ``qa_plan_block``
with the launch counters reset and, on rank 0, every call of kernels 11
and 12 and of kernel C's LUT stage (the local LUTs) recorded;
``qa_block`` (the issue-driven chain with denoise, CLAHE, TV and the noise
guard); each recorded call replayed against the plain version (kernel 12:
its blocked launches and its rebuild); the whole sharded TV solve through
the kernels and through ``tv_sharded_plain`` on the same block, with the
kernel solve's schedule (iterations a launch, launches, flag reads, host
round trips) and, on the card, its times
(``mdx_torch.tools.time_tv_shard.rank_solves``); then the timed reps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

SPATIAL_KERNELS = ("clahe_remap_ext", "tv_shard_step")
# the wrappers rank 0 records and replays: kernels 11 and 12 (its blocked
# launches and its rebuild, counted and held to their tolerance as
# "tv_shard_step"), and kernel C's LUT stage, which builds the sharded
# CLAHE's local LUTs and is counted and held to its tolerance as "clahe"
# (ROW_OF)
RECORDED = ("clahe_luts",) + SPATIAL_KERNELS + ("tv_shard_rebuild",)
ROW_OF = {"clahe_luts": "clahe", "tv_shard_rebuild": "tv_shard_step"}
# the dense path's kernels (B, U, C, T, 5, 10), which the data axis runs in
# every rank
DENSE_RECORDED = ("box_stats", "unsharp", "clahe", "tv_chambolle",
                  "bilateral", "wavelet_denoise")
# qa_spatial's chain in the check: denoise, CLAHE, gamma/unsharp, TV and the
# noise guard (bilateral off)
QA_KW = dict(gamma=0.95, unsharp_radius=1.0, unsharp_amount=0.6,
             bilateral_d=0, clahe_clip=0.02, clahe_tile=16, tv_weight=0.05,
             use_tv=True, use_denoise=True, use_noise_guard=True)


def plain_of(name: str):
    from mdx_torch.core.metrics import _lv_box_stats_plain
    from mdx_torch.ops.bilateral import bilateral_plain
    from mdx_torch.ops.clahe import clahe_luts_plain, clahe_plain
    from mdx_torch.ops.filters import unsharp_mask_plain
    from mdx_torch.ops.tv import tv_chambolle_plain
    from mdx_torch.ops.wavelet import denoise_wavelet_plain
    from mdx_torch.parallel import clahe_sp, tv_sp

    def wavelet_plain(x, sigma, soft, levels):
        return denoise_wavelet_plain(x, sigma, wavelet_levels=levels,
                                     soft_mask=soft)

    return {"clahe_luts": clahe_luts_plain,
            "clahe_remap_ext": clahe_sp.remap_ext_plain,
            "tv_shard_step": tv_sp.tv_shard_step_plain,
            "tv_shard_rebuild": tv_sp.tv_shard_rebuild_plain,
            "box_stats": _lv_box_stats_plain, "unsharp": unsharp_mask_plain,
            "clahe": clahe_plain, "tv_chambolle": tv_chambolle_plain,
            "bilateral": bilateral_plain,
            "wavelet_denoise": wavelet_plain}[name]


def _clone(args):
    """Copies of the tensors among ``args``, in tuples (slab sets) too."""
    return tuple(a.clone() if torch.is_tensor(a)
                 else _clone(a) if isinstance(a, tuple) else a for a in args)


def compare_call(name: str, args) -> tuple[float, bool]:
    """One recorded wrapper's call against its plain version on copies of
    the same inputs → (max|d|, within ``parity.KERNEL_TOL`` of its row).
    For kernel 12's step the outputs are the written ``p_out`` and the
    returned sums, for its rebuild the returned image; kernel T's
    iteration counts must be equal."""
    from mdx_torch import kernels, parity

    ka, pa = _clone(args), _clone(args)
    got = getattr(kernels, name)(*ka)
    want = plain_of(name)(*pa)
    if name == "tv_shard_step":
        got, want = (ka[2], got), (pa[2], want)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    err, ok = parity.kernel_parity(ROW_OF.get(name, name), got, want)
    if name == "tv_chambolle":
        ok = ok and torch.equal(got[1].cpu(), want[1].cpu())
    return err, ok


@contextlib.contextmanager
def recording(calls: list, enabled: bool, names=RECORDED):
    """Record (name, cloned args) of every call of the wrappers ``names``
    while they run as usual."""
    from mdx_torch import kernels

    originals = {k: getattr(kernels, k) for k in names}

    def recorder(name, fn):
        def call(*args):
            calls.append((name, _clone(args)))
            return fn(*args)
        return call

    if enabled:
        for k, fn in originals.items():
            setattr(kernels, k, recorder(k, fn))
    try:
        yield
    finally:
        for k, fn in originals.items():
            setattr(kernels, k, fn)


def replay(calls: list, names=RECORDED) -> dict:
    """Recorded calls → {wrapper: [calls, max|d| against the plain
    version, all within tolerance]}, one entry per wrapper of ``names``."""
    out = {k: [0, 0.0, True] for k in names}
    for name, args in calls:
        err, ok = compare_call(name, args)
        r = out[name]
        r[0], r[1], r[2] = r[0] + 1, max(r[1], err), r[2] and ok
    return out


def recorded_rank(*blocks, inner, mesh, recorded=RECORDED,
                  **kwargs) -> dict:
    """A rank function around the rank function ``inner``: this rank's
    launch counters reset first and read after ``inner``, and on rank 0
    every call of the wrappers ``recorded`` recorded and, once ``inner``
    returned, replayed against its plain version.  The result is
    ``inner``'s dict (a list, ``launch.call_each``'s, under ``"results"``)
    with ``"smoke"``: {"launches": {kernel: n}, "replay": :func:`replay`'s}.
    ``chip_smoke.py`` wraps a user entry point's launch in it."""
    from mdx_torch import kernels

    calls: list = []
    kernels.reset_launches()
    with recording(calls, mesh.rank == 0, recorded):
        out = inner(*blocks, mesh=mesh, **kwargs)
    launches = dict(kernels.LAUNCHES)
    if not isinstance(out, dict):
        out = {"results": out}
    out["smoke"] = {"launches": launches, "replay": replay(calls, recorded)}
    return out


def _traced_call(fn, device) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA): the
    wall, the summed device time of its kernels, the idle share
    (1 − device / wall) and the 8 kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "idle_share": 1.0 - dev_ms / wall_ms,
            "launches": sum(e.count for e in kern),
            "top": [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


def rank_check(x, static, dyn, *, mesh, reps: int = 5,
               trace: bool = False) -> dict:
    """The per-rank check (module doc) → numpy-able dict; with ``trace``,
    one more call that rank 0 traces (:func:`_traced_call`)."""
    from mdx_torch import kernels
    from mdx_torch.parallel import comm, plan_sp, spatial, tv_sp

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    out = {}
    stage_s = {}
    t_stage = time.perf_counter()

    def stage(name):
        nonlocal t_stage
        sync()
        now = time.perf_counter()
        stage_s[name] = now - t_stage
        t_stage = now

    calls: list = []
    sync()
    kernels.reset_launches()
    trips = mesh.host_round_trips
    with recording(calls, enabled=mesh.rank == 0):
        res = plan_sp.qa_plan_block(x, static, dyn, mesh=mesh)
    sync()
    out["plan_round_trips"] = mesh.host_round_trips - trips
    out["launches_plan"] = dict(kernels.LAUNCHES)
    out.update(enhanced=res["enhanced"], flags=res["flags"],
               validation=res["validation"], score=res["score"],
               stats_before=res["stats_before"])
    stage("qa_plan recorded")

    kernels.reset_launches()
    qa = spatial.qa_block(x, mesh=mesh, **QA_KW)
    sync()
    out["launches_qa"] = dict(kernels.LAUNCHES)
    out.update(qa_enhanced=qa["enhanced"], qa_passes=qa["passes"],
               qa_noise_amp=qa["noise_amp_guard"], qa_ssim=qa["ssim"],
               qa_psnr=qa["psnr"])
    stage("qa_spatial")

    out["replay"] = replay(calls)
    del calls
    stage("replay")

    # the whole solve, kernels (on the card) against plain, on the clipped
    # block; the kernel solve's schedule and round trips, and its times
    y = torch.clamp(x, 0.0, 1.0)
    trips = mesh.host_round_trips
    a, it_a = tv_sp.tv_sharded(y, 0.05, mesh)
    sync()
    schedule = dict(tv_sp.LAST_SOLVE, round_trips=mesh.host_round_trips
                    - trips) if x.is_cuda else {}
    b, it_b = tv_sp.tv_sharded_plain(y, 0.05, mesh)
    sync()
    out["tv_solve"] = {"max_abs_err": float((a - b).abs().max()),
                       "iters_kernel": it_a, "iters_plain": it_b,
                       "schedule": schedule}
    if x.is_cuda:
        from mdx_torch.tools import time_tv_shard

        out["tv_timing"] = time_tv_shard.rank_solves(x, 0.05, mesh=mesh,
                                                     reps=3)
    stage("tv solve twice, then timed")

    times = []
    for _ in range(reps):
        comm.barrier(mesh)
        sync()
        t0 = time.perf_counter()
        plan_sp.qa_plan_block(x, static, dyn, mesh=mesh)
        sync()
        comm.barrier(mesh)
        times.append((time.perf_counter() - t0) * 1e3)
    out["plan_ms"] = times
    stage("timed reps")
    if trace:
        def call():
            plan_sp.qa_plan_block(x, static, dyn, mesh=mesh)

        if mesh.rank == 0:
            out["trace"] = _traced_call(call, x.device)
        else:
            call()
        stage("traced call")
    out["stage_s"] = stage_s
    return out


def main() -> None:
    import numpy as np

    from mdx_torch.parallel import launch
    from mdx_torch.tools import bench_plan, card_line, make_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-space", type=int, default=4)
    ap.add_argument("--layout", type=str, default=None,
                    help="a grid of tiles SYxSX (e.g. 2x2) instead of "
                         "--n-space row blocks")
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", action="store_true",
                    help="trace one more call on rank 0 (torch.profiler)")
    a = ap.parse_args()
    n_space = (tuple(int(v) for v in a.layout.lower().split("x"))
               if a.layout else a.n_space)
    x = make_batch(1, a.size, seed=4)
    t0 = time.perf_counter()
    res = launch.run(rank_check, x, *bench_plan("cpu"), n_space=n_space,
                     device="cuda", reps=a.reps, trace=a.trace)
    r0 = res.results[0]
    print(json.dumps({
        "trace": r0.get("trace"),
        "stage_s": r0["stage_s"],
        "card": card_line(), "n_space": res.n_space, "size": a.size,
        "backend": res.backend, "devices": res.devices,
        "plan_ms_median": statistics.median(r0["plan_ms"]),
        "plan_ms": [float(v) for v in r0["plan_ms"]],
        "host_round_trips_per_call": int(r0["plan_round_trips"]),
        "launches_plan": [r["launches_plan"] for r in res.results],
        "replay": r0["replay"],
        "tv_solve_max_abs_err": max(r["tv_solve"]["max_abs_err"]
                                    for r in res.results),
        "tv_iters_equal": all(np.array_equal(r["tv_solve"]["iters_kernel"],
                                             r["tv_solve"]["iters_plain"])
                              for r in res.results),
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
