"""Check and time the data axis (``mdx_torch.parallel.batch`` and
``stream``) on the card.

    python -m mdx_torch.tools.data_check [--n-data 2] [--n 63] [--size 512]
                                         [--reps 3] [--invariance]

Pads ``make_batch(n, size)`` to a multiple of ``--n-data`` and runs the
rank bodies of the three sharded entry points (``qa_deterministic``,
``qa_plan`` with the bench plan, ``detect``) in ONE launch of ``--n-data``
ranks (:func:`launch_check`): each rank's launch counters, rank 0's calls of
kernels B, U, C, T, 5 and 10 replayed against their plain versions
(``spatial_check.recorded_rank`` around ``launch.call_each``), then
``--reps`` calls of each body timed between barriers; and the same bodies
in this process on one card (:func:`local_check`).  Prints one JSON line:
img/s of each at one rank and at ``--n-data`` (the padded images over the
slowest rank's median call), the launch wall, each rank's compute, whether
the two agree bit for bit, launches per rank and the replay.  Ranks that
share one card run over gloo: that measures contention, not scaling.
``chip_smoke.py`` phase 14 runs these functions and the stream's
(:func:`stream_qa`, :func:`decode_all_qa`, :func:`traced_stream`).

``--invariance`` instead runs the padded batch whole and as its two halves
in this process and prints, op by op, how far the halves' results are from
the whole's (:func:`invariance`): what makes n_data = 2 differ from
n_data = 1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from mdx_torch.parallel import batch as B
from mdx_torch.parallel import comm, launch
from mdx_torch.parallel.launch import Block

# (rank body, takes the plan)
BODIES = {"qa_deterministic": (B.deterministic_block, False),
          "qa_plan": (B.plan_block, True),
          "detect": (B.detect_block, False)}


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _times(xb, static, dyn, mesh, reps: int) -> dict:
    """ms of ``reps`` calls of each body on ``xb``, each call between
    barriers when there are several ranks."""
    out = {}
    for name, (fn, plan) in BODIES.items():
        args = (static, dyn) if plan else ()
        times = []
        for _ in range(reps):
            if mesh is not None:
                comm.barrier(mesh)
            _sync(xb)
            t0 = time.perf_counter()
            fn(xb, *args, mesh=mesh)
            _sync(xb)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    return out


def rank_check(xb: torch.Tensor, static, dyn, *, mesh, reps: int = 3
               ) -> dict:
    """Per-rank body of :func:`launch_check`: the three bodies once,
    recorded (module doc), then timed → {body: its fields, "smoke": the
    counters and rank 0's replay, "ms": {body: [ms]}}."""
    from mdx_torch.tools import spatial_check as SC

    calls = [(fn, (Block(0), static, dyn) if plan else (Block(0),), {})
             for fn, plan in BODIES.values()]
    res = SC.recorded_rank(xb, inner=launch.call_each, mesh=mesh,
                           recorded=SC.DENSE_RECORDED, calls=calls)
    out = dict(zip(BODIES, res["results"]), smoke=res["smoke"])
    out["ms"] = _times(xb, static, dyn, mesh, reps)
    return out


def launch_check(xp: np.ndarray, static, dyn, n_data: int, reps: int,
                 device: str = "cuda") -> dict:
    """:func:`rank_check` on ``n_data`` ranks in one launch → {"outs":
    {body: its fields over xp's images}, "smoke" and "ms": per rank,
    "info": the launch's, "wall_ms"}."""
    t0 = time.perf_counter()
    launched = launch.run(rank_check, xp, static, dyn, n_space=1,
                          n_data=n_data, device=device, reps=reps)
    wall = (time.perf_counter() - t0) * 1e3
    res = launched.results
    smoke = [r.pop("smoke") for r in res]
    ms = [r.pop("ms") for r in res]
    outs = {name: launch.assemble([r[name] for r in res], n_data, 1,
                                  block_keys=()) for name in BODIES}
    return {"outs": outs, "smoke": smoke, "ms": ms, "info": launched.info(),
            "wall_ms": wall}


def local_check(xp: np.ndarray, static, dyn, reps: int, dev) -> dict:
    """The three bodies in this process on ``dev`` → {"outs": {body: its
    fields}, "ms": {body: [ms]}}."""
    x = torch.from_numpy(xp).to(dev)
    outs = {name: launch.to_numpy(fn(x, *((static, dyn) if plan else ()),
                                     mesh=None))
            for name, (fn, plan) in BODIES.items()}
    return {"outs": outs, "ms": _times(x, static, dyn, None, reps)}


def agreement(one: dict, many: dict, n: int, hw: int) -> dict:
    """Per body: equal bit for bit on the first ``n`` images, the largest
    float difference and the ``parity.breaches`` lines of ``many`` against
    ``one`` (``rank_ms`` left out)."""
    from mdx_torch import parity

    def flat(res):
        return {k: v[:n] for k, v in parity.flatten(res).items()
                if k != "rank_ms"}

    out = {}
    for name in BODIES:
        a, b = flat(one[name]), flat(many[name])
        equal = a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k], equal_nan=True) for k in a)
        diff = max((float(np.nanmax(np.abs(a[k].astype(np.float64)
                                           - b[k].astype(np.float64))))
                    for k in a if a[k].dtype != bool and a[k].size),
                   default=0.0)
        out[name] = {"equal": equal, "max_abs": diff,
                     "breaches": parity.breaches(b, a, hw=hw)}
    return out


# reductions over [N, H·W] that the metric pass makes (torch's own kernels)
REDUCTIONS = {
    "var": lambda t: torch.var(t, dim=-1, correction=0),
    "std": lambda t: torch.std(t, dim=-1, correction=0),
    "mean": lambda t: t.mean(dim=-1),
    "sum": lambda t: t.sum(dim=-1),
    "amax": lambda t: t.amax(dim=-1),
}


def invariance(x: torch.Tensor) -> dict:
    """The batch ``x`` against its two halves (the blocks of two data
    ranks): the laplace's pixels, each of ``REDUCTIONS`` over its [N, H·W],
    each ``image_stats`` field and each ``qa_deterministic`` field →
    {name: [max|Δ|, values that differ]}."""
    from mdx_torch import parity
    from mdx_torch.core import metrics as M
    from mdx_torch.core import qa
    from mdx_torch.ops import filters as F

    h = x.shape[0] // 2
    out = {}

    def cmp(prefix, fn):
        whole, a, b = (parity.flatten(fn(t)) for t in (x, x[:h], x[h:]))
        for k, v in whole.items():
            d = np.abs(v.astype(np.float64) - np.concatenate(
                [a[k], b[k]]).astype(np.float64))
            out[prefix + k] = [float(np.nanmax(d, initial=0.0)),
                               int((d > 0).sum())]

    cmp("", lambda t: {"laplace": F.laplace(t)})
    cmp("laplace ", lambda t: {k: r(F.laplace(t).reshape(len(t), -1))
                               for k, r in REDUCTIONS.items()})
    cmp("image_stats ", M.image_stats)
    cmp("qa_deterministic ", lambda t: dict(zip(
        B.DETERMINISTIC_FIELDS, qa.qa_deterministic(t))))
    return out


def img_per_s(n: int, ms_per_rank: list) -> float:
    """Images a second of ``n`` images whose ranks each took their list of
    ms: the slowest rank's median call."""
    return n / max(statistics.median(m) for m in ms_per_rank) * 1e3


def _decode(path: str) -> np.ndarray:
    from mdx_torch.io import load_dicom, normalize_image

    return normalize_image(load_dicom(path)[0])


def _qa_host(x: torch.Tensor) -> dict:
    from mdx_torch import parity
    from mdx_torch.core import qa

    return parity.flatten_result(qa.qa_deterministic(x),
                                 parity.QA_DETERMINISTIC_FIELDS)


def stream_qa(paths: list, batch_size: int, dev) -> tuple[list, float]:
    """``stream_batches`` into ``qa_deterministic``, each batch's results
    to the host → (per-batch flattened results, wall ms)."""
    from mdx_torch.parallel.stream import stream_batches

    _sync_dev(dev)
    t0 = time.perf_counter()
    got = [(s, _qa_host(t)) for s, t in stream_batches(
        paths, batch_size, device=dev)]
    return got, (time.perf_counter() - t0) * 1e3


def decode_all_qa(paths: list, batch_size: int, dev) -> tuple[list, float]:
    """Every file decoded first, then ``qa_deterministic`` on batches of
    ``batch_size`` → (per-batch flattened results, wall ms)."""
    _sync_dev(dev)
    t0 = time.perf_counter()
    x = np.stack([_decode(p) for p in paths])
    got = [(s, _qa_host(torch.from_numpy(x[s:s + batch_size]).to(dev)))
           for s in range(0, len(paths), batch_size)]
    return got, (time.perf_counter() - t0) * 1e3


def _sync_dev(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def traced_stream(paths: list, batch_size: int, dev, trace) -> dict:
    """One :func:`stream_qa` under ``torch.profiler``: wall, device busy
    and idle share, and the host-to-device uploads on a stream of their
    own that overlapped a kernel in time (``cli_latency.trace_summary``)."""
    from torch.profiler import ProfilerActivity, profile

    from mdx_torch.tools.cli_latency import trace_summary

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_qa(paths, batch_size, dev)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    return trace_summary(prof, trace, wall_us)


def main() -> None:
    from mdx_torch.tools import bench_plan, card_line, make_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-data", type=int, default=2)
    ap.add_argument("--n", type=int, default=63)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--invariance", action="store_true",
                    help="compare the padded batch with its two halves "
                         "op by op (:func:`invariance`) and stop")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xp, n_valid = B.pad_batch(make_batch(a.n, a.size), a.n_data)
    if a.invariance:
        got = invariance(torch.from_numpy(xp).to("cuda"))
        print(json.dumps({"card": card_line(), "shape": list(xp.shape),
                          "invariance": got}))
        return
    static, dyn = bench_plan("cuda")
    one = local_check(xp, static, dyn, a.reps, torch.device("cuda", 0))
    many = launch_check(xp, *bench_plan("cpu"), a.n_data, a.reps)
    print(json.dumps({
        "card": card_line(), "n_data": a.n_data, "images": len(xp),
        "valid": n_valid, "size": a.size, "info": many["info"],
        "wall_ms": many["wall_ms"],
        "img_per_s_one": {k: img_per_s(len(xp), [v])
                          for k, v in one["ms"].items()},
        "img_per_s_many": {k: img_per_s(len(xp), [m[k] for m in many["ms"]])
                           for k in BODIES},
        "rank_ms": [{k: statistics.median(v) for k, v in m.items()}
                    for m in many["ms"]],
        "agreement": {k: {"equal": v["equal"], "max_abs": v["max_abs"],
                          "breaches": len(v["breaches"])}
                      for k, v in agreement(one["outs"], many["outs"],
                                            len(xp), a.size * a.size
                                            ).items()},
        "launches": [s["launches"] for s in many["smoke"]],
        "replay": many["smoke"][0]["replay"]}))


if __name__ == "__main__":
    main()
