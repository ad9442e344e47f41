"""BASELINE config 1 on the card: the latency of the port's CLI run.

    python -m mdx_torch.tools.cli_latency [--size 512] [--reps 5] [--procs 3]
                                          [--frames 64] [--device cuda]
    python -m mdx_torch.tools.cli_latency --spatial [--size 2048] [--reps 2]

Run from the root of a checkout (a parent checkout too: it calls only
``python -m mdx_torch``, ``run_pipeline`` and ``run_pipeline_batch``).
Writes its inputs with the port's writer into a temporary directory, with
``MDX_DB_PATH`` there too:

* process latency: ``python -m mdx_torch --input x.dcm --output out
  --no-show`` as a subprocess (interpreter start, imports, card start-up,
  the kernels' library load, the run), ``--procs`` runs, each timed on the
  host clock to its exit;
* warm in-process ``run_pipeline`` on the same file: the median of
  ``--reps`` runs after one warm-up, with the median of each phase the run
  logs (decode, normalize, device_qa — the QA step until its results are
  on the host —, png, report, db);
* frames/s of ``run_pipeline_batch`` on a ``--frames``-frame 12-bit series
  (slope 1, intercept -1024), raw upload and ``--autotune``, one warm-up
  each, median of 3.

The slice is ``write_synthetic_dicom(kind="noisy")`` at ``--size`` (a
16-bit CT-like slice with noise: the denoise, box stats and validation
path).  Prints one JSON object with the card's ``name, power.limit``.
``--device cpu`` runs a tiny check on the CPU; its times are CPU times.

``--spatial`` times ``python -m mdx_torch --input x.dcm --spatial``
(``main``, in process) instead: ``--reps`` runs each, deterministic and
``--autotune``, of a ``--size``² ``low_contrast`` slice (it clips at both
ends once normalised: denoise and CLAHE), each run one launch of ranks over
the visible cards, split by the runner's phases (decode, normalize, launch
— the launch until its results are on the host, rank start-up included —,
compute — rank 0's device work —, report, db) and rank 0's stages
(detect, the chain or the sweep and its final call, ms per candidate).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("decode", "normalize", "device_qa", "png", "report", "db")


def process_ms(path: str, out_dir: str, env: dict | None = None) -> float:
    """Wall ms of one ``python -m mdx_torch`` run on ``path`` (rc 0
    required)."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mdx_torch", "--input", path,
                        "--output", out_dir, "--no-show"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    if r.returncode != 0 or not r.stdout.startswith("# "):
        raise RuntimeError(f"python -m mdx_torch exited {r.returncode}: "
                           f"{r.stdout[-500:]} {r.stderr[-2000:]}")
    return ms


def warm_runs(path: str, out_dir: str, reps: int, device, autotune=False
              ) -> dict:
    """One warm-up, then ``reps`` runs of ``run_pipeline``: the median wall
    ms of a run and of each phase, and every run's wall."""
    from mdx_torch.pipeline.runner import run_pipeline

    run_pipeline(path, out_dir, device=device, autotune=autotune)
    walls, phases = [], {p: [] for p in PHASES}
    for _ in range(reps):
        t0 = time.perf_counter()
        ctx = run_pipeline(path, out_dir, device=device, autotune=autotune)
        walls.append((time.perf_counter() - t0) * 1e3)
        for p in PHASES:
            phases[p].append(ctx["phase_ms"][p])
    return {"median_ms": statistics.median(walls), "runs_ms": walls,
            "phases_ms": {p: statistics.median(v) for p, v in phases.items()}}


def batch_fps(path: str, out_dir: str, device, reps: int = 3, **kw) -> dict:
    """Frames/s of ``run_pipeline_batch`` (one warm-up, median of
    ``reps``; every run writes its rows)."""
    from mdx_torch.pipeline.batch_runner import run_pipeline_batch

    n = len(run_pipeline_batch(path, out_dir, device=device, **kw)["frames"])
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_pipeline_batch(path, out_dir, device=device, **kw)
        walls.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(walls)
    return {"frames": n, "median_ms": med, "runs_ms": walls,
            "frames_per_s": n / med * 1e3}


def traced_batch(path: str, out_dir: str, device, trace: Path, **kw
                 ) -> dict:
    """One ``run_pipeline_batch`` under torch.profiler (after a warm-up):
    wall, device busy and idle share, host-to-device uploads, and the
    device-to-host copies of the packed results: how many ran on a stream
    of their own and how many of those overlapped a kernel of the next
    chunk in time (the double buffer at work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdx_torch.pipeline.batch_runner import run_pipeline_batch

    run_pipeline_batch(path, out_dir, device=device, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pipeline_batch(path, out_dir, device=device, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return trace_summary(prof, trace, wall_us)


def trace_summary(prof, trace: Path, wall_us: float) -> dict:
    """A finished ``torch.profiler`` run (written to ``trace``) → device
    busy ms and idle share of ``wall_us``, kernels, the host-to-device
    uploads and the device-to-host copies: how many ran on a stream other
    than the kernels' and how many of those overlapped a kernel in time."""
    trace = Path(trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())
    events = events.get("traceEvents", events)
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
                  for e in events if e.get("cat") == "kernel" and "dur" in e)
    copies = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"),
               e["name"]) for e in events
              if e.get("cat") == "gpu_memcpy" and "dur" in e]
    busy, end = 0.0, -float("inf")
    for s, e, _ in kern:
        if e > end:
            busy += e - max(s, end)
            end = e
    main_streams = {st for _, _, st in kern}

    def side(kind):
        return [c for c in copies
                if kind in c[3] and c[2] not in main_streams]

    def overlapped(cs):
        return sum(any(ks < ce and c0 < ke for ks, ke, _ in kern)
                   for c0, ce, _, _ in cs)

    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "kernels": len(kern),
            "uploads": sum("HtoD" in c[3] for c in copies),
            "side_stream_uploads": len(side("HtoD")),
            "overlapped_uploads": overlapped(side("HtoD")),
            "result_copies": sum("DtoH" in c[3] for c in copies),
            "side_stream_copies": len(side("DtoH")),
            "overlapped_copies": overlapped(side("DtoH"))}


@contextlib.contextmanager
def spatial_contexts():
    """The contexts of the ``run_pipeline_spatial`` calls made meanwhile
    (``main`` returns only its exit code), in a list."""
    from mdx_torch.pipeline import spatial_runner as SR

    real, kept = SR.run_pipeline_spatial, []

    def keep(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    SR.run_pipeline_spatial = keep
    try:
        yield kept
    finally:
        SR.run_pipeline_spatial = real


def spatial_cli(path: str, out_dir: str, device, *flags: str) -> dict:
    """One ``main(["--input", path, "--output", out_dir, "--spatial",
    *flags], device=device)``: its exit code, printed text, wall ms, and
    the run's context (None if it failed before one)."""
    from mdx_torch.__main__ import main

    buf = io.StringIO()
    with spatial_contexts() as kept, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        rc = main(["--input", path, "--output", out_dir, "--spatial",
                   *flags], device=device)
        wall = (time.perf_counter() - t0) * 1e3
    return {"rc": rc, "text": buf.getvalue(), "wall_ms": wall,
            "ctx": kept[0] if kept else None}


def spatial_times(run: dict) -> dict:
    """A :func:`spatial_cli` run's times: wall, phases, rank 0's stages,
    the launch."""
    ctx = run["ctx"]
    return {"wall_ms": run["wall_ms"], "phases_ms": ctx["phase_ms"],
            "rank_ms": ctx["rank_ms"], "launch": ctx["launch"]}


def series_file(path: str, frames: int, size: int, seed: int = 3,
                **kw) -> str:
    """A ``frames`` x ``size``^2 12-bit series, slope 1, intercept -1024."""
    from mdx_torch.io import write_synthetic_dicom

    return write_synthetic_dicom(path, kind="phantom", size=size,
                                 frames=frames, seed=seed, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spatial", action="store_true",
                    help="time the --spatial runs (module doc)")
    args = ap.parse_args(argv)

    import torch

    from mdx_torch.io import write_synthetic_dicom
    from mdx_torch.pipeline.runner import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from mdx_torch.tools import card_line

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card, name = card_line(), torch.cuda.get_device_name(0)
    else:
        card, name = "cpu", "cpu"
    if args.spatial:
        return _spatial_main(args, name, card)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MDX_DB_PATH"] = os.path.join(tmp, "runs.db")
        path = write_synthetic_dicom(os.path.join(tmp, "slice.dcm"),
                                     kind="noisy", size=args.size)
        series = series_file(os.path.join(tmp, "series.dcm"), args.frames,
                             args.size)
        out = os.path.join(tmp, "out")
        procs = ([process_ms(path, out) for _ in range(args.procs)]
                 if dev.type == "cuda" else [])
        warm = warm_runs(path, out, args.reps, dev)
        raw = batch_fps(series, out, dev)
        tuned = batch_fps(series, out, dev, autotune=True)
    print(json.dumps({
        "tool": "cli_latency", "device": name, "card": card,
        "size": args.size, "frames": args.frames,
        "process_ms": {"median": statistics.median(procs) if procs else None,
                       "runs": procs},
        "warm": warm, "series_raw": raw, "series_autotune": tuned}))
    return 0



def _spatial_main(args, name: str, card: str) -> int:
    from mdx_torch.io import write_synthetic_dicom

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MDX_DB_PATH"] = os.path.join(tmp, "runs.db")
        path = write_synthetic_dicom(os.path.join(tmp, "slice.dcm"),
                                     kind="low_contrast", size=args.size)
        out = os.path.join(tmp, "out")
        for label, flags in (("deterministic", ()),
                             ("autotune", ("--autotune",))):
            runs[label] = []
            for _ in range(args.reps):
                r = spatial_cli(path, out, args.device, *flags)
                if r["rc"] != 0:
                    raise RuntimeError(f"--spatial {label}: rc {r['rc']}: "
                                       f"{r['text'][-500:]}")
                runs[label].append(spatial_times(r))
    print(json.dumps({
        "tool": "cli_latency --spatial", "device": name, "card": card,
        "size": args.size, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
