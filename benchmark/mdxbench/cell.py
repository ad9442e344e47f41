"""One run of a cell on a device: set-up, the window, the check, the
result.  :mod:`run` adds the look for a card; tests call :func:`run` on
the CPU at a small configuration."""

from __future__ import annotations

import time
from contextlib import nullcontext
from pathlib import Path

import torch

from mdxbench import check, drive, guard, spec, tracing


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _quarters(runs: list, marks: list) -> str:
    """Between each two marks of the window (about a quarter): frames a
    second, the median ms of the calls that ended there, the process's CPU
    cores and CPU ms a frame.  Whether a run drifts within itself, and
    whether the host did the same work at another speed."""
    out = []
    for (ta, ca), (tb, cb) in zip(marks, marks[1:]):
        rs = [r for r in runs if ta < r["end"] <= tb]
        ms = sorted(r["ms"] for r in rs)
        frames = sum(r["frames"] for r in rs)
        if ms and frames:
            out.append(f"{frames / (tb - ta):.1f}/s {ms[len(ms) // 2]:.1f} "
                       f"ms {(cb - ca) / (tb - ta):.2f} cores "
                       f"{1e3 * (cb - ca) / frames:.1f} CPU ms a frame")
    return "; ".join(out)


def run(cell, seed: int, seconds: float, trace: bool, dev, root: str,
        t0: float, marks=None) -> tuple[dict | None, list[str]]:
    """(the result, lines for standard error); the result is None when
    the run may print none, with the reason as the last line.  ``t0``:
    the process's start on ``time.perf_counter``; ``marks``: (stage, its
    end) of set-up so far."""
    import mdx_torch.pipeline.batch_runner  # noqa: F401  (the program)

    cuda = dev.type == "cuda"
    marks = list(marks or []) + [("program", time.perf_counter())]
    client = drive.Client(cell, root, seed, dev)
    marks.append(("inputs", time.perf_counter()))
    client.warmup()
    marks.append(("warm-up", time.perf_counter()))

    reading = tracing.Reading()
    rec = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        rec = tracing.Recorder()
        for module, attr, name in client.entry.SPANS:
            rec.span(module, attr, name,
                     sync=cuda and name in client.entry.SYNCED)
        if cuda:
            rec.kernels()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.start()
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reading.setup_s = time.perf_counter() - t0

    def span(name):
        return torch.profiler.record_function(tracing.PREFIX + name)

    with span("window") if trace else nullcontext():
        reading.host_window_s = client.window(seconds,
                                              span if trace else None)
    _sync(dev)
    if cuda:
        reading.peak_bytes = torch.cuda.max_memory_allocated(dev)
    reading.frames, reading.runs = client.frames, client.runs
    if trace:
        prof.stop()
        rec.restore()
        import mdx_torch

        csrc = Path(mdx_torch.__file__).resolve().parent / "csrc"
        t_red = time.perf_counter()
        tracing.reduce(prof, rec, tracing.hand_kernel_names(csrc), reading)
        del prof
        t_red = time.perf_counter() - t_red
    found = guard.loaded()
    if found:
        return None, [f"forbidden modules loaded after the window: {found}"]

    # the check: after the peak is read, on the program's freed state
    sample = client.sample()
    prog = client.answers(sample)
    if cuda:
        torch.cuda.empty_cache()
    ref = client.entry.reference(cell, sample, dev) if sample else []
    # no answer at all counts as a wrong one
    readings, left_out, worst = (check.compare(prog, ref) if ref
                                 else ({"mismatch": 1}, 0, "none"))
    ok, checks = check.verdict(readings)
    if client.failed:
        ok = False
        checks["failed_calls"] = [client.failed, 0]

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": reading.peak_bytes}
    if trace:
        device.update(busy_s=reading.busy_s, window_s=reading.window_s)
    result = {"correct": ok, "attempted": len(client.runs),
              "failed": client.failed, "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = tracing.breakdown(reading)
    result["checks"] = checks
    notes = [f"call failed: {e}" for e in client.errors[:5]]
    last, setup = t0, []
    for name, t in marks:
        setup.append(f"{name} {t - last:.2f} s")
        last = t
    notes.append("set-up: " + ", ".join(setup))
    phases = {}
    for r in client.runs:
        for k, v in (r["phase_ms"] or {}).items():
            phases.setdefault(k, []).append(v)
    if phases:
        notes.append("median phase ms: " + ", ".join(
            f"{k} {sorted(v)[len(v) // 2]:.2f}" for k, v in phases.items()))
    notes.append("by quarter of the window: " + _quarters(client.runs,
                                                          client.marks))
    if trace:
        notes.append(f"trace read in {t_red:.1f} s; device events by kind "
                     f"{reading.kinds}; hand-kernel calls "
                     f"{reading.kernel_calls}")
    notes.append(f"sample {len(sample)} answers, {left_out} left out "
                 f"(within {check.MARGIN} of a threshold); widest gap "
                 f"{worst}")
    notes += [f"check {k}: {v} (limit {lim})" for k, (v, lim)
              in checks.items()]
    return result, notes
