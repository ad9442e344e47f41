"""Phase timings and an optional device trace of a pipeline run.

Counterpart of ``mdx/pipeline/profiler.py``:

* ``phase_timer`` — logs the wall time of a phase into an
  :class:`AgentTraceLogger` (and into ``times``, a dict the caller keeps);
  ``sync`` (``torch.cuda.synchronize`` on the card) runs before the clock
  stops, so device work is counted in the phase that launched it.
* ``maybe_profile`` — wraps a block in ``torch.profiler`` when
  ``MDX_PROFILE_DIR`` is set and writes a Chrome trace there.
"""

from __future__ import annotations

import contextlib
import os
import time

from mdx_torch.pipeline.trace import AgentTraceLogger


@contextlib.contextmanager
def phase_timer(trace: AgentTraceLogger | None, phase: str, sync=None,
                times: dict | None = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        wall_ms = (time.perf_counter() - t0) * 1000.0
        if trace is not None:
            trace.log_device_timing(phase, wall_ms)
        if times is not None:
            times[phase] = wall_ms


@contextlib.contextmanager
def maybe_profile(name: str):
    """torch.profiler capture gated on MDX_PROFILE_DIR (CPU and CUDA
    activities; ``<dir>/<name>.<pid>.json``)."""
    profile_dir = os.environ.get("MDX_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"{name}.{os.getpid()}.json"))
