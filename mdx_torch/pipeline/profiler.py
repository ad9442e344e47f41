"""Phase timings of a pipeline run, and its spans and counters for the
operator.

Counterpart of ``mdx/pipeline/profiler.py``; the spans and counters
themselves are :mod:`mdx_torch.telemetry`:

* ``phase_timer`` — logs the wall time of a phase into an
  :class:`AgentTraceLogger` (and into ``times``, a dict the caller keeps)
  and records it as a span of the phase's name; ``sync``
  (``torch.cuda.synchronize`` on the card) runs before the clock stops, so
  device work is counted in the phase that launched it.
* ``traced_run`` — the top-level span of a run (``run``, ``batch``).  With
  ``MDX_PROFILE_DIR`` set it turns tracing on for the run and writes the
  run's spans and counters to ``<dir>/<name>.<pid>.json`` as a Chrome
  trace on the epoch clock (:func:`mdx_torch.telemetry.chrome_trace`).
  Runs in several threads at once each write a file; each file holds
  every span recorded while its run was open, theirs included.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from mdx_torch import telemetry
from mdx_torch.pipeline.trace import AgentTraceLogger


@contextlib.contextmanager
def phase_timer(trace: AgentTraceLogger | None, phase: str, sync=None,
                times: dict | None = None):
    t0 = time.perf_counter()
    with telemetry.span(phase):
        try:
            yield
        finally:
            if sync is not None:
                with telemetry.count_sync("phase.sync"):
                    sync()
            wall_ms = (time.perf_counter() - t0) * 1000.0
            if trace is not None:
                trace.log_device_timing(phase, wall_ms)
            if times is not None:
                times[phase] = wall_ms


@contextlib.contextmanager
def traced_run(span_name: str, name: str):
    """A run's top-level span ``span_name``; written to
    ``<MDX_PROFILE_DIR>/<name>.<pid>.json`` when that is set."""
    profile_dir = os.environ.get("MDX_PROFILE_DIR")
    if not profile_dir:
        with telemetry.span(span_name):
            yield
        return
    telemetry.enable()
    try:
        since = telemetry.mark()
        with telemetry.span(span_name):
            yield
        snap = telemetry.snapshot(since)
    finally:
        telemetry.disable()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}.{os.getpid()}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(telemetry.chrome_trace(snap), f)
