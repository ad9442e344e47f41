"""Entry kind ``batch_ranks``: ``run_pipeline_batch`` on one directory of
the pool a call, the directories in turn, on a data axis of one rank a
chip (``n_data = cell.chips``), as the CLI's ``--batch`` runs on a node of
several cards.

The pool, the answers and the reference are the ``batch`` entry's.  Each
call's ``phase_ms`` holds what the program reports of its ranks under
``res["launch"]``, per frame where the metric says so; a number the
program does not report is left out, so a reader finds nothing there:

* ``ranks.starts_per_call`` — rank processes the call started (a launch
  record without a count of its own, a one-shot launch, started
  ``n_data``);
* ``runner.parent_ms_per_frame`` — the call's wall on this clock less
  the ranks' part (their start, rank 0's share in the calling process, the
  wait on the others), per frame;
* ``ranks.decode_ms_per_frame``, ``ranks.qa_ms_per_frame`` — the slowest
  rank's staging, and chunk loop, per frame of its share;
* ``ranks.idle_share`` — 100 × (1 − the ranks' mean chunk loop / the
  call's wall), the least the cards' idle share can be;
* ``ranks.peak_bytes`` — the largest rank's ``max_memory_allocated``.

Under ``--trace 1`` the profiler sees this process alone: rank 0's
kernels on its card, not the other ranks'.
"""

from __future__ import annotations

import importlib.util
import os
import time
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "mdxbench_entries_batch_base", Path(__file__).with_name("batch.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)

pool, targets, warmup = _base.pool, _base.targets, _base.warmup
extra, answer, reference = _base.extra, _base.answer, _base.reference

# (module, attribute, span) wrapped in a traced run: what this process
# does of a call
SPANS = (
    ("mdx_torch.pipeline.batch_runner", "_collect_inputs_raw", "decode"),
    ("mdx_torch.pipeline.batch_runner", "_collect", "collect"),
    ("mdx_torch.pipeline.storage", "save_runs_bulk", "db"),
)
SYNCED = frozenset()


def phases(launch: dict | None, ms: float, frames: int) -> dict | None:
    """A call's ``phase_ms`` from its launch record and its wall ``ms``."""
    if not launch or not frames:
        return None
    out = {"ranks.starts_per_call": float(launch.get("starts",
                                                     launch["n_data"]))}
    wait = launch.get("wait_ms", launch.get("wall_ms"))
    if wait is not None:
        wait += launch.get("local_ms", 0.0) + launch.get("start_ms", 0.0)
        out["runner.parent_ms_per_frame"] = (ms - wait) / frames
    n = launch.get("rank_frames")
    if n is None:
        return out
    for key, name in (("rank_stage_ms", "ranks.decode_ms_per_frame"),
                      ("rank_qa_ms", "ranks.qa_ms_per_frame")):
        per = [v / f for v, f in zip(launch.get(key, ()), n) if f]
        if per:
            out[name] = max(per)
    qa = launch.get("rank_qa_ms")
    if qa:
        out["ranks.idle_share"] = 100.0 * (1.0 - sum(qa) / len(qa) / ms)
    peak = launch.get("rank_peak_bytes")
    if peak:
        out["ranks.peak_bytes"] = float(max(peak))
    return out


def call(cell, target: str, out_dir: str, dev):
    """([(file, the program's raw answer)], frames, phase_ms)."""
    from mdx_torch.pipeline.batch_runner import run_pipeline_batch

    t0 = time.perf_counter()
    res = run_pipeline_batch(target, out_dir, save_artifacts=True,
                             window=cell.windowed, device=dev,
                             n_data=cell.chips)
    ms = (time.perf_counter() - t0) * 1e3
    frames = len(res["frames"])
    return ([(os.path.join(target, rec["source"]), rec)
             for rec in res["frames"]], frames,
            phases(res.get("launch"), ms, frames))
