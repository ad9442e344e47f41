"""Async run executor: bounded thread pool with explicit run ids — the
port's copy of ``mdx/serve/executor.py``.

Replaces the reference's thread-per-run launcher
(ref backend/pipeline_runner.py:24-101) with two deliberate fixes noted in
SURVEY.md §5:

* ``run_pipeline`` takes ``run_id`` as an explicit parameter — the
  reference's process-global ``generate_run_id`` monkey-patch
  (ref backend/pipeline_runner.py:75-89) could cross-assign ids between
  two concurrent runs; that race is designed out.
* a concurrency cap (``MDX_MAX_CONCURRENT_RUNS``, default 4): the
  reference spawns an unbounded daemon thread per request; here runs queue
  beyond the cap.

Each job carries its device (``start_run(..., device=...)``); a worker
calls :func:`mdx_torch.pipeline.runner.run_pipeline` on it, so up to four
passes run on the card at once, one per worker thread (the kernel library
loads once and the launch counts stay exact across threads:
:mod:`mdx_torch.kernels`).  The port's PNG writer needs no matplotlib, so
nothing here selects a backend.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Optional

from mdx_torch.pipeline import storage

logger = logging.getLogger(__name__)

_MAX_WORKERS = int(os.environ.get("MDX_MAX_CONCURRENT_RUNS", "4"))

_queue: "queue.Queue[tuple]" = queue.Queue()
_workers_started = False
_lock = threading.Lock()


def _ensure_workers() -> None:
    global _workers_started
    with _lock:
        if _workers_started:
            return
        for i in range(_MAX_WORKERS):
            t = threading.Thread(target=_worker_loop, daemon=True,
                                 name=f"mdx-torch-run-worker-{i}")
            t.start()
        _workers_started = True


def _worker_loop() -> None:
    while True:
        job = _queue.get()
        try:
            _execute(*job)
        finally:
            _queue.task_done()


def _execute(run_id: str, file_path: str, output_dir: str, genai: bool,
             model: Optional[str], max_iters: int, autotune: bool,
             device) -> None:
    from mdx_torch.pipeline.runner import run_pipeline

    try:
        storage.update_run_status(run_id, "running")
        logger.info("Run %s started (genai=%s model=%s autotune=%s "
                    "device=%s)", run_id, genai, model, autotune, device)
        run_pipeline(
            input_path=file_path, output_dir=output_dir, genai=genai,
            model=model, max_iters=max_iters, save_artifacts=True,
            no_show=True, run_id=run_id, autotune=autotune, device=device)
        storage.update_run_status(run_id, "completed")
        logger.info("Run %s completed.", run_id)
    except Exception as exc:
        logger.exception("Run %s failed: %s", run_id, exc)
        storage.update_run_status(run_id, "error", error=str(exc))


def start_run(
    file_path: str,
    *,
    genai: bool = False,
    model: str | None = None,
    max_iters: int | None = None,
    output_dir: str | None = None,
    autotune: bool = False,
    device="cuda",
) -> str:
    """Enqueue a pipeline run on ``device``; returns its run_id
    immediately."""
    from mdx_torch.serve import config

    storage.init_db()
    run_id = storage.generate_run_id()
    storage.insert_pending_run(run_id, os.path.basename(file_path))

    _ensure_workers()
    _queue.put((
        run_id, file_path, output_dir or config.OUTPUT_DIR, genai,
        model or config.OPENAI_MODEL,
        max_iters if max_iters is not None else config.MAX_ITERS,
        autotune, device))
    return run_id


def get_run_status(run_id: str) -> str:
    data = storage.get_run(run_id)
    if data is None:
        return "not_found"
    return data.get("status", "unknown")
