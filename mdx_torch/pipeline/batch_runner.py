"""Batch / series runner: QA every frame of a series or directory on the
card, or on every visible card.

Counterpart of ``mdx/pipeline/batch_runner.py``:

* a multi-frame DICOM becomes an ``[F, H, W]`` stack, a directory of DICOMs
  (decoded on 8 host threads) one frame per file;
* frames are bucketed by shape (and stored dtype) and run in chunks of
  ``ceil(64 / d)·d`` frames on a data axis of ``d`` ranks (JAX's
  ``chunk_n``);
* the deterministic path uploads the stored integers from pinned memory
  and normalises them on the card (``normalize_ingest``) before
  ``qa_deterministic``; the autotune path sweeps the candidate grid per
  frame from host-normalised frames;
* a chunk's results are packed on the card into one ``[28, n]`` float32
  array (18 metrics, 5 issue masks, SSIM, PSNR, quality improvement, pass,
  score) that comes to pinned host memory on a side stream, so chunk t's
  copy and row writing overlap chunk t+1's upload and launches;
* each frame gets a DB row keyed ``label#frameN``, so ``resume=True``
  skips the frames a crashed batch (of either package) already finished.

With ``d > 1`` (``n_data``; by default every visible card, as JAX's
``make_mesh()``) the deterministic paths run in ONE ``launch.run`` of ``d``
ranks for the whole run, whatever the number of chunks and buckets: each
chunk is padded to a multiple of ``d`` (its last frame and that frame's
ingest scalars replicated), each rank receives its block of every chunk of
every bucket (a bucket's frames and its ``[N, 9, 1]`` ingest scalars are
inputs of the launch) and runs the chunk loop above on it
(:func:`batch_block`); the parent writes the records, the report and the DB
rows.  The ranks exchange nothing: every op is per image.  With ``d = 1``
everything runs in this process.  ``autotune=True`` runs on one card at
every ``d``, as JAX's unsharded ``_autotune_chunk`` does.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np
import torch

from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS
from mdx_torch.io import load_dicom, load_series, normalize_image
from mdx_torch.io.dicom import load_frames_raw
from mdx_torch.parallel import launch
from mdx_torch.parallel.mesh import data_axis, divisible_batch
from mdx_torch.pipeline import storage
from mdx_torch.pipeline.runner import resolve_device

logger = logging.getLogger(__name__)

CHUNK = 64
# stored integer dtypes normalize_ingest takes (int8 widens to int16)
_INGEST_DTYPES = (np.uint8, np.int16, np.uint16)


def _dicom_names(input_path: str) -> list[str]:
    return sorted(n for n in os.listdir(input_path)
                  if os.path.splitext(n)[1].lower() in (".dcm", ".dicom"))


def _map_dir(input_path: str, load_one) -> list:
    """``load_one(path, name)`` over a directory's DICOMs on 8 host threads;
    a file that fails to load is skipped with a warning."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name: str):
        try:
            return load_one(os.path.join(input_path, name), name)
        except Exception as exc:
            logger.warning("Skipping %s: %s", name, exc)
            return None

    with ThreadPoolExecutor(max_workers=8) as pool:
        return [r for r in pool.map(one, _dicom_names(input_path))
                if r is not None]


def _collect_inputs(input_path: str, window: bool = False
                    ) -> list[tuple[str, np.ndarray, dict]]:
    """[(label, [F,H,W] stack, metadata)], decoded + normalised on the host
    (the autotune path)."""
    if os.path.isdir(input_path):
        def one(path, name):
            img, meta = load_dicom(path, window=window)
            return (name, img[None], meta)

        return _map_dir(input_path, one)
    stack, meta = load_series(input_path, window=window)
    return [(os.path.basename(input_path), stack, meta)]


def _collect_inputs_raw(input_path: str, window: bool = False
                        ) -> list[tuple[str, np.ndarray, dict | None, dict]]:
    """[(label, frames, ingest descriptor | None, metadata)] keeping the
    stored integers for normalisation on the card.  Descriptor None ⇒
    frames are host-normalised float32 (RGB or float pixel data)."""
    def one(path, name):
        frames, desc, meta = load_frames_raw(path, window=window)
        if desc is not None and frames.dtype == np.int8:
            frames = frames.astype(np.int16)
        elif desc is not None and frames.dtype not in _INGEST_DTYPES:
            # 32-bit integers: the host pipeline's float32 frames
            stack, meta = load_series(path, window=window)
            frames, desc = stack, None
        if name is not None and frames.shape[0] > 1:
            # directory entries contribute their middle frame (the
            # reference's middle-slice reduction, dicom_io.py:60-81); the
            # descriptor keeps whole-stack scalars
            frames = frames[frames.shape[0] // 2][None]
        return (name or os.path.basename(path), frames, desc, meta)

    if os.path.isdir(input_path):
        return _map_dir(input_path, one)
    return [one(input_path, None)]


def _buckets(items: list[tuple[str, np.ndarray, dict]],
             window: bool = False):
    """Group frames by (H, W).  Windowed frames are already in [0,1] with
    the diagnostic range mapped by the VOI window — min-max re-normalising
    would stretch it back."""
    by_shape: dict[tuple[int, int], list] = {}
    for label, stack, meta in items:
        for f in range(stack.shape[0]):
            frame = (np.asarray(stack[f], np.float32) if window
                     else normalize_image(stack[f]))
            by_shape.setdefault(frame.shape, []).append((label, f, frame,
                                                         meta))
    return by_shape


def _buckets_raw(items, window: bool = False):
    """Group frames by (H, W, dtype): raw integer frames keep their stored
    dtype, float32 fallbacks behave as :func:`_buckets`.  Entries: (label,
    frame_idx, frame, meta, desc)."""
    by_shape: dict[tuple[int, int, str], list] = {}
    for label, stack, desc, meta in items:
        for f in range(stack.shape[0]):
            frame = stack[f]
            if desc is None:
                frame = (np.asarray(frame, np.float32) if window
                         else normalize_image(frame))
            key = frame.shape + (str(frame.dtype),)
            by_shape.setdefault(key, []).append((label, f, frame, meta,
                                                 desc))
    return by_shape


def _completed_frames() -> set[str]:
    """``label#frameN`` keys of completed runs: the resume index."""
    try:
        return {r["input_filename"] for r in storage.list_runs(limit=100000)
                if r.get("status") == "completed"
                and "#frame" in r.get("input_filename", "")}
    except Exception:
        return set()


def _pack_outputs(out) -> torch.Tensor:
    """Everything the collection reads, as one [18 + 5 + 5, N] float32
    tensor on the run's device (row order: metrics, issue masks, SSIM,
    PSNR, quality improvement, pass, score)."""
    _enhanced, stats, issues, _flags, validation, score = out
    rows = [stats[k] for k in METRIC_KEYS]
    rows += [issues[k] for k in ISSUE_ORDER]
    rows += [validation[k]
             for k in ("ssim", "psnr", "quality_improvement", "passes")]
    rows.append(score)
    return torch.stack([r.to(torch.float32) for r in rows])


def _collect(frames, packed_np, h, w, results, save_artifacts):
    """Per-frame records + DB rows for one chunk from the packed [K, N]
    fetch (row order: :func:`_pack_outputs`)."""
    nm = len(METRIC_KEYS)
    ni = len(ISSUE_ORDER)
    db_rows = []
    for i, (label, fidx, _frame, meta, _desc) in enumerate(frames):
        col = packed_np[:, i]
        frame_issues = [k for j, k in enumerate(ISSUE_ORDER)
                        if bool(col[nm + j])]
        run_id = storage.generate_run_id()
        rec = {
            "run_id": run_id,
            "source": label,
            "frame": fidx,
            "shape": [h, w],
            "issues": frame_issues,
            "metrics": {k: float(col[j]) for j, k in enumerate(METRIC_KEYS)},
            "ssim": float(col[nm + ni]),
            "psnr": float(col[nm + ni + 1]),
            "quality_improvement": float(col[nm + ni + 2]),
            "passed": bool(col[nm + ni + 3]),
            "objective_score": float(col[nm + ni + 4]),
        }
        results.append(rec)
        if save_artifacts:
            db_rows.append({
                "run_id": run_id,
                "input_filename": f"{label}#frame{fidx}",
                "metadata_summary": meta, "issues": frame_issues,
                "metrics_before": rec["metrics"], "metrics_after": {},
                "plan_json": "", "validation": {
                    "ssim": rec["ssim"], "psnr": rec["psnr"],
                    "quality_improvement": rec["quality_improvement"],
                    "passes": rec["passed"]},
                "applied_ops": [], "explainability": {}, "report_path": "",
                "before_after_path": "", "agent_logs": [],
                "status": "completed"})
    if db_rows:
        try:
            storage.save_runs_bulk(db_rows)
        except Exception as exc:
            logger.error("Bulk persist failed for %d frames of %sx%s: %s",
                         len(db_rows), h, w, exc)


def _autotune_chunk(x: np.ndarray, dev, tv_mode):
    """Per-frame autotune for one chunk; returns the qa_deterministic-shaped
    tuple so the collection path is shared."""
    from mdx_torch.core import qa
    from mdx_torch.core.score import objective_score
    from mdx_torch.core.tuning import autotune_batch, candidate_grid
    from mdx_torch.core.validate import validate
    from mdx_torch.pipeline.agents import issue_list, to_host

    xt = torch.from_numpy(x).to(dev)
    stats, issue_masks = qa.detect(xt)
    host = to_host(issue_masks)
    issues_per_image = [issue_list(host, i) for i in range(x.shape[0])]
    # cap the sweep's lanes (frames × candidates) per call, as JAX does
    union = sorted({i for iss in issues_per_image for i in iss})
    k_cands = max(len(candidate_grid(union)), 1)
    sub_n = max(128 // k_cands, 1)
    enhanced = np.concatenate([
        autotune_batch(x[s:s + sub_n], issues_per_image[s:s + sub_n],
                       device=dev, tv_mode=tv_mode)[1]
        for s in range(0, x.shape[0], sub_n)], axis=0)
    validation = validate(xt, torch.from_numpy(enhanced).to(dev),
                          stats_before=stats)
    score, _ = objective_score(validation)
    return enhanced, stats, issue_masks, {}, validation, score


def _device_qa(x: np.ndarray, params: np.ndarray | None, dev,
               window: bool) -> torch.Tensor:
    """One chunk's deterministic QA → its packed [28, n] results on the
    device: stored integer frames and their [9, n] ingest scalars through
    ``normalize_ingest``, or host-normalised float32 frames (``params``
    None), uploaded, then ``qa_deterministic``."""
    from mdx_torch.core import qa
    from mdx_torch.ops.ingest import normalize_ingest

    x = _upload(x, dev)
    if params is not None:
        x = normalize_ingest(x, *_upload(params, dev),
                             per_frame_minmax=not window)
    return _pack_outputs(qa.qa_deterministic(x))


def _ingest_params(descs: list[dict], window: bool) -> np.ndarray:
    """[9, N] float32 scalars for normalize_ingest from the per-file
    descriptors: slope, intercept, mono1, gmax, use_window, wlo, wden,
    nlo, nhi."""
    f32 = np.float32

    def wparams(d):
        if not window or d["window"] is None:
            return (0.0, 0.0, 1.0)
        wc, ww = d["window"]
        width = max(float(ww), 1.0 + 1e-6)
        lo = float(wc) - 0.5 - (width - 1.0) / 2.0
        return (1.0, f32(lo), f32(width - 1.0))

    def nbounds(d):
        # windowless-fallback bounds over the whole stack, in the space
        # AFTER the MONO1 inversion (z = gmax - v has bounds [0, gmax-gmin])
        if d["mono1"]:
            return (0.0, float(f32(d["gmax"]) - f32(d["gmin"])))
        return (d["gmin"], d["gmax"])

    return np.asarray([
        (d["slope"], d["intercept"], 1.0 if d["mono1"] else 0.0, d["gmax"],
         *wparams(d), *nbounds(d)) for d in descs], f32).T.copy()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array → device tensor; to the card from pinned memory without
    blocking the host."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class _Fetch:
    """A packed [K, n] result on its way to the host.  On the card the copy
    runs on ``side`` (pinned destination) after an event recorded behind
    the chunk's kernels, so the default stream can take the next chunk."""

    def __init__(self, packed: torch.Tensor, side):
        if side is None:
            self.host, self.done = packed.numpy(), None
            return
        ready = torch.cuda.Event()
        ready.record()
        buf = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            buf.copy_(packed, non_blocking=True)
            packed.record_stream(side)
            self.done = torch.cuda.Event()
            self.done.record(side)
        self.host = buf

    def result(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
            return self.host.numpy()
        return self.host


def _pipelined(items, submit, drain) -> None:
    """``drain(submit(item))`` for every item, item t + 1 submitted before
    item t is drained: the next chunk is staged and launched while the
    last one's results come to the host (at most two in flight)."""
    pending = None
    for item in items:
        entry = submit(item)
        if pending is not None:
            drain(pending)
        pending = entry
    if pending is not None:
        drain(pending)


def _chunks(n: int, chunk_n: int, d: int) -> list[tuple[int, int, int]]:
    """(start, frames, lanes a rank) of each chunk of n frames: chunks of
    ``chunk_n``, each padded to a multiple of ``d``."""
    sizes = [(s, min(chunk_n, n - s)) for s in range(0, n, chunk_n)]
    return [(s, m, divisible_batch(m, d) // d) for s, m in sizes]


def batch_block(*blocks: torch.Tensor, mesh, buckets: list[dict],
                window: bool) -> dict:
    """Rank body of :func:`run_pipeline_batch` at d > 1: for each bucket
    (``{"frames": input index, "params": input index or None, "lanes":
    [lanes of each chunk]}``), this rank's lanes of each chunk of it
    (``blocks`` are host tensors) through :func:`_device_qa`, chunk t + 1
    uploaded and launched before chunk t's results are read → ``packed``
    (one [28, lanes] array a bucket) and this rank's compute in ms."""
    dev = mesh.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    packed = []
    for b in buckets:
        x = blocks[b["frames"]].numpy()
        p = (None if b["params"] is None
             else blocks[b["params"]].numpy()[:, :, 0])
        starts = np.cumsum([0] + b["lanes"][:-1]).tolist()
        parts: list[np.ndarray] = []
        _pipelined(
            zip(starts, b["lanes"]),
            lambda c: _Fetch(_device_qa(
                x[c[0]:c[0] + c[1]],
                None if p is None else p[c[0]:c[0] + c[1]].T.copy(),
                dev, window), side),
            lambda f: parts.append(f.result().copy()))
        packed.append(np.concatenate(parts, axis=1))
    return {"packed": packed, "rank_ms": (time.perf_counter() - t0) * 1e3}


def _run_sharded(buckets: list, d: int, chunk_n: int, dev, window: bool
                 ) -> tuple[list, dict]:
    """The deterministic QA of every chunk of every bucket on ``d`` ranks
    in one launch (module doc) → ([(h, w, chunk's frames, packed [28, n]
    numpy)] in the order of the one-card loop, the launch's info with its
    wall and each rank's compute)."""
    inputs: list[np.ndarray] = []
    specs, plan = [], []
    for h, w, frames in buckets:
        chunks = _chunks(len(frames), chunk_n, d)
        # rank r's block: lanes r·l … (r + 1)·l − 1 of each padded chunk,
        # chunk after chunk; a lane past a chunk's last frame copies it
        order = [s + min(r * lanes + j, n - 1)
                 for r in range(d) for s, n, lanes in chunks
                 for j in range(lanes)]
        spec = {"frames": len(inputs), "params": None,
                "lanes": [lanes for _, _, lanes in chunks]}
        inputs.append(np.stack([frames[i][2] for i in order]))
        if frames[0][4] is not None:
            spec["params"] = len(inputs)
            inputs.append(_ingest_params([frames[i][4] for i in order],
                                         window).T[:, :, None].copy())
        specs.append(spec)
        plan.append((h, w, frames, chunks))
    t0 = time.perf_counter()
    launched = launch.run(batch_block, tuple(inputs), n_space=1, n_data=d,
                          device=dev.type, host_blocks=True, buckets=specs,
                          window=window)
    info = dict(launched.info(), wall_ms=(time.perf_counter() - t0) * 1e3,
                rank_ms=[r["rank_ms"] for r in launched.results])
    out = []
    for b, (h, w, frames, chunks) in enumerate(plan):
        ranks = [r["packed"][b] for r in launched.results]
        at = 0
        for s, n, lanes in chunks:
            whole = np.concatenate([p[:, at:at + lanes] for p in ranks],
                                   axis=1)
            out.append((h, w, frames[s:s + n], whole[:, :n]))
            at += lanes
    return out, info


def run_pipeline_batch(
    input_path: str,
    output_dir: str = "outputs",
    *,
    save_artifacts: bool = True,
    resume: bool = False,
    window: bool = False,
    autotune: bool = False,
    device="cuda",
    tv_mode: str | None = None,
    n_data: int | None = None,
) -> dict[str, Any]:
    """QA all frames of a series / directory on a data axis of ``n_data``
    ranks (None: every visible card on the card, 1 on the CPU; module
    doc).

    ``window=True`` applies each sample's stored DICOM VOI window
    (BASELINE config 5) before QA instead of min-max normalisation alone.
    ``autotune=True`` sweeps the candidate grid per frame and applies each
    frame's best plan (``tv_mode`` as in :func:`run_pipeline`), on one card
    whatever ``n_data`` is.  ``resume=True`` skips frames whose
    ``label#frameN`` key already has a completed run in the DB.  Returns a
    summary context with per-frame records, ``"mesh"`` (JAX's
    ``dict(mesh.shape)``) and ``"launch"`` (the launch's info, its wall and
    each rank's compute; None when the run made none); ``device`` as in
    :func:`run_pipeline`."""
    dev = resolve_device(device)
    d = data_axis(n_data, dev)
    storage.init_db()

    if autotune:
        # the sweep runs from host-normalised frames
        items = _collect_inputs(input_path, window=window)
        buckets = {
            (h, w, "float32"): [(lb, fi, fr, m, None) for lb, fi, fr, m
                                in v]
            for (h, w), v in _buckets(items, window=window).items()}
    else:
        items = _collect_inputs_raw(input_path, window=window)
        buckets = _buckets_raw(items, window=window)
    if not items:
        raise RuntimeError(f"No DICOM inputs found at {input_path}")

    done = _completed_frames() if resume else set()
    if save_artifacts:
        os.makedirs(output_dir, exist_ok=True)
    chunk_n = divisible_batch(CHUNK, d)

    skipped = 0
    todo = []
    for (h, w, _kind), frames in sorted(buckets.items()):
        if done:
            kept = [f for f in frames if f"{f[0]}#frame{f[1]}" not in done]
            skipped += len(frames) - len(kept)
            frames = kept
        if frames:
            todo.append((h, w, frames))

    results: list[dict[str, Any]] = []
    info = None
    if d > 1 and not autotune and todo:
        chunks, info = _run_sharded(todo, d, chunk_n, dev, window)
        for h, w, frames, packed in chunks:
            _collect(frames, packed, h, w, results, save_artifacts)
    else:
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def submit(item):
            h, w, chunk = item
            x = np.stack([f[2] for f in chunk])
            if autotune:
                packed = _pack_outputs(_autotune_chunk(
                    x.astype(np.float32), dev, tv_mode))
            else:
                params = (None if chunk[0][4] is None else
                          _ingest_params([f[4] for f in chunk], window))
                packed = _device_qa(x, params, dev, window)
            return item, _Fetch(packed, side)

        def drain(entry):
            (h, w, chunk), fetch = entry
            _collect(chunk, fetch.result(), h, w, results, save_artifacts)

        _pipelined(((h, w, frames[s:s + chunk_n])
                    for h, w, frames in todo
                    for s in range(0, len(frames), chunk_n)), submit, drain)

    n_pass = sum(1 for r in results if r["passed"])
    summary_lines = [
        "# mdx batch QA report", "",
        f"Frames processed: **{len(results)}** "
        f"(validation pass: {n_pass}/{len(results)})", "",
        "| source | frame | issues | ssim | psnr | score |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        summary_lines.append(
            f"| {r['source']} | {r['frame']} | "
            f"{', '.join(r['issues']) or '—'} | {r['ssim']:.4f} | "
            f"{r['psnr']:.2f} | {r['objective_score']:.4f} |")
    report_md = "\n".join(summary_lines)

    if save_artifacts:
        path = os.path.join(output_dir, "batch_report.md")
        with open(path, "w", encoding="utf-8") as f:
            f.write(report_md)

    return {
        "batch": True,
        "frames": results,
        "skipped": skipped,
        "report_md": report_md,
        "mesh": {"data": d, "space": 1},
        "launch": info,
    }
