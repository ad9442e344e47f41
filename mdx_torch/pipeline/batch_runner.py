"""Batch / series runner: QA every frame of a series or directory on the
card, or on every visible card.

Counterpart of ``mdx/pipeline/batch_runner.py``:

* a multi-frame DICOM becomes an ``[F, H, W]`` stack, a directory of DICOMs
  (decoded on 8 host threads) one frame per file;
* frames are bucketed by shape (and stored dtype) and run in chunks of
  :data:`CHUNK` frames, on each rank of a data axis of ``d`` ranks; the
  autotune path, on one card, runs chunks of ``ceil(64 / d)·d`` frames
  (JAX's ``chunk_n``);
* the deterministic path puts each frame's stored integers in its slot of
  its chunk's pinned host buffer, read there straight from the file where
  they are stored plain (:func:`_collect_inputs_raw`), uploads that buffer
  and normalises on the card (``normalize_ingest``) before
  ``qa_deterministic``; the autotune path sweeps the candidate grid per
  frame from host-normalised frames;
* a chunk's results are packed on the card into one ``[28, n]`` float32
  array (18 metrics, 5 issue masks, SSIM, PSNR, quality improvement, pass,
  score) that comes to pinned host memory on a side stream, so chunk t's
  copy and row writing overlap chunk t+1's upload and launches;
* each frame gets a DB row keyed ``label#frameN``, so ``resume=True``
  skips the frames a crashed batch (of either package) already finished.

With ``d > 1`` (``n_data``; by default every visible card, as JAX's
``make_mesh()``) the deterministic path runs on this process's rank pool
(:mod:`mdx_torch.parallel.pool`: rank 0 is this process, on its card;
ranks 1 … d − 1 are started on first use and kept across calls).  This
process lists the input (a directory's file names, a multi-frame file's
frame count from its header) and splits the frames left to do into ``d``
contiguous shares in the one-card record order; each rank, this process
for share 0 meanwhile, stages its share into its own pinned chunk buffers
and runs the one-card chunk loop on it (:func:`stage_block`), and sends
back its packed results and each frame's label and metadata.  This
process then writes the records, the report and the DB rows in the
one-card order.  The ranks exchange nothing: every op is per image.  With
``d = 1`` everything runs in this process.  ``autotune=True`` runs on one
card at every ``d``, as JAX's unsharded ``_autotune_chunk`` does.
"""

from __future__ import annotations

import logging
import os
import time
from functools import partial
from typing import Any

import numpy as np
import torch

from mdx_torch import telemetry
from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS
from mdx_torch.io import load_dicom, load_series, normalize_image
from mdx_torch.io.dicom import (_metadata, load_frames_raw, plain_frame_dtype,
                                raw_ingest_descriptor, read_dataset,
                                read_frame_into)
from mdx_torch.parallel.mesh import data_axis, divisible_batch
from mdx_torch.pipeline import storage
from mdx_torch.pipeline.profiler import traced_run
from mdx_torch.pipeline.runner import resolve_device

logger = logging.getLogger(__name__)

CHUNK = 64
# the most host memory a call's staged chunks hold pinned (the caching
# host allocator keeps its blocks for the process's life): a 64-frame
# 2048² uint16 chunk is 512 MiB
_PIN_BYTES = 1 << 30
# stored integer dtypes normalize_ingest takes (int8 widens to int16)
_INGEST_DTYPES = (np.uint8, np.int16, np.uint16)


def _dicom_names(input_path: str) -> list[str]:
    return sorted(n for n in os.listdir(input_path)
                  if os.path.splitext(n)[1].lower() in (".dcm", ".dicom"))


def _threaded(fn, items: list, labels: list[str], span: str,
              workers: int = 8) -> list:
    """``fn(item)`` for every item on ``workers`` host threads, each call
    in the span ``span``; an item whose call raises is skipped with a
    warning (its result None)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(pair):
        item, label = pair
        try:
            with telemetry.span(span):
                return fn(item)
        except Exception as exc:
            logger.warning("Skipping %s: %s", label, exc)
            return None

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(one, zip(items, labels)))


def _map_dir(input_path: str, load_one) -> list:
    """``load_one(path, name)`` over a directory's DICOMs on 8 host threads;
    a file that fails to load is skipped with a warning."""
    names = _dicom_names(input_path)
    return [r for r in _threaded(
        lambda n: load_one(os.path.join(input_path, n), n), names, names,
        "decode.file") if r is not None]


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


def _decode_raw(path: str, name: str | None, window: bool
                ) -> tuple[list[np.ndarray], dict | None, dict]:
    """A file that is not read in place (:func:`plain_frame_dtype`),
    decoded as the deterministic path takes it → ([2-D frame], descriptor
    | None, metadata): the stored integers (int8 widened to int16), or,
    descriptor None, host-normalised float32 frames (RGB, float and 32-bit
    integer pixel data).  A directory entry (``name``) gives its middle
    frame."""
    frames, desc, meta = load_frames_raw(path, window=window)
    if desc is not None and frames.dtype == np.int8:
        frames = frames.astype(np.int16)
    elif desc is not None and frames.dtype not in _INGEST_DTYPES:
        # 32-bit integers: the host pipeline's float32 frames
        frames, meta = load_series(path, window=window)
        desc = None
    if name is not None and frames.shape[0] > 1:
        # directory entries contribute their middle frame (the
        # reference's middle-slice reduction, dicom_io.py:60-81); the
        # descriptor keeps whole-stack scalars
        frames = frames[frames.shape[0] // 2][None]
    if desc is None:
        # windowed frames are already in [0,1] with the diagnostic range
        # mapped by the VOI window: min-max would stretch it back
        return [np.asarray(f, np.float32) if window else normalize_image(f)
                for f in frames], None, meta
    return list(frames), desc, meta


class _File:
    """One input file between the passes: ``ds`` its header where its
    frame is read in place (``frames`` then [(0, None)]); else ``frames``
    its decoded frames [(index, frame)], None until decoded, [] when its
    one frame is done; ``slots`` the (slot, frame) of the frames it
    stages."""

    __slots__ = ("label", "path", "ds", "key", "meta", "desc", "frames",
                 "slots")

    def __init__(self, label: str, path: str):
        self.label, self.path = label, path
        self.ds = self.key = self.meta = self.desc = self.frames = None
        self.slots: list = []


def _chunk_plan(by_key: dict, done, chunk_n: int) -> tuple[list, int]:
    """Each bucket's frames (tuples that start label, frame index) whose
    ``label#frameN`` is not in ``done``, cut into chunks of ``chunk_n``,
    buckets in sorted key order → ([(key, [chunk])], frames left out)."""
    plan, skipped = [], 0
    for key, frames in sorted(by_key.items()):
        kept = [e for e in frames if f"{e[0]}#frame{e[1]}" not in done]
        skipped += len(frames) - len(kept)
        if kept:
            plan.append((key, [kept[s:s + chunk_n]
                               for s in range(0, len(kept), chunk_n)]))
    return plan, skipped


def _collect_inputs_raw(input_path: str, window: bool = False, *,
                        done=frozenset(), chunk_n: int = CHUNK,
                        pin: bool = False, names: list[str] | None = None,
                        frames: tuple[int, int] | None = None,
                        threads: int = 8):
    """Every frame of a file or directory staged for the deterministic
    path, its stored integers in the host buffer that is uploaded for its
    chunk → (buckets, files, skipped).

    ``buckets``: [(h, w, [(entries, x)])] by (H, W, stored dtype), each
    chunk ``x`` a [m ≤ chunk_n, H, W] tensor whose frame i is the view
    ``entries[i][2]`` of entry (label, frame index, frame, metadata, ingest
    descriptor | None).  Descriptor None ⇒ x holds host-normalised float32
    frames (RGB or float pixel data).  With ``pin`` a chunk is pinned
    while the pinned sum stays within :data:`_PIN_BYTES`; the others stay
    pageable and :func:`_upload` pins each by a copy.  ``files`` counts
    the files read, ``skipped`` the frames left out because their
    ``label#frameN`` is in ``done``.  A rank's share (:func:`stage_block`):
    ``names``, the directory's files it reads (default: all), or
    ``frames``, the range [start, stop) of a lone file's frames it stages;
    ``threads``, the host threads of its decode and pixel passes.

    Three passes.  The header pass, on this thread, reads each file up to
    its pixel value; a file of one frame (a directory entry, or a plain
    file) that ``done`` holds is read no further.  The decode pass, on 8
    host threads, decodes each file whose frame is not stored plain
    (:func:`plain_frame_dtype`; :func:`_decode_raw`).  The buffers are then
    allocated, and the pixel pass, on 8 host threads, reads each plain
    frame straight into its slot (its descriptor's min/max from there) and
    copies each decoded frame into its own.  A file that fails is skipped
    with a warning (a lone file raises); one that fails in the pixel pass
    leaves a hole that is closed by compacting its chunk."""
    lone = not os.path.isdir(input_path)
    if names is None and not lone:
        names = _dicom_names(input_path)

    def head(name: str | None) -> _File:
        path = input_path if lone else os.path.join(input_path, name)
        f = _File(name or os.path.basename(path), path)
        ds = read_dataset(path, pixels=False)
        dtype = plain_frame_dtype(ds)
        if (dtype is not None or not lone) and f"{f.label}#frame0" in done:
            f.frames = []
        elif dtype is not None:
            f.ds, f.key, f.meta, f.frames = ds, (
                ds.get("Rows"), ds.get("Columns"), str(dtype)), _metadata(
                    ds), [(0, None)]
        return f

    def decode(f: _File) -> _File:
        decoded, f.desc, f.meta = _decode_raw(f.path, None if lone
                                              else f.label, window)
        f.frames = list(enumerate(decoded))
        return f

    def fill(f: _File) -> _File:
        if f.ds is not None:
            ((slot, _),) = f.slots
            read_frame_into(f.path, f.ds, slot)
            f.desc = raw_ingest_descriptor(f.ds, slot)
            telemetry.count_staged("in_place")
        else:
            for slot, frame in f.slots:
                slot[...] = frame
            telemetry.count_staged("copied", len(f.slots))
        return f

    # the header pass is Python parsing under the interpreter lock: on 8
    # threads it took 2.5x as long as on one (PERF.md §6); the codecs
    # release the lock, so the decodes keep the threads
    with telemetry.span("decode.header"):
        if lone:
            files = [head(None)]
        else:
            files = []
            for name in names:
                try:
                    files.append(head(name))
                except Exception as exc:
                    logger.warning("Skipping %s: %s", name, exc)
    coded = [f for f in files if f.frames is None]
    if lone:
        for f in coded:
            decode(f)
            if frames is not None:
                # the whole stack decoded: its ingest scalars span it
                f.frames = [e for e in f.frames
                            if frames[0] <= e[0] < frames[1]]
    elif coded:
        _threaded(decode, coded, [f.label for f in coded], "decode.file",
                  threads)
    files = [f for f in files if f.frames is not None]

    with telemetry.span("bucket"):
        by_key: dict[tuple, list] = {}
        for f in files:
            for fidx, frame in f.frames:
                key = f.key if frame is None else (
                    frame.shape + (str(frame.dtype),))
                by_key.setdefault(key, []).append((f.label, fidx, frame, f))
        plan, skipped = _chunk_plan(by_key, done, chunk_n)
        skipped += sum(not f.frames for f in files)
        pinned = 0
        for (h, w, kind), chunks in plan:
            for i, part in enumerate(chunks):
                shape = (len(part), h, w)
                nbytes = np.dtype(kind).itemsize * len(part) * h * w
                if pin and pinned + nbytes <= _PIN_BYTES:
                    pinned += nbytes
                    x = torch.empty(shape, dtype=getattr(torch, kind),
                                    pin_memory=True)
                else:
                    # numpy's allocator hands the last call's freed pages
                    # out again; torch's maps fresh ones, whose first
                    # writes fault (3x the copy's time at 512²)
                    x = torch.from_numpy(np.empty(shape, kind))
                view = x.numpy()
                for j, (_, _, frame, f) in enumerate(part):
                    f.slots.append((view[j], frame))
                chunks[i] = (x, part)

    staging = [f for f in files if f.slots]
    if lone:
        filled = [fill(f) for f in staging]
    else:
        filled = _threaded(fill, staging, [f.label for f in staging],
                           "decode.file", threads)
    failed = {f for f, ok in zip(staging, filled) if ok is None}

    buckets = []
    for (h, w, _kind), chunks in plan:
        staged = []
        for x, part in chunks:
            keep = [i for i, e in enumerate(part) if e[3] not in failed]
            if not keep:
                continue
            if len(keep) < len(part):
                y = torch.empty((len(keep), h, w), dtype=x.dtype,
                                pin_memory=x.is_pinned())
                x = torch.index_select(x, 0, torch.tensor(keep), out=y)
                part = [part[i] for i in keep]
            view = x.numpy()
            staged.append(([(label, fidx, view[i], f.meta, f.desc)
                            for i, (label, fidx, _, f) in enumerate(part)],
                           x))
        if staged:
            buckets.append((h, w, staged))
    return buckets, len(files) - len(failed), skipped


def _buckets(items: list[tuple[str, np.ndarray, dict]],
             window: bool = False):
    """Group frames by (H, W) as entries (label, frame index, frame,
    metadata, None).  Windowed frames are already in [0,1] with the
    diagnostic range mapped by the VOI window — min-max re-normalising
    would stretch it back."""
    by_shape: dict[tuple[int, int], list] = {}
    for label, stack, meta in items:
        for f in range(stack.shape[0]):
            frame = (np.asarray(stack[f], np.float32) if window
                     else normalize_image(stack[f]))
            by_shape.setdefault(frame.shape, []).append((label, f, frame,
                                                         meta, None))
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


def _device_qa(x: np.ndarray | torch.Tensor, params: np.ndarray | None,
               dev, window: bool) -> torch.Tensor:
    """One chunk's deterministic QA → its packed [28, n] results on the
    device: stored integer frames and their [9, n] ingest scalars through
    ``normalize_ingest``, or host-normalised float32 frames (``params``
    None), uploaded (:func:`_upload`), then ``qa_deterministic``."""
    from mdx_torch.core import qa
    from mdx_torch.ops.ingest import normalize_ingest

    with telemetry.span("upload", frames=x.shape[0]):
        x = _upload(x, dev)
        if params is not None:
            params = _upload(params, dev)
    with telemetry.span("launch", frames=x.shape[0]):
        if params is not None:
            x = normalize_ingest(x, *params, per_frame_minmax=not window)
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


def _upload(a: np.ndarray | torch.Tensor, dev: torch.device
            ) -> torch.Tensor:
    """Host array or tensor → device tensor; to the card from pinned memory
    without blocking the host.  A numpy array or a pageable tensor is
    pinned by a copy; a pinned tensor (a chunk of
    :func:`_collect_inputs_raw`) is copied from as it is, so that the
    caching host allocator records the copy and hands its block out again
    only once the copy is done."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    if dev.type != "cuda":
        return a
    if not a.is_pinned():
        a = a.pin_memory()
    return a.to(dev, non_blocking=True)


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
        with telemetry.span("fetch"):
            if self.done is not None:
                with telemetry.count_sync("batch.fetch"):
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


def _submit_raw(item, dev, window: bool, side):
    """One staged chunk ``(h, w, entries, x)`` of the deterministic path:
    its ingest scalars, upload and pass → ((h, w, entries), its
    :class:`_Fetch`)."""
    h, w, chunk, x = item
    with telemetry.span("stage", frames=len(chunk)):
        params = (None if chunk[0][4] is None else
                  _ingest_params([f[4] for f in chunk], window))
    return (h, w, chunk), _Fetch(_device_qa(x, params, dev, window), side)


def _submit_autotune(item, dev, window: bool, side, *, tv_mode):
    """One chunk ``(h, w, entries, None)`` of the autotune path: its
    host-normalised frames (``window`` was applied as they were read)
    stacked and swept by :func:`_autotune_chunk` → ((h, w, entries), its
    :class:`_Fetch`)."""
    h, w, chunk, _ = item
    with telemetry.span("stage", frames=len(chunk)):
        x = np.stack([f[2] for f in chunk]).astype(np.float32)
    with telemetry.span("launch", frames=len(chunk)):
        packed = _pack_outputs(_autotune_chunk(x, dev, tv_mode))
    return (h, w, chunk), _Fetch(packed, side)


def _walk(todo, dev, window: bool, drain, submit=_submit_raw) -> None:
    """The chunk walk of the one-card loop: every chunk of ``todo`` (the
    buckets ``[(h, w, [(entries, x)])]`` of :func:`_collect_inputs_raw`)
    through ``submit`` (:func:`_submit_raw`, or :func:`_submit_autotune`)
    on ``dev``, its results fetched over a side stream on the card, and
    ``drain(((h, w, entries), fetch))`` for each, chunk t + 1 submitted
    before chunk t is drained (:func:`_pipelined`)."""
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    _pipelined(((h, w, chunk, x) for h, w, staged in todo
                for chunk, x in staged),
               lambda item: submit(item, dev, window, side), drain)


def stage_block(share: dict, *, mesh, input_path: str, window: bool,
                done, chunk_n: int, threads: int, trace: bool) -> dict:
    """Rank body of :func:`run_pipeline_batch` at d > 1, on rank
    ``mesh.rank`` of the pool (rank 0: the calling process): this rank's
    ``share`` (``{"names": [file]}`` of a directory or ``{"frames":
    (start, stop)}`` of a lone file) staged by :func:`_collect_inputs_raw`
    into this rank's pinned chunk buffers on ``threads`` host threads,
    then the one-card chunk loop → ``chunks`` [((h, w, dtype), [(label,
    frame, metadata)], packed [28, n])] in the one-card order of the
    share, and the rank's numbers: ``frames``, ``files``, ``stage_ms``
    (the staging), ``qa_ms`` (first upload to the last result on the
    host), ``peak_bytes`` (``max_memory_allocated``, reset as the call
    starts on a spawned rank; 0 on the CPU), ``ms`` (the whole body) and,
    with ``trace`` on a spawned rank, its ``spans``."""
    t0 = time.perf_counter()
    dev = mesh.device
    cuda = dev.type == "cuda"
    # rank 0 records into this process's tracer, and leaves its peak alone
    spawned = mesh.rank > 0
    if trace and spawned:
        telemetry.reset()
        telemetry.enable()
    if cuda and spawned:
        torch.cuda.reset_peak_memory_stats(dev)
    out: list = []
    n_files, t1 = 0, time.perf_counter()
    try:
        start, stop = share.get("frames", (0, 0))
        if share.get("names") or stop > start:
            todo, n_files, _ = _collect_inputs_raw(
                input_path, window, done=done, chunk_n=chunk_n, pin=cuda,
                names=share.get("names"), frames=share.get("frames"),
                threads=threads)
            t1 = time.perf_counter()

            def drain(entry):
                (h, w, chunk), fetch = entry
                packed = fetch.result()
                out.append(((h, w, str(chunk[0][2].dtype)), [
                    (label, fidx, meta) for label, fidx, _, meta, _ in chunk],
                    packed.copy()))

            _walk(todo, dev, window, drain)
            if cuda:
                torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        res = {"chunks": out, "frames": sum(len(c[1]) for c in out),
               "files": n_files, "stage_ms": (t1 - t0) * 1e3,
               "qa_ms": (t2 - t1) * 1e3,
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else 0)}
        if trace and spawned:
            res["spans"] = telemetry.snapshot()["spans"]
    finally:
        if trace and spawned:
            telemetry.disable()
    res["ms"] = (time.perf_counter() - t0) * 1e3
    return res


def _shares(input_path: str, d: int, done) -> tuple[list[dict], int, int]:
    """The input listed and its frames left to do split into ``d``
    contiguous shares in the one-card order → (shares, files listed,
    frames skipped because ``done`` holds them); no shares when no frame
    is left.  A directory is split by file names (each file is one frame),
    a lone file by frame ranges of its header's frame count; no pixel
    value is read."""
    if os.path.isdir(input_path):
        names = _dicom_names(input_path)
        todo = [n for n in names if f"{n}#frame0" not in done]
        parts = np.array_split(np.arange(len(todo)), d)
        shares = [{"names": [todo[i] for i in p]} for p in parts]
        files = n = len(names)
    else:
        label = os.path.basename(input_path)
        n = int(read_dataset(input_path, pixels=False).get(
            "NumberOfFrames", 1) or 1)
        todo = [i for i in range(n) if f"{label}#frame{i}" not in done]
        parts = np.array_split(np.asarray(todo, int), d)
        shares = [{"frames": (int(p[0]), int(p[-1]) + 1) if len(p)
                   else (0, 0)} for p in parts]
        files = 1
    return (shares if todo else []), files, n - len(todo)


def _run_pool(input_path: str, shares: list[dict], d: int, dev,
              window: bool, done) -> tuple[list, dict]:
    """Every share on its rank of the pool, share 0 in this process
    (module doc) → ([(h, w, chunk's entries, packed [28, n])] in the
    one-card order, the call's info: the pool's backend, ``starts`` (rank
    processes started by this call) and ``start_ms``, ``wall_ms`` (from
    dispatch to the last rank's result: ``dispatch_ms``, ``local_ms`` for
    rank 0's share here, ``wait_ms`` for the others after it), the host
    threads a rank ``threads``, each rank's numbers (:func:`stage_block`)
    as lists ``rank_ms``, ``rank_frames``, ``rank_stage_ms``,
    ``rank_qa_ms``, ``rank_peak_bytes``, and the files the ranks read,
    ``files``)."""
    from mdx_torch.parallel import pool as pool_mod

    starts0 = telemetry.RANKS.get("starts", 0)
    t0 = time.perf_counter()
    pool = pool_mod.get(d, dev)
    t1 = time.perf_counter()
    label = os.path.basename(input_path)
    mine = ({k for k in done if k.startswith(label + "#frame")}
            if not os.path.isdir(input_path) else set())
    threads = max(2, len(os.sched_getaffinity(0)) // d)
    results = pool.call(stage_block, [(s,) for s in shares],
                        input_path=input_path, window=window, done=mine,
                        chunk_n=CHUNK, threads=threads,
                        trace=telemetry.enabled())
    t2 = time.perf_counter()
    by_key: dict[tuple, list] = {}
    for r, res in enumerate(results):
        telemetry.merge(res.pop("spans", []), rank=r, pid=pool.pids[r])
        for key, entries, packed in res.pop("chunks"):
            by_key.setdefault(key, []).append((entries, packed))
    out = []
    for key in sorted(by_key):
        h, w, _ = key
        for entries, packed in by_key[key]:
            out.append((h, w, [(lb, fi, None, meta, None)
                               for lb, fi, meta in entries], packed))
    info = {"backend": pool.backend, "n_space": 1, "n_data": d,
            "host_round_trips": 0,
            "starts": telemetry.RANKS.get("starts", 0) - starts0,
            "start_ms": (t1 - t0) * 1e3, "wall_ms": (t2 - t1) * 1e3,
            **pool.last_ms, "threads": threads,
            "files": sum(r["files"] for r in results)}
    for k in ("ms", "frames", "stage_ms", "qa_ms", "peak_bytes"):
        info["rank_" + k] = [r[k] for r in results]
    return out, info


def _batch_report(results: list[dict], output_dir: str,
                  save_artifacts: bool) -> str:
    """The batch's markdown report (written as ``batch_report.md``)."""
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
    return report_md


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
    ``dict(mesh.shape)``) and ``"launch"`` (the rank pool's call:
    :func:`_run_pool`'s info; None when the run made none); ``device`` as
    in :func:`run_pipeline`."""
    dev = resolve_device(device)
    d = data_axis(n_data, dev)
    with traced_run("batch", f"batch_{storage.generate_run_id()}"):
        storage.init_db()
        done = _completed_frames() if resume else set()

        if autotune:
            # the sweep runs from host-normalised frames
            with telemetry.span("decode"):
                items = _collect_inputs(input_path, window=window)
            with telemetry.span("bucket"):
                plan, skipped = _chunk_plan(_buckets(items, window=window),
                                            done, divisible_batch(CHUNK, d))
            n_files = len(items)
            todo = [(h, w, [(chunk, None) for chunk in chunks])
                    for (h, w), chunks in plan]
        elif d > 1:
            # each rank reads its own share; this process lists the input
            with telemetry.span("list"):
                todo, n_files, skipped = _shares(input_path, d, done)
        else:
            with telemetry.span("decode"):
                todo, n_files, skipped = _collect_inputs_raw(
                    input_path, window=window, done=done, chunk_n=CHUNK,
                    pin=dev.type == "cuda")
        if not n_files:
            raise RuntimeError(f"No DICOM inputs found at {input_path}")

        if save_artifacts:
            os.makedirs(output_dir, exist_ok=True)

        results: list[dict[str, Any]] = []
        info = None
        if d > 1 and not autotune:
            if todo:
                chunks, info = _run_pool(input_path, todo, d, dev, window,
                                         done)
                if not info["files"] and not skipped:
                    raise RuntimeError(
                        f"No DICOM inputs found at {input_path}")
                for h, w, frames, packed in chunks:
                    with telemetry.span("collect", frames=len(frames)):
                        _collect(frames, packed, h, w, results,
                                 save_artifacts)
        else:
            def drain(entry):
                (h, w, chunk), fetch = entry
                packed = fetch.result()
                with telemetry.span("collect", frames=len(chunk)):
                    _collect(chunk, packed, h, w, results, save_artifacts)

            _walk(todo, dev, window, drain,
                  partial(_submit_autotune, tv_mode=tv_mode) if autotune
                  else _submit_raw)

        with telemetry.span("report"):
            report_md = _batch_report(results, output_dir, save_artifacts)

        return {
            "batch": True,
            "frames": results,
            "skipped": skipped,
            "report_md": report_md,
            "mesh": {"data": d, "space": 1},
            "launch": info,
        }
