"""Deploy-time priming: ``python -m mdx_torch.pipeline.prime``.

Counterpart of ``mdx/pipeline/prime.py``.  A fresh host pays two builds
before its first run: nvcc's build of the CUDA kernel library
(``kernels/_build.py``) and, at its first compressed file, the host C++
build of the codec loops (``io/native.py``).  Both land in
``build/`` at the root of the checkout, named by a hash of their sources
and flags, so every later process on the host finds them.  The port
compiles nothing else per program (PyTorch runs the rest eagerly), so
there is no compile cache to fill, as JAX's primer fills XLA's: the
builds are what persists.  Everything else a first run pays — the CUDA
context, PyTorch's lazily loaded kernels, the first pass at a shape, a
rank pool's start-up — is warmed in the process that calls the primer.

The primer builds both libraries first, side by side
(:func:`build_libraries`; a failed build raises, nothing falls back to the
plain versions), then drives the
entry points JAX's primer drives, at the same shapes, through the
product's own functions, with the same deduplication, and returns JAX's
count (one a program JAX would compile; builds are not counted):

* :func:`prime`: ``qa.qa_deterministic`` on ``[1, H, W]`` (the
  single-image runner), then one chunk per stored dtype and windowing
  mode through the batch runner's own path (``_ingest_params``,
  ``_device_qa``: the pinned upload, ``normalize_ingest``,
  ``qa_deterministic`` and ``_pack_outputs``; ``_Fetch``), in the rank
  body :func:`prime_chunks`.  On a data axis of d > 1 ranks that body
  runs in one call on this process's rank pool
  (``mdx_torch.parallel.pool``), which ``--batch`` in this process then
  runs on, every rank running every chunk at ``--batch``'s chunk size;
* :func:`prime_tuning`: ``core.tuning.autotune`` once per distinct
  candidate count K, and the GenAI tools' three functions at ``[1, H, W]``
  (``image_stats``, ``qa.enhance_only`` on the default op chain,
  ``validate``);
* :func:`prime_spatial`: the ``--spatial`` path in ONE ``launch.run`` a
  shape (:func:`prime_spatial_block`): the sharded stats pass, the sharded
  QA chain for each distinct gate combination, one spatial autotune sweep.

Each step is logged with JAX's line and its seconds.  A serving process
can call these functions itself to warm its own process.

CLI (JAX's flags; on the card, as ``python -m mdx_torch``)::

    python -m mdx_torch.pipeline.prime --shapes 512x512,1024x1024 \\
        --chunk 64 --dtypes uint16,int16,uint8,float32 --window both \\
        --tuning --issues noise+low_contrast,blur [--spatial]

On the CPU (the tests): ``main([...], device="cpu")``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from mdx_torch.pipeline.runner import resolve_device

logger = logging.getLogger(__name__)

RAW_DTYPES = ("uint16", "int16", "uint8")


def _synthetic_descs(dtype: str, n: int) -> list[dict]:
    """Plausible raw-ingest descriptors (the ``load_frames_raw`` contract)
    for synthetic frames (``mdx/pipeline/prime.py:47-56``)."""
    gmax = {"uint8": 255.0, "int16": 2047.0, "uint16": 4095.0}[dtype]
    return [{
        "slope": 1.0, "intercept": 0.0, "mono1": False,
        "gmin": 0.0, "gmax": gmax,
        "window": (gmax / 2.0, gmax) if i % 2 else None,
    } for i in range(n)]


def _synthetic_frames(h: int, w: int, n: int, dtype: str) -> np.ndarray:
    """``[n, h, w]`` frames of ``dtype`` from ``default_rng(0)``
    (``mdx/pipeline/prime.py:59-64``)."""
    rng = np.random.default_rng(0)
    if dtype == "float32":
        return rng.random((n, h, w), np.float32)
    hi = {"uint8": 255, "int16": 2048, "uint16": 4096}[dtype]
    return rng.integers(0, hi, (n, h, w)).astype(dtype)


def _now(dev: torch.device) -> float:
    """The host clock once the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _build_host() -> tuple[dict, float]:
    """The host codec library built (or found) and loaded → (``native``'s
    build record, seconds)."""
    from mdx_torch.io import native

    t0 = time.perf_counter()
    info = native.build()
    native.load()
    return info, time.perf_counter() - t0


def build_libraries(dev: torch.device,
                    log: Callable[[str], None] = logger.info) -> None:
    """Build (or find) and load the two native libraries at once, nvcc's
    and the host compiler's processes side by side: the CUDA kernel library
    when ``dev`` is the card, and the host codec library unless
    ``MDX_NO_NATIVE`` is set.  One log line each, in place of JAX's
    ``compile cache:`` line.  A failed build raises."""
    from concurrent.futures import ThreadPoolExecutor

    from mdx_torch.io import native

    with ThreadPoolExecutor(max_workers=1) as pool:
        host = None if native.disabled() else pool.submit(_build_host)
        if dev.type == "cuda":
            from mdx_torch import kernels
            from mdx_torch.kernels import _build

            found = _build.library_path().exists()
            t0 = time.perf_counter()
            path = _build.build()
            kernels.library()
            secs = time.perf_counter() - t0
            log(f"kernel library: {path} "
                + (f"(found, loaded in {secs:.2f} s)" if found
                   else f"(built in {secs:.1f} s)"))
        else:
            log(f"kernel library: not built (device {dev.type}: the plain "
                "versions run)")
        if host is None:
            log("host codec library: not built (MDX_NO_NATIVE is set: the "
                "Python loops run)")
            return
        info, secs = host.result()
    log(f"host codec library: {info['path']} "
        + (f"(found, loaded in {secs:.2f} s)" if info["seconds"] is None
           else f"(built in {info['seconds']:.1f} s with "
                f"{info['version'] or info['compiler']})"))


def prime_tuning(
    shapes: Sequence[tuple[int, int]] = ((512, 512),),
    *,
    issue_sets: Sequence[Sequence[str]] = (("noise", "low_contrast"),
                                           ("blur",)),
    device="cuda",
    log: Callable[[str], None] = logger.info,
) -> int:
    """Warm the tuning surface: ``core.tuning.autotune`` once per distinct
    candidate count K of ``issue_sets`` (9 lanes without blur, 27 with its
    unsharp grid), then the GenAI tools' three functions at ``[1, H, W]``
    (``image_stats``, ``enhance_only`` on the default op chain,
    ``validate``).  Returns JAX's count."""
    from mdx_torch.core import metrics, qa, tuning
    from mdx_torch.core import validate as V
    from mdx_torch.core.schemas import EnhancementPlan

    dev = resolve_device(device)
    count = 0
    for h, w in shapes:
        t_shape = time.perf_counter()
        img = _synthetic_frames(h, w, 1, "float32")[0]
        seen_k = set()
        for issues in issue_sets:
            k = len(tuning.candidate_grid(list(issues)))
            if k in seen_k:   # the same K runs the same sweep
                continue
            seen_k.add(k)
            t0 = _now(dev)
            tuning.autotune(img, list(issues), device=dev)
            count += 1
            log(f"  [{h}x{w}] autotune sweep K={k} "
                f"(issues={'+'.join(issues)}) in {_now(dev) - t0:.2f} s")
        t0 = _now(dev)
        x1 = torch.from_numpy(img)[None].to(dev)
        stats = metrics.image_stats(x1)
        stats["sigma"].cpu()
        static, dyn = EnhancementPlan(recommended_ops=[
            "denoise", "clahe", "gamma", "unsharp", "post_denoise",
        ]).to_static_dynamic(device=dev)
        enhanced, _flags = qa.enhance_only(x1, static, dyn)
        V.validate(x1, enhanced)["ssim"].cpu()
        count += 3
        log(f"  [{h}x{w}] GenAI tool programs "
            f"(image_stats, enhance_only[{'+'.join(static.ops)}], "
            f"validate) in {_now(dev) - t0:.2f} s")
        log(f"[{h}x{w}] tuning surface done in "
            f"{time.perf_counter() - t_shape:.1f} s")
    return count


SPATIAL_ISSUE_SETS = (
    ("noise",),
    ("low_contrast",),
    ("noise", "low_contrast"),
    ("blur",),
    ("noise", "low_contrast", "blur"),
    ("clipping_low",),
    ("clipping_high",),
)


def prime_spatial_block(xb: torch.Tensor, *, mesh, gates: list[dict],
                        ops: tuple[str, ...], tile_size: int) -> dict:
    """Rank body of :func:`prime_spatial`: the sharded stats pass, then
    ``spatial.qa_block`` for each of ``gates`` (``qa_block_kwargs``
    keywords), then one ``plan_sp.autotune_spatial_block`` sweep for the
    issues noise and low contrast over ``ops`` → each step's seconds on
    this rank (``seconds``: stats, each gate, the sweep)."""
    from mdx_torch.parallel import _spmd_stats as S
    from mdx_torch.parallel import plan_sp, spatial

    dev = xb.device
    marks = [_now(dev)]
    S.image_stats_block(xb, plan_sp.layout(mesh).prims)["sigma"].cpu()
    marks.append(_now(dev))
    for kw in gates:
        spatial.qa_block(xb, mesh=mesh, **spatial.qa_block_kwargs(**kw))
        marks.append(_now(dev))
    plan_sp.autotune_spatial_block(xb, ["noise", "low_contrast"], mesh=mesh,
                                   ops=tuple(ops), tile_size=tile_size)
    marks.append(_now(dev))
    return {"seconds": torch.tensor(np.diff(marks), dtype=torch.float64)}


def prime_spatial(
    shapes: Sequence[tuple[int, int]] = ((2048, 2048),),
    *,
    n_space=None,
    issue_sets: Sequence[Sequence[str]] = SPATIAL_ISSUE_SETS,
    device="cuda",
    log: Callable[[str], None] = logger.info,
) -> int:
    """Warm the huge-slice (``--spatial``) path: for each shape, one
    ``launch.run`` of :func:`prime_spatial_block` on the layout
    ``--spatial`` takes (``n_space=None``: ``spatial_layout`` over the
    visible cards; an int or ``(sy, sx)`` pins it, over gloo where the
    ranks outnumber the cards), the gates built through the runner's
    ``issue_driven_kwargs`` and deduplicated on the sorted keywords.
    Returns JAX's count (stats, each gate combination, the sweep)."""
    from mdx_torch.core.enhance import DETERMINISTIC_DEFAULTS as PD
    from mdx_torch.core.metrics import ISSUE_ORDER
    from mdx_torch.parallel import launch, spatial
    from mdx_torch.parallel.mesh import grid
    from mdx_torch.pipeline import spatial_runner as SR

    dev = resolve_device(device)
    count = 0
    for h, w in shapes:
        t_shape = time.perf_counter()
        ns = n_space
        if ns is None:
            ns = SR.spatial_layout(
                h, w, torch.cuda.device_count() if dev.type == "cuda" else 1)
        ky, kx = grid(ns)
        layout = {"sy": ky, "sx": kx} if kx > 1 else {"space": ky}
        layout_s = " ".join(f"{k}={v}" for k, v in layout.items())
        x = _synthetic_frames(h, w, 1, "float32")
        spatial.check_grid(x.shape, ns)
        combos, seen_kw = [], set()
        for issues in issue_sets:
            flags = {k: k in issues for k in ISSUE_ORDER}
            kw, ops = SR.issue_driven_kwargs(flags, h, w, ky, kx)
            key = tuple(sorted((k, str(v)) for k, v in kw.items()))
            if key not in seen_kw:
                seen_kw.add(key)
                combos.append((issues, kw, ops))
        launched = launch.run(
            prime_spatial_block, x, n_space=ns, device=dev.type,
            gates=[kw for _, kw, _ in combos],
            ops=SR._sweep_ops(h, w, ky, kx),
            tile_size=int(PD["clahe_tile_size"]))
        secs = np.asarray(launched.results[0]["seconds"])
        count += 1 + len(combos) + 1
        for (issues, _, ops), s in zip(combos, secs[1:-1]):
            log(f"  [{h}x{w}] QA chain ops={'+'.join(ops) or 'none'}"
                f" (issues={'+'.join(issues)}) in {s:.2f} s")
        log(f"  [{h}x{w}] spatial autotune sweep (one reused program) in "
            f"{secs[-1]:.2f} s")
        log(f"[{h}x{w}] spatial surface done ({layout_s}; {len(seen_kw)} "
            f"gate combos) in {time.perf_counter() - t_shape:.1f} s")
    return count


def prime_chunks(chunks: Sequence[tuple[int, int, str, bool]], *, n: int,
                 mesh) -> list[tuple[int, float]]:
    """Rank body of :func:`prime`: each ``(h, w, dtype, window)`` of
    ``chunks`` as one chunk of ``n`` synthetic frames through the batch
    runner's chunk path on ``mesh.device`` (``_ingest_params``,
    ``_device_qa``: the pinned upload, ``normalize_ingest``,
    ``qa_deterministic`` and ``_pack_outputs``; ``_Fetch``) → each chunk's
    (frames in its results, seconds)."""
    from mdx_torch.pipeline import batch_runner as BR

    dev = mesh.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    out = []
    for h, w, dtype, window in chunks:
        frames = _synthetic_frames(h, w, n, dtype)
        descs = None if dtype == "float32" else _synthetic_descs(dtype, n)
        t0 = _now(dev)
        params = None if descs is None else BR._ingest_params(descs, window)
        packed = BR._Fetch(BR._device_qa(frames, params, dev, window),
                           side).result()
        out.append((packed.shape[1], _now(dev) - t0))
    return out


def prime(
    shapes: Sequence[tuple[int, int]] = ((512, 512),),
    *,
    chunk: int = 64,
    dtypes: Iterable[str] = RAW_DTYPES + ("float32",),
    window_modes: Iterable[bool] = (False, True),
    single: bool = True,
    n_data: int | None = None,
    device="cuda",
    log: Callable[[str], None] = logger.info,
) -> int:
    """Build both libraries, then warm the product's standard device path:
    the single-image QA pass at each shape in this process, and one batch
    chunk of ``chunk`` frames per (shape, stored dtype, windowing mode) on
    every rank of the data axis ``d`` (``n_data``; None: every visible
    card, as ``--batch``) by :func:`prime_chunks`.  At d = 1 that runs in
    this process; at d > 1 it is one call on this process's rank pool, the
    one ``--batch`` then runs on, each rank running every chunk at the size
    of one of ``--batch``'s.  Each chunk is logged with the slowest rank's
    seconds, each shape's lines in JAX's order.  Returns JAX's count
    (builds not counted)."""
    from mdx_torch.core import qa
    from mdx_torch.parallel.mesh import SpatialMesh, data_axis

    dev = resolve_device(device)
    build_libraries(dev, log)
    d = data_axis(n_data, dev)
    dtypes, window_modes = tuple(dtypes), tuple(window_modes)
    todo = [(i, h, w, dtype, window) for i, (h, w) in enumerate(shapes)
            for dtype in dtypes for window in window_modes
            # float32 fallback frames are pre-windowed
            if not (dtype == "float32" and window)]
    steps = []    # (shape index, step, seconds), each shape's in JAX's order
    if single:
        for i, (h, w) in enumerate(shapes):
            # the single-image runner: qa_deterministic on [1, H, W]
            t0 = _now(dev)
            qa.qa_deterministic(torch.from_numpy(
                _synthetic_frames(h, w, 1, "float32")).to(dev))
            steps.append((i, "single-image QA pass", _now(dev) - t0))
    chunks = [c[1:] for c in todo]
    if d == 1:
        # one rank and no process group: prime_chunks reads the device
        ran = [prime_chunks(chunks, n=chunk,
                            mesh=SpatialMesh(0, 1, 1, dev, "gloo"))]
    else:
        from mdx_torch.parallel import pool

        ran = pool.get(d, dev).call(prime_chunks, [(chunks,)] * d, n=chunk)
    slowest = np.max([[s for _, s in r] for r in ran], axis=0)
    steps += [(i, f"chunk={chunk} dtype={dtype} window={window}", s)
              for (i, _, _, dtype, window), s in zip(todo, slowest)]
    for i, (h, w) in enumerate(shapes):
        mine = [(step, s) for j, step, s in steps if j == i]
        for step, s in mine:
            log(f"  [{h}x{w}] {step} in {s:.2f} s")
        log(f"[{h}x{w}] done in {sum(s for _, s in mine):.1f} s")
    return len(steps)


def _parse_shapes(s: str) -> list[tuple[int, int]]:
    out = []
    for part in s.split(","):
        hw = part.lower().split("x")
        out.append((int(hw[0]), int(hw[1] if len(hw) > 1 else hw[0])))
    return out


def main(argv: list[str] | None = None, device="cuda") -> int:
    """JAX's CLI on ``device`` (the card; the tests pass "cpu").  Without a
    card it prints ``ERROR: <reason>`` and returns 1, as the port's CLI
    does."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mdx_torch.pipeline.prime",
        description="Build the port's native libraries and warm the "
                    "product's standard device paths.")
    ap.add_argument("--shapes", default="512x512",
                    help="comma-separated HxW list (e.g. 512x512,1024x1024)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="batch chunk size to prime (runner default 64)")
    ap.add_argument("--dtypes", default="uint16,int16,uint8,float32")
    ap.add_argument("--window", choices=("off", "on", "both"),
                    default="both")
    ap.add_argument("--no-single", action="store_true",
                    help="skip the [1,H,W] single-image pass")
    ap.add_argument("--tuning", action="store_true",
                    help="also prime the tuning surface (autotune sweep "
                         "per issue set + GenAI tool functions)")
    ap.add_argument("--spatial", action="store_true",
                    help="also prime the huge-slice --spatial path on "
                         "this host's cards")
    ap.add_argument("--issues", default="noise+low_contrast,blur",
                    help="comma-separated issue sets for --tuning, "
                         "'+'-joined within a set")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        resolve_device(device)
    except RuntimeError as exc:
        print(f"ERROR: {exc}")
        return 1
    modes = {"off": (False,), "on": (True,), "both": (False, True)}
    shapes = _parse_shapes(args.shapes)
    n = prime(
        shapes,
        chunk=args.chunk,
        dtypes=tuple(t.strip() for t in args.dtypes.split(",") if t.strip()),
        window_modes=modes[args.window],
        single=not args.no_single,
        device=device,
    )
    if args.tuning:
        n += prime_tuning(
            shapes,
            issue_sets=tuple(
                tuple(i.strip() for i in part.split("+") if i.strip())
                for part in args.issues.split(",") if part.strip()),
            device=device,
        )
    if args.spatial:
        n += prime_spatial(shapes, device=device)
    logger.info("primed %d programs", n)
    return 0


if __name__ == "__main__":
    # run the importable module's main, so that the rank bodies a launch
    # or the rank pool pickles are mdx_torch.pipeline.prime's and not
    # __main__'s
    from mdx_torch.pipeline.prime import main as _main

    raise SystemExit(_main())
