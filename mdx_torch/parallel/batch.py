"""Data-parallel QA over the ``data`` axis — counterpart of
``mdx/parallel/batch.py``.

A series or directory of slices becomes one ``[N, H, W]`` stack split on N
over ``n_data`` ranks.  Every metric reduction of the QA steps is per image
and every guard only skips work (a per-image blend), so the ranks exchange
nothing: each runs the dense ``mdx_torch.core.qa`` step on its block of
images and the host concatenates the blocks.

N is padded to a multiple of the data axis as JAX pads it
(:func:`pad_batch`: the last slice replicated), so every rank gets an equal
block and the results cover the same padded N as JAX's.  The entry points
take a numpy ``[N, H, W]`` array and return numpy leaves over the padded N
with the valid count, in JAX's structure.

With ``n_data > 1`` an entry point makes one ``launch.run`` of ``n_data``
ranks (``n_space = 1``) whose bodies are :func:`deterministic_block`,
:func:`plan_block` and :func:`detect_block`; the launch's ``info()``, its
wall and each rank's compute are left in :data:`LAST_LAUNCH`.  With one rank
it runs in this process on ``device`` and makes no launch: a launch costs
seconds of rank start-up, and JAX's mesh of one device costs nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mdx_torch.core import qa
from mdx_torch.core.enhance import PlanDynamic, PlanStatic
from mdx_torch.parallel import launch
from mdx_torch.parallel.mesh import data_axis, divisible_batch

# the last sharded call's launch: ``Launched.info()`` plus ``wall_ms`` (the
# launch until its results are on the host) and ``rank_ms`` (each rank's
# compute); empty after a call that ran in this process
LAST_LAUNCH: dict = {}

DETERMINISTIC_FIELDS = ("enhanced", "stats", "issues", "flags", "validation",
                        "score")
PLAN_FIELDS = ("enhanced", "flags", "validation", "score")
DETECT_FIELDS = ("stats", "issues")


def pad_batch(x, n_data: int):
    """Pad ``x`` [N, H, W] (numpy or a tensor) on N up to a multiple of
    ``n_data`` → (padded, N).  The padding replicates the last slice, so
    padded lanes do the same work as a real one and are dropped on the way
    out (``mdx/parallel/batch.py:28-41``)."""
    n = x.shape[0]
    target = divisible_batch(n, n_data)
    if target != n:
        extra = (target - n,) + tuple(x.shape[1:])
        if torch.is_tensor(x):
            x = torch.cat([x, x[-1:].expand(extra)])
        else:
            x = np.concatenate([x, np.broadcast_to(x[-1:], extra)])
    return x, n


def _timed(fields, fn, xb: torch.Tensor, *args) -> dict:
    """``fn``'s return tuple as a dict of ``fields``, with this rank's
    compute in ms under ``rank_ms`` ([1] float64, so that the ranks'
    values concatenate into one per rank)."""
    def sync():
        if xb.is_cuda:
            torch.cuda.synchronize(xb.device)

    sync()
    t0 = time.perf_counter()
    out = dict(zip(fields, fn(xb, *args)))
    sync()
    out["rank_ms"] = torch.tensor([(time.perf_counter() - t0) * 1e3],
                                  dtype=torch.float64)
    return out


def deterministic_block(xb: torch.Tensor, *, mesh) -> dict:
    """Rank body of :func:`qa_deterministic_sharded`: the dense step on
    this rank's images."""
    return _timed(DETERMINISTIC_FIELDS, qa.qa_deterministic, xb)


def plan_block(xb: torch.Tensor, static: PlanStatic, dyn: PlanDynamic, *,
               mesh) -> dict:
    """Rank body of :func:`qa_plan_sharded`; per-image fields of ``dyn``
    ([N_pad] tensors) are cut to this rank's images."""
    if mesh is not None and mesh.n_data > 1:
        nd, i = xb.shape[0], mesh.data_index
        dyn = type(dyn)(*(v[i * nd:(i + 1) * nd]
                          if _per_image(v, nd * mesh.n_data) else v
                          for v in dyn))
    return _timed(PLAN_FIELDS, qa.qa_plan, xb, static, dyn)


def detect_block(xb: torch.Tensor, *, mesh) -> dict:
    """Rank body of :func:`detect_sharded`."""
    return _timed(DETECT_FIELDS, qa.detect, xb)


def _per_image(v, n: int) -> bool:
    return torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == n > 1


def _sharded(body, x, args: tuple, n_data, device) -> tuple[dict, int]:
    """Pad ``x``, run ``body`` on the data axis (module doc) → (its fields
    over the padded N as numpy, the valid count)."""
    from mdx_torch.pipeline.runner import resolve_device

    dev = resolve_device(device)
    d = data_axis(n_data, dev)
    xp, n_valid = pad_batch(np.asarray(x, np.float32), d)
    args = tuple(type(a)(*(pad_batch(v, d)[0] if _per_image(v, n_valid)
                           else v for v in a))
                 if isinstance(a, PlanDynamic) else a for a in args)
    LAST_LAUNCH.clear()
    if d == 1:
        out = launch.to_numpy(body(torch.from_numpy(xp).to(dev),
                                   *launch._to_device(args, dev), mesh=None))
        out.pop("rank_ms")
        return out, n_valid
    t0 = time.perf_counter()
    launched = launch.run(body, xp, *args, n_space=1, n_data=d,
                          device=dev.type)
    out = launch.assemble(launched.results, d, 1, block_keys=())
    LAST_LAUNCH.update(launched.info(),
                       wall_ms=(time.perf_counter() - t0) * 1e3,
                       rank_ms=out.pop("rank_ms").tolist())
    return out, n_valid


def qa_deterministic_sharded(x, n_data: int | None = None, device="cuda"):
    """Sharded deterministic QA (detect → enhance → validate → score) of
    ``x`` [N, H, W] on ``n_data`` ranks (None: every visible card on the
    card, 1 on the CPU) → (``qa_deterministic``'s tuple over the padded N,
    N)."""
    out, n_valid = _sharded(deterministic_block, x, (), n_data, device)
    return tuple(out[k] for k in DETERMINISTIC_FIELDS), n_valid


def qa_plan_sharded(x, static: PlanStatic, dyn: PlanDynamic,
                    n_data: int | None = None, device="cuda"):
    """Sharded plan-driven tuning iteration → (``qa_plan``'s tuple over the
    padded N, N).  A per-image field of ``dyn`` ([N] or [N_pad]) is padded
    as ``x`` is and split with it."""
    out, n_valid = _sharded(plan_block, x, (static, dyn), n_data, device)
    return tuple(out[k] for k in PLAN_FIELDS), n_valid


def detect_sharded(x, n_data: int | None = None, device="cuda"):
    """Sharded 16-metric pass and issue masks → (stats, issues, N)."""
    out, n_valid = _sharded(detect_block, x, (), n_data, device)
    return out["stats"], out["issues"], n_valid
