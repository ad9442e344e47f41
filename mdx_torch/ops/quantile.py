"""Exact per-image order statistics and percentiles (PyTorch).

Counterpart of ``mdx/ops/quantile.py``.  The TPU package finds order
statistics by a bitwise binary search because a sort is slow there; on the
GPU (and the CPU) ``torch.sort`` is the direct route and gives the same
exact order statistics.  The interpolation plan (:func:`_plan`) and the
NumPy 'linear' blend (:func:`_interpolate`) are ported as they are, so the
results are bit-equal to the JAX package's.  Inputs must be NaN-free.
"""

from __future__ import annotations

import torch


def _plan(qs, m: int):
    """Interpolation plan for NumPy's 'linear' rule over m elements:
    deduped 1-indexed LOWER ranks + per-q (rank_idx, frac)."""
    need: dict[int, int] = {}
    plan = []
    for q in qs:
        pos = float(q) / 100.0 * (m - 1)
        k = min(int(pos), m - 1)
        frac = pos - k
        lo = k + 1
        if lo not in need:
            need[lo] = len(need)
        plan.append((need[lo], frac))
    return tuple(need), plan


def _interpolate(os_: torch.Tensor, succ: torch.Tensor, plan) -> torch.Tensor:
    out = [os_[:, i] * (1.0 - f) + succ[:, i] * f if f else os_[:, i]
           for i, f in plan]
    return torch.stack(out, 0)


def percentiles_exact(x: torch.Tensor, qs) -> torch.Tensor:
    """Per-image percentiles (NumPy 'linear' rule) of [N, ...] → [len(qs), N]."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    m = flat.shape[1]
    ranks, plan = _plan(qs, m)
    srt = torch.sort(flat, dim=-1).values
    lo = torch.tensor(ranks, device=x.device) - 1              # 0-indexed
    os_ = srt[:, lo]
    succ = srt[:, torch.clamp(lo + 1, max=m - 1)]
    return _interpolate(os_, succ, plan)


def median_rows(flat: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of [N, M] → [N]."""
    return percentiles_exact(flat, [50.0])[0]
