"""Batched fixed-bin histograms and entropies (PyTorch).

Counterpart of ``mdx/ops/hist.py``.  Histogram semantics match
``numpy.histogram(range=(0, hi))``: ``bins`` equal-width buckets, right-most
edge inclusive.  The bin rule (floor-multiply plus the one-step boundary
fixup) is ported as it is; the counts come from ``bincount``, exact
integers on either device.
"""

from __future__ import annotations

import torch


def bin_indices(x: torch.Tensor, bins: int,
                hi: torch.Tensor | None = None) -> torch.Tensor:
    """Exact numpy-semantics bin index per value: [N, P] → [N, P] int64.

    Bit-equivalent to comparing against edges ``(k / bins) * hi``: the
    floor-multiply index is fixed up with two compares against the same
    edge expressions (``mdx.ops.hist.bin_indices``)."""
    if hi is None:
        idx = torch.floor(x * float(bins))
        idxf = torch.clamp(idx, 0.0, bins - 1.0)
        e_lo = idxf / bins
        e_hi = (idxf + 1.0) / bins
    else:
        hi_s = torch.clamp_min(hi, 1e-30).to(torch.float32)
        if hi_s.ndim:
            hi_s = hi_s[:, None]
        idx = torch.floor(x * (float(bins) / hi_s))
        idxf = torch.clamp(idx, 0.0, bins - 1.0)
        e_lo = (idxf / bins) * hi_s
        e_hi = ((idxf + 1.0) / bins) * hi_s
    i = idxf - (x < e_lo).to(torch.float32) + (x >= e_hi).to(torch.float32)
    return torch.clamp(i, 0.0, bins - 1.0).to(torch.int64)


def counts_from_indices(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """[N, P] bin indices → [N, bins] float32 counts."""
    n = idx.shape[0]
    offs = torch.arange(n, device=idx.device)[:, None] * bins
    c = torch.bincount((idx + offs).reshape(-1), minlength=n * bins)
    return c.reshape(n, bins).to(torch.float32)


def histogram01(x: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-image histogram of [N,H,W] values over [0, 1] → [N, bins]."""
    v = x.reshape(x.shape[0], -1)
    return counts_from_indices(bin_indices(v, bins), bins)


def histogram_scaled(x: torch.Tensor, bins: int, hi: torch.Tensor) -> torch.Tensor:
    """Per-image histogram over [0, hi_i] with per-image upper edge [N]."""
    v = x.reshape(x.shape[0], -1)
    return counts_from_indices(bin_indices(v, bins, hi), bins)


def entropy_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (bits) per image from [N, bins] counts, zero bins
    excluded (ref pipeline/metrics.py:112-117)."""
    total = hist.sum(dim=-1, keepdim=True)
    p = hist / torch.clamp_min(total, 1.0)
    logp = torch.where(p > 0, torch.log2(torch.clamp_min(p, 1e-30)), 0.0)
    return -(p * logp).sum(dim=-1)
