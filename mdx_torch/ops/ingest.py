"""Device-side DICOM frame normalisation — raw integers in, [0,1] out.

Counterpart of ``mdx/ops/ingest.py``: modality rescale → optional VOI
window → MONOCHROME1 inversion → min-max normalisation (ref
pipeline/dicom_io.py:29-91, PS3.3 C.11.2.1.2) over the RAW integer stack
plus a few per-frame float32 scalars, so only the stored bytes (uint8,
int16 or uint16) go to the card.  Every step runs in the JAX package's
float32 op order; the rescale is a rounded multiply then a rounded add,
where XLA may fuse it into one FMA (≤1 ulp).

The per-frame scalars that the host derives from whole-stack reductions
(the MONO1 inversion pivot ``gmax``, the windowless bounds ``nlo``/``nhi``)
are the caller's, as in the JAX package's batch runner.
"""

from __future__ import annotations

import torch


def _col(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(-1)[:, None, None]


def normalize_ingest(
    raw: torch.Tensor,
    slope,
    intercept,
    mono1,
    gmax,
    use_window,
    wlo,
    wden,
    nlo,
    nhi,
    *,
    per_frame_minmax: bool,
) -> torch.Tensor:
    """Raw integer [N,H,W] + per-frame [N] scalars → float32 [0,1] frames.

    ``per_frame_minmax`` selects the non-window batch contract (each frame
    min-max normalised on its own) against the windowed contract (the
    stored window where ``use_window``, else the stack-global bounds
    ``nlo``/``nhi``)."""
    if raw.dtype not in (torch.uint8, torch.int16, torch.uint16):
        raise ValueError(f"normalize_ingest: expected uint8, int16 or "
                         f"uint16 frames, got {raw.dtype}")
    v = raw.to(torch.float32) * _col(slope, raw) + _col(intercept, raw)
    inv = _col(mono1, raw) > 0

    # MONO1 inverts about the stack max before the min-max
    z = torch.where(inv, _col(gmax, raw) - v, v)
    if per_frame_minmax:
        zlo = torch.amin(z, dim=(1, 2), keepdim=True)
        zhi = torch.amax(z, dim=(1, 2), keepdim=True)
    else:
        zlo, zhi = _col(nlo, raw), _col(nhi, raw)
    rng = zhi - zlo
    flat = rng < 1e-8
    nout = torch.where(flat, 0.0, (z - zlo) / torch.where(flat, 1.0, rng))

    if per_frame_minmax:
        return nout

    # windowed branch: linear VOI, then 1 - x for MONO1
    w = torch.clamp((v - _col(wlo, raw)) / _col(wden, raw), 0.0, 1.0)
    w = torch.where(inv, 1.0 - w, w)
    return torch.where(_col(use_window, raw) > 0, w, nout)
