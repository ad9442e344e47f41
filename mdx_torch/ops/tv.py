"""Batched total-variation denoise, Chambolle projection (PyTorch).

Counterpart of ``mdx/ops/tv.py`` (ref pipeline/enhancement.py:309-312,
skimage ``denoise_tv_chambolle``): dual ascent with step 1/(2·ndim), stop
per image when |E_prev − E| < eps·E_init or after ``max_iter`` iterations.

Both versions here return the per-image iteration counts beside the
pixels: the stop test reads float sums, so a new summation order can move
an image's stop by one iteration, and the counts show it.  Both sum the
energy terms in float64 and round once to float32, so their sums, and
with them the stops, agree although their summation orders differ.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels, telemetry
from mdx_torch.ops.filters import as_n

# (eps, max_iter) per TV mode: "ref" is the reference's semantics and the
# default; "fast" caps the iteration count (mdx/ops/tv.py TV_MODES).
TV_MODES: dict[str, tuple[float, int]] = {
    "ref": (2e-4, 200),
    "fast": (2e-4, 40),
}


def tv_mode_params(mode: str) -> tuple[float, int]:
    """(eps, max_iter) for a TV mode name; unknown names raise."""
    try:
        return TV_MODES[mode]
    except KeyError:
        raise ValueError(
            f"tv_mode={mode!r}: expected one of {sorted(TV_MODES)}") from None


def resolve_tv_mode(tv_mode: str | None = None) -> str:
    """The effective TV mode: the argument, or "ref" when it is None.
    Validates the name so a typo fails when the plan is built."""
    tv_mode = "ref" if tv_mode is None else tv_mode.strip().lower()
    tv_mode_params(tv_mode)
    return tv_mode


def tv_chambolle_plain(x: torch.Tensor, weight, eps: float = 2e-4,
                       max_iter: int = 200):
    """The plain PyTorch version of the TV kernel (``tv_chambolle_xla``).

    Returns (out [N,H,W], iterations [N] int32).  An image's count is 1
    (the initial step) plus the loop iterations in which it was active."""
    n, h, w = x.shape
    weight = as_n(weight, x, x.dtype)[:, None, None]
    size = float(h * w)
    tau = 0.25  # 1/(2·ndim), ndim = 2
    zrow = x.new_zeros((n, 1, w))
    zcol = x.new_zeros((n, h, 1))

    def _energy_and_out(p0, p1, first):
        if first:
            d = torch.zeros_like(x)
            out = x
        else:
            d = -(p0 + p1)
            d = d + torch.cat([zrow, p0[:, :-1, :]], dim=1)
            d = d + torch.cat([zcol, p1[:, :, :-1]], dim=2)
            out = x + d
        gy = torch.cat([out[:, 1:, :] - out[:, :-1, :], zrow], dim=1)
        gx = torch.cat([out[:, :, 1:] - out[:, :, :-1], zcol], dim=2)
        norm = torch.sqrt(gy * gy + gx * gx)
        e = ((d * d).sum(dim=(1, 2), dtype=torch.float64).to(x.dtype)
             + weight[:, 0, 0]
             * norm.sum(dim=(1, 2), dtype=torch.float64).to(x.dtype)) / size
        return out, gy, gx, norm, e

    def _update_p(p0, p1, gy, gx, norm, active):
        scale = norm * tau / weight + 1.0
        a = active[:, None, None]
        return (torch.where(a, (p0 - tau * gy) / scale, p0),
                torch.where(a, (p1 - tau * gx) / scale, p1))

    active = torch.ones(n, dtype=torch.bool, device=x.device)
    zero = torch.zeros_like(x)
    out, gy, gx, norm, e0 = _energy_and_out(zero, zero, first=True)
    p0, p1 = _update_p(zero, zero, gy, gx, norm, active)
    e_prev = e0
    iters = torch.ones(n, dtype=torch.int32, device=x.device)
    i = 1
    # host sync per iteration: the loop condition reads the device flags
    while i < max_iter:
        with telemetry.count_sync("tv.plain_flags"):
            if not bool(active.any()):
                break
        new_out, gy, gx, norm, e = _energy_and_out(p0, p1, first=False)
        out = torch.where(active[:, None, None], new_out, out)
        p0, p1 = _update_p(p0, p1, gy, gx, norm, active)
        iters = iters + active.to(torch.int32)
        still = (e_prev - e).abs() >= eps * e0
        active = active & still
        e_prev = torch.where(active, e, e_prev)
        i += 1
    return out, iters


def tv_chambolle(x: torch.Tensor, weight, eps: float = 2e-4,
                 max_iter: int = 200):
    """TV denoise with a per-image (or scalar) weight → (out, iterations):
    the TV kernel on a CUDA tensor, :func:`tv_chambolle_plain` on a CPU
    tensor."""
    if kernels.use_kernel(x):
        return kernels.tv_chambolle(x.contiguous(), as_n(weight, x),
                                    float(eps), int(max_iter))
    return tv_chambolle_plain(x, weight, eps, max_iter)
