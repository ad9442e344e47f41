"""Least time the card could take for a hand-kernel call.

Frozen copy of ``chip_smoke.py`` ``_bound``, ``OPS_PER_PIXEL``,
``HBM_BYTES_PER_S`` and ``F32_OPS_PER_S`` at commit 3b08b1a: the larger of
the bytes moved (each input read once, each output written once) over the
memory rate and the float32 operations over the peak outside the tensor
cores, from NVIDIA's H100 SXM data sheet at its 700 W limit.  Operations
per pixel, counted from each kernel's arithmetic: box stats 7 x 7 and
16 x 16 sums of x and x^2 both ways, scales, variances, sqrt and two
reduction passes; unsharp 25-tap rows and columns and the combine; CLAHE
the bin index, the clipped LUT per bin and the 4-LUT blend; wavelet
denoise over all levels: analysis, band squares and sums, soft shrink,
synthesis; TV per pixel and iteration.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_PIXEL = {"box_stats": 130, "unsharp": 103, "clahe": 47,
                 "tv_chambolle": 23, "wavelet_denoise": 22}
# the kernel wrappers of mdx_torch.kernels whose calls have a bound here
KERNELS = ("box_stats", "unsharp", "clahe", "tv_chambolle", "bilateral",
           "wavelet_denoise")


def bound_ms(torch, name: str, args, result) -> float:
    """Least ms for ``kernels.<name>(*args)`` that returned ``result``."""
    n, h, w = args[0].shape
    px = n * h * w
    moved = sum(a.numel() * a.element_size() for a in args
                if torch.is_tensor(a))
    if name == "box_stats":
        moved += 3 * 4 * n
    else:
        moved += 4 * px + (4 * n if name == "tv_chambolle" else 0)
    if name == "bilateral":
        # (d^2 + 1) / 2 weights a pixel at 5 operations, 3 a tap, 2 more
        d2 = args[1] ** 2
        ops = px * (5 * (d2 + 1) // 2 + 3 * d2 + 2)
    elif name == "tv_chambolle":
        ops = h * w * int(result[1].sum()) * OPS_PER_PIXEL[name]
    else:
        ops = px * OPS_PER_PIXEL[name]
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
