"""Wrappers of the hand-written CUDA kernels (``mdx_torch/csrc/*.cu``).

Each wrapper takes CUDA float32 tensors, checks device, dtype, contiguity
and shape (and raises on anything else), allocates its outputs and scratch
with ``torch.empty``, launches on the current stream and raises if the
launch reports a CUDA error.  There is no fallback: the op modules call a
wrapper only for a CUDA tensor (:func:`use_kernel`) and run the plain
PyTorch version for a CPU tensor.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it, so a
run can show that the main path went through the kernels.  The library is
built and loaded on the first call (:func:`library`), never at import.
"""

from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {"box_stats": 0, "unsharp": 0, "clahe": 0,
                            "tv_chambolle": 0, "bilateral": 0}

_lib = None


def library():
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    if _lib is None:
        from mdx_torch.kernels import _build

        _lib = _build.load()
    return _lib


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"mdx_torch runs on cuda or cpu tensors, got {x.device}")


def _check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32,
           device=None) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a CUDA tensor on "
                         f"{device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _image(x: torch.Tensor) -> tuple[int, int, int]:
    if x.ndim != 3:
        raise ValueError(f"x: expected [N, H, W], got shape {tuple(x.shape)}")
    _check(x, "x", x.shape)
    n, h, w = x.shape
    if min(n, h, w) < 1:
        raise ValueError(f"x: empty shape {tuple(x.shape)}")
    return n, h, w


def _ok(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# pixels of each map per block of box stats' reduction passes
_BOX_CHUNK = 4096


def box_stats(x: torch.Tensor):
    """(std(sqrt(lv7)), mean(lv16), std(lv16)) per image of [N,H,W] —
    see ``csrc/box_stats.cu``; plain version
    ``mdx_torch.core.metrics._lv_box_stats_plain``."""
    n, h, w = _image(x)
    nchunk = -(-h * w // _BOX_CHUNK)
    lib = library()
    with torch.cuda.device(x.device):
        lv7s = torch.empty_like(x)
        lv16 = torch.empty_like(x)
        partials = torch.empty((n, nchunk, 2), dtype=torch.float64,
                               device=x.device)
        means = torch.empty((n, 2), dtype=torch.float32, device=x.device)
        out = torch.empty((n, 3), dtype=torch.float32, device=x.device)
        _ok(lib.mdx_box_stats(x.data_ptr(), lv7s.data_ptr(), lv16.data_ptr(),
                              partials.data_ptr(), means.data_ptr(),
                              out.data_ptr(), n, h, w, nchunk, _stream()),
            "box_stats")
    LAUNCHES["box_stats"] += 1
    return out[:, 0], out[:, 1], out[:, 2]


def unsharp(x: torch.Tensor, radius: torch.Tensor,
            amount: torch.Tensor) -> torch.Tensor:
    """clip(x + (x − gaussian(x, radius))·amount, 0, 1) with per-image
    ``radius`` and ``amount`` [N] — see ``csrc/unsharp.cu``; plain version
    ``mdx_torch.ops.filters.unsharp_mask_plain``."""
    from mdx_torch.ops.filters import _GAUSS_MAX_RADIUS, _gauss_taps

    n, h, w = _image(x)
    _check(radius, "radius", (n,), device=x.device)
    _check(amount, "amount", (n,), device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        taps = _gauss_taps(radius, torch.float32).contiguous()
        _check(taps, "taps", (n, 2 * _GAUSS_MAX_RADIUS + 1))
        out = torch.empty_like(x)
        _ok(lib.mdx_unsharp(x.data_ptr(), taps.data_ptr(), amount.data_ptr(),
                            out.data_ptr(), n, h, w, _stream()), "unsharp")
    LAUNCHES["unsharp"] += 1
    return out


def clahe(x: torch.Tensor, clip_limit: torch.Tensor, tile_size: int = 16,
          nbins: int = 256) -> torch.Tensor:
    """CLAHE of [N,H,W] with per-image ``clip_limit`` [N] — see
    ``csrc/clahe.cu``; plain version ``mdx_torch.ops.clahe.clahe_plain``.
    The kernel takes 256 bins."""
    n, h, w = _image(x)
    _check(clip_limit, "clip_limit", (n,), device=x.device)
    t = int(tile_size)
    if nbins != 256:
        raise ValueError(f"clahe kernel: nbins must be 256, got {nbins}")
    if t < 1:
        raise ValueError(f"clahe kernel: tile size must be ≥ 1, got {t}")
    gy, gx = -(-h // t), -(-w // t)
    lib = library()
    with torch.cuda.device(x.device):
        lut = torch.empty((n, gy, gx, nbins), dtype=torch.float32,
                          device=x.device)
        out = torch.empty_like(x)
        _ok(lib.mdx_clahe(x.data_ptr(), clip_limit.data_ptr(), lut.data_ptr(),
                          out.data_ptr(), n, h, w, t, _stream()), "clahe")
    LAUNCHES["clahe"] += 1
    return out


# iterations between the host's reads of the per-image active flags
_TV_CHECK_EVERY = 8


def tv_chambolle(x: torch.Tensor, weight: torch.Tensor, eps: float = 2e-4,
                 max_iter: int = 200):
    """Chambolle TV denoise of [N,H,W] with per-image ``weight`` [N] →
    (out, iterations [N] int32) — see ``csrc/tv.cu``; plain version
    ``mdx_torch.ops.tv.tv_chambolle_plain``.

    One launch pair per iteration; images that have stopped skip their
    blocks, and the host reads the active flags every few iterations."""
    n, h, w = _image(x)
    _check(weight, "weight", (n,), device=x.device)
    lib = library()
    dev = x.device
    with torch.cuda.device(dev):
        p_cur = torch.zeros((n, 2, h, w), dtype=torch.float32, device=dev)
        p_next = torch.empty_like(p_cur)
        out = torch.empty_like(x)
        nblk = -(-w // 32) * -(-h // 32)
        partials = torch.empty((n, nblk, 2), dtype=torch.float64, device=dev)
        e0 = torch.empty(n, dtype=torch.float32, device=dev)
        e_prev = torch.empty_like(e0)
        active = torch.ones(n, dtype=torch.int32, device=dev)
        iters = torch.zeros(n, dtype=torch.int32, device=dev)
        stream = _stream()
        for i in range(max(int(max_iter), 1)):
            if i and i % _TV_CHECK_EVERY == 0 and not bool(active.any()):
                break
            _ok(lib.mdx_tv_iteration(
                x.data_ptr(), p_cur.data_ptr(), p_next.data_ptr(),
                out.data_ptr(), partials.data_ptr(), weight.data_ptr(),
                e0.data_ptr(), e_prev.data_ptr(), active.data_ptr(),
                iters.data_ptr(), n, h, w, int(i == 0), float(eps), stream),
                "tv_chambolle")
            p_cur, p_next = p_next, p_cur
    LAUNCHES["tv_chambolle"] += 1
    return out, iters


def bilateral(x: torch.Tensor, d: int, sigma_color: torch.Tensor,
              sigma_space: torch.Tensor) -> torch.Tensor:
    """d x d bilateral of [N,H,W] on a reflect pad with per-image
    ``sigma_color`` and ``sigma_space`` [N]; ``d`` odd, 1 to 9 — see
    ``csrc/bilateral.cu``; plain version
    ``mdx_torch.ops.bilateral.bilateral_plain``."""
    n, h, w = _image(x)
    _check(sigma_color, "sigma_color", (n,), device=x.device)
    _check(sigma_space, "sigma_space", (n,), device=x.device)
    d = int(d)
    if d < 1 or d > 9 or d % 2 == 0:
        raise ValueError(f"bilateral kernel: d must be odd, 1 to 9, got {d}")
    lib = library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        _ok(lib.mdx_bilateral(x.data_ptr(), sigma_color.data_ptr(),
                              sigma_space.data_ptr(), out.data_ptr(), n, h, w,
                              d, _stream()), "bilateral")
    LAUNCHES["bilateral"] += 1
    return out
