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
                            "tv_chambolle": 0, "bilateral": 0,
                            "wavelet_denoise": 0, "clahe_remap_ext": 0,
                            "tv_shard_step": 0}

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


def box_stats(x: torch.Tensor):
    """(std(sqrt(lv7)), mean(lv16), std(lv16)) per image of [N,H,W] —
    see ``csrc/box_stats.cu``; plain version
    ``mdx_torch.core.metrics._lv_box_stats_plain``.  Two launches; no
    image-sized scratch (four float64 sums per 32 x 32 tile)."""
    n, h, w = _image(x)
    nblk = -(-h // 32) * -(-w // 32)
    lib = library()
    with torch.cuda.device(x.device):
        partials = torch.empty((n, nblk, 4), dtype=torch.float64,
                               device=x.device)
        out = torch.empty((n, 3), dtype=torch.float32, device=x.device)
        _ok(lib.mdx_box_stats(x.data_ptr(), partials.data_ptr(),
                              out.data_ptr(), n, h, w, _stream()),
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


def clahe_luts(x: torch.Tensor, clip_limit: torch.Tensor,
               tile_size: int) -> torch.Tensor:
    """The per-tile LUTs of [N,H,W] → [N, ceil(H/t), ceil(W/t), 256]: kernel
    C's LUT stage alone (``csrc/clahe.cu`` ``mdx_clahe_luts``), for the
    local LUTs of the sharded CLAHE; counted as a launch of ``clahe``.
    Plain version ``mdx_torch.ops.clahe.clahe_luts_plain``."""
    n, h, w = _image(x)
    _check(clip_limit, "clip_limit", (n,), device=x.device)
    t = int(tile_size)
    if t < 1:
        raise ValueError(f"clahe kernel: tile size must be ≥ 1, got {t}")
    lib = library()
    with torch.cuda.device(x.device):
        lut = torch.empty((n, -(-h // t), -(-w // t), 256),
                          dtype=torch.float32, device=x.device)
        _ok(lib.mdx_clahe_luts(x.data_ptr(), clip_limit.data_ptr(),
                               lut.data_ptr(), n, h, w, t, _stream()),
            "clahe_luts")
    LAUNCHES["clahe"] += 1
    return lut


def clahe_remap_ext(x: torch.Tensor, lut_ext: torch.Tensor,
                    tile_size: int) -> torch.Tensor:
    """Bilinear CLAHE remap of a row block x [N,H,W] (clipped to [0,1])
    against its halo-extended LUT grid [N, ceil(H/t)+2, ceil(W/t)+2, 256]
    (TPU kernel 11) — see ``csrc/clahe.cu``; plain version
    ``mdx_torch.parallel.clahe_sp.remap_ext_plain``."""
    n, h, w = _image(x)
    t = int(tile_size)
    if t < 1:
        raise ValueError(f"clahe kernel: tile size must be ≥ 1, got {t}")
    _check(lut_ext, "lut_ext", (n, -(-h // t) + 2, -(-w // t) + 2, 256),
           device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        _ok(lib.mdx_clahe_remap_ext(x.data_ptr(), lut_ext.data_ptr(),
                                    out.data_ptr(), n, h, w, t, _stream()),
            "clahe_remap_ext")
    LAUNCHES["clahe_remap_ext"] += 1
    return out


# iterations between the host's reads of the per-image active flags
_TV_CHECK_EVERY = 16
# the schedule of the last tv_chambolle call: iterations a launch, step
# launches, host reads of the active flags
TV_LAST_SOLVE: dict[str, int] = {}


def tv_steps() -> int:
    """The iterations one launch of kernel T runs in shared memory: the
    constant ``TV_S`` of ``csrc/tv.cu``."""
    return library().mdx_tv_blocked_steps()


def tv_chambolle(x: torch.Tensor, weight: torch.Tensor, eps: float = 2e-4,
                 max_iter: int = 200):
    """Chambolle TV denoise of [N,H,W] with per-image ``weight`` [N] →
    (out, iterations [N] int32) — see ``csrc/tv.cu``; plain version
    ``mdx_torch.ops.tv.tv_chambolle_plain``.

    Each launch runs :func:`tv_steps` iterations on 64 x 64 windows in
    shared memory and reads the dual from one buffer of a ping-pong pair,
    writing the other; stopped images skip their blocks and keep their last
    launch's input dual, from which one launch after the loop rebuilds their
    output.  The host reads the active flags every ``_TV_CHECK_EVERY``
    iterations."""
    n, h, w = _image(x)
    _check(weight, "weight", (n,), device=x.device)
    max_iter = max(int(max_iter), 1)
    lib = library()
    s = lib.mdx_tv_blocked_steps()
    tile = 64 - 2 * s
    dev = x.device
    with torch.cuda.device(dev):
        bufs = (torch.empty((n, 2, h, w), dtype=torch.float32, device=dev),
                torch.empty((n, 2, h, w), dtype=torch.float32, device=dev))
        out = torch.empty_like(x)
        nblk = -(-h // tile) * -(-w // tile)
        partials = torch.empty((n, nblk, s, 2), dtype=torch.float64,
                               device=dev)
        e0 = torch.empty(n, dtype=torch.float32, device=dev)
        e_prev = torch.empty_like(e0)
        active = torch.ones(n, dtype=torch.int32, device=dev)
        iters = torch.zeros(n, dtype=torch.int32, device=dev)
        base = torch.zeros(n, dtype=torch.int32, device=dev)
        stream = _stream()
        a = launches = reads = 0
        while a < max_iter:
            if a and a % _TV_CHECK_EVERY == 0:
                reads += 1
                if not bool(active.any()):
                    break
            m = min(s, max_iter - a)
            _ok(lib.mdx_tv_blocked_step(
                x.data_ptr(), bufs[launches % 2].data_ptr(),
                bufs[(launches + 1) % 2].data_ptr(), partials.data_ptr(),
                weight.data_ptr(), e0.data_ptr(), e_prev.data_ptr(),
                active.data_ptr(), iters.data_ptr(), base.data_ptr(), n, h,
                w, a, m, float(eps), stream), "tv_chambolle")
            a += m
            launches += 1
        _ok(lib.mdx_tv_blocked_rebuild(
            x.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            iters.data_ptr(), base.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n, h, w, stream), "tv_chambolle")
    LAUNCHES["tv_chambolle"] += 1
    TV_LAST_SOLVE.update(steps=s, launches=launches, host_reads=reads)
    return out, iters


_SLAB_NAMES = ("up", "dn", "lf", "rt")


def _slab_ptrs(slabs, name: str, n: int, planes: int, h: int, w: int,
               hw: int, device) -> list:
    """Checked pointers of a slab set ``(up, dn, lf, rt)`` of an array of
    ``planes`` planes an image (None, or None members, for zeros): up and
    dn [n, planes, hw, w], lf and rt [n, planes, h + 2 hw, hw]."""
    if slabs is None:
        return [None] * 4
    if len(slabs) != 4:
        raise ValueError(f"{name}: expected (up, dn, lf, rt), got "
                         f"{len(slabs)} slabs")
    shapes = ((n, planes, hw, w),) * 2 + ((n, planes, h + 2 * hw, hw),) * 2
    ptrs = []
    for t, side, shape in zip(slabs, _SLAB_NAMES, shapes):
        if t is not None:
            _check(t, f"{name}.{side}", shape, device=device)
        ptrs.append(None if t is None else t.data_ptr())
    return ptrs


def _shard_geo(x: torch.Tensor, geo, m: int) -> tuple:
    """Checked ``(gh, gw, row0, col0, hw)`` of a block x [n, h, w] and a
    launch of ``m`` steps: ``1 <= m <= hw <= tv_steps()`` (the slabs are
    ``hw`` wide, and ``m`` iterations need ``m`` of them)."""
    _, h, w = x.shape
    gh, gw, row0, col0, hw = (int(v) for v in geo)
    s = tv_steps()
    if not (0 <= row0 and row0 + h <= gh and 0 <= col0 and col0 + w <= gw):
        raise ValueError(f"block {h}x{w} at ({row0}, {col0}) outside the "
                         f"{gh}x{gw} image")
    if not 1 <= m <= hw <= s:
        raise ValueError(f"tv shard kernel: {m} iterations need a halo of "
                         f"at least {m} and at most {s}, got {hw}")
    return gh, gw, row0, col0, hw


def tv_shard_step(x: torch.Tensor, p_in: torch.Tensor | None,
                  p_out: torch.Tensor, active: torch.Tensor,
                  weight: torch.Tensor, x_slabs, p_slabs, geo,
                  m: int) -> torch.Tensor:
    """One launch of kernel 12 (TPU kernel 12, the sharded TV step): ``m``
    Chambolle iterations on a row block or tile x [N,H,W] of a larger
    image, from the dual ``p_in`` [N,2,H,W] (None at the first iteration:
    p = 0), writing the active images' dual after them into ``p_out``.
    ``geo`` = (image height, image width, the block's first row, first
    column, halo width hw); ``x_slabs`` and ``p_slabs`` = (up, dn, lf, rt)
    halo slabs of x and of ``p_in`` from the neighbouring blocks (up, dn
    [N,C,hw,W]; lf, rt [N,C,H+2hw,hw], the columns of the row-extended
    block; each None for zeros at the image's edge; C = 1 for x, 2 for p),
    with ``m <= hw``.  ``active`` [N] int32, ``weight`` [N].  Returns the
    block's (Σd², Σ|∇out|) of each iteration [N,m,2] float64, zeros for
    stopped images — see ``csrc/tv.cu``; plain version
    ``mdx_torch.parallel.tv_sp.tv_shard_step_plain``."""
    n, h, w = _image(x)
    dev = x.device
    hw = int(geo[4])
    if p_in is not None:
        _check(p_in, "p_in", (n, 2, h, w), device=dev)
    _check(p_out, "p_out", (n, 2, h, w), device=dev)
    _check(active, "active", (n,), dtype=torch.int32, device=dev)
    _check(weight, "weight", (n,), device=dev)
    xs = _slab_ptrs(x_slabs, "x_slabs", n, 1, h, w, hw, dev)
    ps = _slab_ptrs(None if p_in is None else p_slabs, "p_slabs", n, 2, h,
                    w, hw, dev)
    m = int(m)
    gh, gw, row0, col0, hw = _shard_geo(x, geo, m)
    lib = library()
    s = lib.mdx_tv_blocked_steps()
    tile = 64 - 2 * s
    with torch.cuda.device(dev):
        partials = torch.empty((n, -(-h // tile) * -(-w // tile), s, 2),
                               dtype=torch.float64, device=dev)
        sums = torch.zeros((n, m, 2), dtype=torch.float64, device=dev)
        _ok(lib.mdx_tv_shard_blocked_step(
            x.data_ptr(), None if p_in is None else p_in.data_ptr(),
            p_out.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            active.data_ptr(), weight.data_ptr(), *xs, *ps, n, h, w, gh, gw,
            row0, col0, hw, m, _stream()), "tv_shard_step")
    LAUNCHES["tv_shard_step"] += 1
    return sums


def tv_shard_finalize(sums: torch.Tensor, weight: torch.Tensor,
                      e0: torch.Tensor, e_prev: torch.Tensor,
                      active: torch.Tensor, iters: torch.Tensor,
                      base: torch.Tensor, a: int, eps: float,
                      size: float) -> None:
    """The stop rule over one launch of kernel 12, in place on ``e0``,
    ``e_prev``, ``active``, ``iters`` and ``base``: the global sums [N,m,2]
    float64 (the blocks' :func:`tv_shard_step` sums added over the tile
    group) walked from iteration ``a`` as kernel T's finalize walks its
    launch; every image active at the start gets ``base = a``.  ``size``
    is the image's H·W.  Part of kernel 12's launch, counted with
    :func:`tv_shard_step`.  Plain version
    ``mdx_torch.parallel.tv_sp.tv_shard_finalize_plain``."""
    if sums.ndim != 3:
        raise ValueError(f"sums: expected [N, m, 2], got {tuple(sums.shape)}")
    n, m = sums.shape[:2]
    dev = sums.device
    _check(sums, "sums", (n, m, 2), dtype=torch.float64)
    for t, name in ((weight, "weight"), (e0, "e0"), (e_prev, "e_prev")):
        _check(t, name, (n,), device=dev)
    for t, name in ((active, "active"), (iters, "iters"), (base, "base")):
        _check(t, name, (n,), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        _ok(lib.mdx_tv_shard_blocked_finalize(
            sums.data_ptr(), weight.data_ptr(), e0.data_ptr(),
            e_prev.data_ptr(), active.data_ptr(), iters.data_ptr(),
            base.data_ptr(), n, int(a), m, float(eps), float(size),
            _stream()), "tv_shard_finalize")


def tv_shard_rebuild(x: torch.Tensor, p_even: torch.Tensor,
                     p_odd: torch.Tensor, iters: torch.Tensor,
                     base: torch.Tensor, weight: torch.Tensor, x_slabs,
                     slabs_even, slabs_odd, geo, ms: int) -> torch.Tensor:
    """Kernel 12's output after its loop: out [N,H,W] = x + div p_{t-1} of
    the block from each image's count t (``iters``) and the first iteration
    a of its last launch (``base``): p_a is ``p_even`` with its slabs
    ``slabs_even`` where a / ``ms`` is even (``ms``: the iterations of a
    full launch), ``p_odd`` with ``slabs_odd`` where it is odd, zeros at
    a = 0; t − 1 − a < ``ms`` iterations from it, then the divergence.
    ``geo`` and ``x_slabs`` as for :func:`tv_shard_step`.  Counted as a
    launch of ``tv_shard_step`` — see ``csrc/tv.cu``; plain version
    ``mdx_torch.parallel.tv_sp.tv_shard_rebuild_plain``."""
    n, h, w = _image(x)
    dev = x.device
    hw = int(geo[4])
    _check(p_even, "p_even", (n, 2, h, w), device=dev)
    _check(p_odd, "p_odd", (n, 2, h, w), device=dev)
    _check(iters, "iters", (n,), dtype=torch.int32, device=dev)
    _check(base, "base", (n,), dtype=torch.int32, device=dev)
    _check(weight, "weight", (n,), device=dev)
    xs = _slab_ptrs(x_slabs, "x_slabs", n, 1, h, w, hw, dev)
    es = _slab_ptrs(slabs_even, "slabs_even", n, 2, h, w, hw, dev)
    os_ = _slab_ptrs(slabs_odd, "slabs_odd", n, 2, h, w, hw, dev)
    ms = int(ms)
    gh, gw, row0, col0, hw = _shard_geo(x, geo, ms)
    lib = library()
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        _ok(lib.mdx_tv_shard_blocked_rebuild(
            x.data_ptr(), p_even.data_ptr(), p_odd.data_ptr(),
            iters.data_ptr(), base.data_ptr(), weight.data_ptr(),
            out.data_ptr(), *xs, *es, *os_, n, h, w, gh, gw, row0, col0, hw,
            ms, _stream()), "tv_shard_rebuild")
    LAUNCHES["tv_shard_step"] += 1
    return out


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


# levels a stage of the wavelet kernel runs on its tiles (at most a
# 2^5 = 32 x 32 tile); the levels past it run as further stages on the
# tiles' LL image
_WAVELET_TILE_LEVELS = 5
# threads of a wavelet block, and the pixels across its row of tiles
_WAVELET_THREADS, _WAVELET_REGION_W = 256, 128
_ALIGN = 256


def wavelet_geometry(m: int) -> dict[str, int]:
    """The layout of a stage of ``m`` levels in ``csrc/wavelet.cu``
    (``Geo<M>``): levels in registers ``R``, patch side ``P``, lanes of a
    tile ``G``, tile side ``T``, tiles across ``TBX`` and down ``TBY`` a
    block, rows of ``TBY`` tiles an analysis block walks ``LOOP``."""
    r = 2 if m >= 2 else 1
    g = 1 << (2 * (m - r))
    t = 1 << m
    tbx = _WAVELET_REGION_W // t
    return {"R": r, "P": 1 << r, "G": g, "T": t, "TBX": tbx,
            "TBY": _WAVELET_THREADS // g // tbx, "LOOP": 4 if m == 5 else 1}


def wavelet_stages(h: int, w: int, levels: int) -> list[tuple]:
    """(h, w, m, blocks) of each stage of a ``levels``-deep denoise of an
    [h, w] image: stages of at most ``_WAVELET_TILE_LEVELS`` levels, each on
    the LL image of the one before."""
    stages = []
    while levels:
        m = min(levels, _WAVELET_TILE_LEVELS)
        geo = wavelet_geometry(m)
        blocks = (-(-(w >> m) // geo["TBX"])
                  * -(-(h >> m) // (geo["TBY"] * geo["LOOP"])))
        stages.append((h, w, m, blocks))
        h, w, levels = h >> m, w >> m, levels - m
    return stages


def wavelet_denoise(x: torch.Tensor, sigma: torch.Tensor | None,
                    soft: torch.Tensor, levels: int) -> torch.Tensor:
    """db1 BayesShrink denoise of [N,H,W] with ``levels`` levels, per-image
    noise ``sigma`` [N] (None: the MAD estimate from the finest HH, which
    the first analysis launch writes out) and ``soft`` [N] bool (soft or
    hard shrink); H and W divisible by ``2**levels`` — see
    ``csrc/wavelet.cu``; plain version
    ``mdx_torch.ops.wavelet.denoise_wavelet_plain``.

    Two launches a stage (:func:`wavelet_stages`): an analysis launch down
    the stages (its output, the tiles' LL image, is the next stage's input;
    its last block per image writes the stage's band means), then, from the
    coarsest stage up, a synthesis launch that derives the thresholds from
    those means and sigma and puts the stage above's denoised LL back.  One
    workspace holds every temporary; one memset clears its tickets."""
    n, h, w = _image(x)
    _check(soft, "soft", (n,), dtype=torch.bool, device=x.device)
    if sigma is not None:
        _check(sigma, "sigma", (n,), device=x.device)
    levels = int(levels)
    if levels < 1:
        raise ValueError(f"wavelet kernel: levels must be ≥ 1, got {levels}")
    if h % (1 << levels) or w % (1 << levels):
        raise ValueError(f"wavelet kernel: extents {h}x{w} not divisible "
                         f"by 2^{levels}")
    if x.data_ptr() % 16:                  # the patches load as float4 rows
        x = x.clone()
    stages = wavelet_stages(h, w, levels)
    last = len(stages) - 1
    # the workspace: per stage partials [n, 3m, blocks] float64 and band
    # means [n, 3m]; per stage but the last its LL image (the next stage's
    # input) and that image denoised (the next stage's synthesis output);
    # the tickets [stages, n]; the finest HH when sigma is estimated
    size = 0

    def carve(nbytes: int) -> int:
        nonlocal size
        off = size
        size += -(-nbytes // _ALIGN) * _ALIGN
        return off

    regions = []
    for s, (ch, cw, m, blocks) in enumerate(stages):
        llb = 4 * n * (ch >> m) * (cw >> m)
        regions.append({"partials": carve(8 * n * 3 * m * blocks),
                        "dvar": carve(4 * n * 3 * m),
                        "ll": carve(llb) if s < last else None,
                        "den": carve(llb) if s < last else None})
    tickets = carve(4 * n * len(stages))
    hh_off = carve(4 * n * (h // 2) * (w // 2)) if sigma is None else None
    lib = library()
    dev = x.device
    with torch.cuda.device(dev):
        stream = _stream()
        ws = torch.empty(size, dtype=torch.uint8, device=dev)
        out = torch.empty_like(x)
        base = ws.data_ptr()
        at = lambda off: None if off is None else base + off  # noqa: E731
        src = x.data_ptr()
        for s, ((ch, cw, m, blocks), reg) in enumerate(zip(stages, regions)):
            _ok(lib.mdx_wavelet_analysis(
                src, at(reg["ll"]), at(reg["partials"]), at(reg["dvar"]),
                at(tickets) + 4 * n * s, n * len(stages) if s == 0 else 0,
                at(hh_off) if s == 0 else None, n, ch, cw, m, blocks,
                stream), "wavelet_denoise")
            src = at(reg["ll"])
        if sigma is None:
            from mdx_torch.ops.wavelet import mad_sigma_from_hh

            hh = ws[hh_off:hh_off + 4 * n * (h // 2) * (w // 2)].view(
                torch.float32).view(n, h // 2, w // 2)
            sigma = mad_sigma_from_hh(hh).contiguous()
        for s in range(last, -1, -1):
            ch, cw, m, _ = stages[s]
            _ok(lib.mdx_wavelet_synthesis(
                x.data_ptr() if s == 0 else at(regions[s - 1]["ll"]),
                at(regions[s]["den"]), at(regions[s]["dvar"]),
                sigma.data_ptr(), soft.data_ptr(),
                out.data_ptr() if s == 0 else at(regions[s - 1]["den"]),
                n, ch, cw, m, stream), "wavelet_denoise")
    LAUNCHES["wavelet_denoise"] += 1
    return out
