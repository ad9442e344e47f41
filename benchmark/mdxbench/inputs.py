"""The one input generator: a configuration's scene and a traffic mix's
conditions, drawn from the seed, written as DICOM files.

An image is made in three steps, all on the device, a block of images at a
time:

1. The scene, in the configuration's physical units (HU for CT, detector
   values for a radiograph): a background and ellipses painted in order
   (``scene.structures``), each with its size scaled per image, plus a
   smooth texture of a few plane waves.
2. The scene mapped into the space the program's QA sees (``q``): through
   the stored VOI window where the call applies it, else min-max over the
   scene's value range.  The conditions are added there, so that their
   strength is stated against the program's thresholds: ``blur`` (a
   Gaussian of ``sigma_px`` times the width), ``compressed`` (the range
   squeezed about its mean to a standard deviation of ``std``), ``noise``
   (Gaussian noise whose wavelet-MAD estimate is about ``sigma_est``:
   pixels that the window clips carry no noise, so the noise is scaled up
   by the share of pixels inside the window), and light noise
   (``clean_sigma``) on every image that is not noisy.
3. ``q`` mapped back to physical units and to the stored integers.

Which images get which condition and how large each structure is do not
depend on the seed: image ``j`` of a pool of ``n`` takes them from ``j``
alone (the condition ``k`` is on where ``(j * m_k + a_k) mod n`` falls
below its share of ``n``, with odd ``m_k``; a structure's scale is the
``(j * m + a) mod n``-th of ``n`` even steps over its range), and the seed
permutes the images over the files and draws the noise and the texture.
So every seed gives the same set of conditions and sizes, in another
order, and the same work.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from mdxbench.dicom_writer import write_dicom

# Odd multipliers and offsets of the stratified assignment (module doc).
_COND_STEPS = {"noise": (37, 0), "blur": (73, 11), "compressed": (109, 29)}
_SCALE_STEPS = ((41, 3), (89, 17), (57, 5), (97, 13), (29, 7), (61, 19),
                (83, 23), (47, 31))
_BLOCK_PIXELS = 1 << 24       # pixels generated a block on the device


@dataclass
class Item:
    """One file of the pool: its path and conditions."""
    path: str
    conditions: tuple[str, ...]


def stored_range(cfg: dict) -> tuple[int, int]:
    bits = int(cfg["bits_stored"])
    if cfg["stored_dtype"] == "int16":
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


def qa_space(cfg: dict, windowed: bool) -> tuple[float, float]:
    """(lo, span) of the map physical value = lo + q * span into the QA
    space: the stored window (DICOM PS3.3 C.11.2.1.2) or the scene's range."""
    if windowed:
        c, w = float(cfg["window_center"]), float(cfg["window_width"])
        return c - 0.5 - (w - 1.0) / 2.0, w - 1.0
    values = [s["value"] for s in cfg["scene"]["structures"]]
    values.append(cfg["scene"]["background"])
    return float(min(values)), float(max(values) - min(values))


def conditions(j: int, n: int, traffic: dict) -> tuple[str, ...]:
    out = []
    for name, (m, a) in _COND_STEPS.items():
        share = traffic["conditions"][name]["share"]
        if (j * m + a) % n < round(share * n):
            out.append(name)
    return tuple(out)


def _scales(j: int, n: int, structures: list) -> list[float]:
    out = []
    for k, s in enumerate(structures):
        m, a = _SCALE_STEPS[k % len(_SCALE_STEPS)]
        lo, hi = s.get("scale", (1.0, 1.0))
        out.append(lo + (hi - lo) * (((j * m + a) % n) + 0.5) / n)
    return out


def _scene(cfg: dict, idx: list[int], n: int, gen, dev) -> torch.Tensor:
    """[b, H, W] float32 physical values of the pool images ``idx``."""
    sc = cfg["scene"]
    h, w = int(cfg["rows"]), int(cfg["cols"])
    yy = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
    xx = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
    yy, xx = yy[:, None], xx[None, :]
    out = torch.full((len(idx), h, w), float(sc["background"]),
                     device=dev, dtype=torch.float32)
    for b, j in enumerate(idx):
        for s, k in zip(sc["structures"], _scales(j, n, sc["structures"])):
            if k <= 0:
                continue
            (cx, cy), (ax, ay) = s["center"], s["axes"]
            r = ((xx - cx) / (ax * k)) ** 2 + ((yy - cy) / (ay * k)) ** 2
            out[b][r <= 1.0] = float(s["value"])
    tx = sc.get("texture")
    if tx:
        waves = int(tx["waves"])
        ang = torch.rand((len(idx), waves), generator=gen, device=dev)
        cyc = 1.0 + torch.rand((len(idx), waves), generator=gen,
                               device=dev) * (float(tx["max_cycles"]) - 1)
        ph = torch.rand((len(idx), waves), generator=gen, device=dev)
        kx = (cyc * torch.cos(2 * math.pi * ang))[:, :, None, None]
        ky = (cyc * torch.sin(2 * math.pi * ang))[:, :, None, None]
        arg = 2 * math.pi * (kx * xx + ky * yy + ph[:, :, None, None])
        out += (float(tx["amplitude"]) / math.sqrt(waves)
                * torch.sin(arg).sum(dim=1))
    return out


def _blur(q: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(int(3 * sigma + 0.5), 1)
    t = torch.arange(-r, r + 1, device=q.device, dtype=torch.float32)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = (g / g.sum())
    x = q[:, None]
    x = torch.nn.functional.pad(x, (r, r, r, r), mode="replicate")
    x = torch.nn.functional.conv2d(x, g.view(1, 1, -1, 1))
    x = torch.nn.functional.conv2d(x, g.view(1, 1, 1, -1))
    return x[:, 0]


def _compress(img: torch.Tensor, target: float) -> torch.Tensor:
    """``m + (img - m) * k`` about the mean ``m`` of the clipped image, with
    the ``k`` in (0, 1] (by bisection) at which the clipped result's
    standard deviation is ``target``: clipping by the window would spread
    a plain linear squeeze out again."""
    m = float(img.clamp(0.0, 1.0).mean())
    lo, hi = 0.0, 1.0
    for _ in range(16):
        k = 0.5 * (lo + hi)
        sd = float((m + (img - m) * k).clamp(0.0, 1.0).std())
        lo, hi = (k, hi) if sd < target else (lo, k)
    return m + (img - m) * lo


def _noise_scale(inside: float, sigma_est: float) -> float:
    """The noise sigma whose MAD estimate is about ``sigma_est`` when only
    the share ``inside`` of the pixels carries it (the rest read 0)."""
    if inside <= 0.55:
        inside = 0.55
    p = 0.5 + (inside - 0.5) / (2.0 * inside)
    z = math.sqrt(2.0) * _erfinv(2.0 * p - 1.0)
    return min(sigma_est * 0.6744897501960817 / z, 0.5)


def _erfinv(y: float) -> float:
    return float(torch.special.erfinv(torch.tensor(y, dtype=torch.float64)))


def make_images(cfg: dict, traffic: dict, windowed: bool, idx: list[int],
                n: int, gen, dev) -> np.ndarray:
    """Stored integer frames [b, H, W] of the pool images ``idx``."""
    lo, span = qa_space(cfg, windowed)
    q = (_scene(cfg, idx, n, gen, dev) - lo) / span
    cond = traffic["conditions"]
    h, w = q.shape[1:]
    for b, j in enumerate(idx):
        on = conditions(j, n, traffic)
        img = q[b]
        if "blur" in on:
            img = _blur(img[None], cond["blur"]["sigma_px"] * w)[0]
        if "compressed" in on:
            img = _compress(img, cond["compressed"]["std"])
        if "noise" in on:
            inside = float(((img > 0.0) & (img < 1.0)).float().mean())
            sigma = _noise_scale(inside, cond["noise"]["sigma_est"])
        else:
            sigma = cond["clean_sigma"] if "blur" not in on else 0.0
        if sigma:
            img = img + sigma * torch.randn(img.shape, generator=gen,
                                            device=dev)
        if not windowed:
            # min-max space: the detector's range holds, and two 2 x 2
            # marks keep the scene's extremes, so min-max maps q back
            img = img.clamp(0.0, 1.0)
            img[:2, :2] = 0.0
            img[:2, -2:] = 1.0
        q[b] = img
    phys = lo + q * span
    slope = float(cfg.get("rescale_slope", 1.0))
    icpt = float(cfg.get("rescale_intercept", 0.0))
    smin, smax = stored_range(cfg)
    st = torch.round((phys - icpt) / slope).clamp(smin, smax)
    dt = torch.int16 if cfg["stored_dtype"] == "int16" else torch.int32
    out = st.to(dt).cpu().numpy()
    return out if dt == torch.int16 else out.astype(np.uint16)


def write_pool(cfg: dict, traffic: dict, windowed: bool, root: str,
               groups: list[int], seed: int, dev) -> list[list[Item]]:
    """Write ``sum(groups)`` files under ``root``, in directories of
    ``groups[g]`` files each (``root/g000/…``); the seed permutes the pool
    indices over the files.  Returns the items of each directory."""
    n = sum(groups)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n).tolist()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, w = int(cfg["rows"]), int(cfg["cols"])
    block = max(1, _BLOCK_PIXELS // (h * w))
    meta = dict(modality=cfg["modality"], body_part=cfg["body_part"],
                photometric=cfg["photometric"],
                rescale_slope=cfg.get("rescale_slope"),
                rescale_intercept=cfg.get("rescale_intercept"),
                window_center=cfg.get("window_center"),
                window_width=cfg.get("window_width"),
                bits_stored=int(cfg["bits_stored"]))
    out: list[list[Item]] = []
    slots = []
    for g, size in enumerate(groups):
        d = os.path.join(root, f"g{g:03d}")
        os.makedirs(d, exist_ok=True)
        out.append([])
        for i in range(size):
            slots.append((g, os.path.join(d, f"img{i:04d}.dcm")))
    # files are written on threads while the next block is made
    with ThreadPoolExecutor(max_workers=4) as pool:
        writes = []
        for s in range(0, n, block):
            idx = order[s:s + block]
            frames = make_images(cfg, traffic, windowed, idx, n, gen, dev)
            for k, j in enumerate(idx):
                g, path = slots[s + k]
                writes.append(pool.submit(write_dicom, path, frames[k],
                                          **meta))
                out[g].append(Item(path, conditions(j, n, traffic)))
        for w in writes:
            w.result()
    # flushed now, in set-up: else the kernel writes these pages back some
    # 30 s later, in the middle of the measured window
    os.sync()
    return out
