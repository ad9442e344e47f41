"""Milliseconds per on-device tuning sweep, on a CUDA card.

    python -m mdx_torch.tools.tune_sweep [--reps 7]

Run from the root of a checkout.  Times ``mdx_torch.core.tuning`` at the
sizes its users call it with, issues noise and blur (the full grid of 27
candidates):

* ``autotune`` on one 512^2 frame (27 lanes, one group);
* ``autotune`` on one 2048^2 frame (27 lanes, 3 groups of 9);
* ``autotune_batch`` on 4x512^2 frames (108 lanes: the JAX package's batch
  runner caps a sweep at 128 lanes, ``128 // 27`` = 4 frames).

Frames are ``mdx_torch.tools.make_batch``.  Each row is the median of
``--reps`` synchronised sweeps on the host clock after one warm-up (numpy
in, numpy and records out, as a caller gets them), with min and max, the
wavelet kernel's launches in one sweep, and the card's ``name,
power.limit``; one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

ISSUES = ["noise", "blur"]


def _times(fn, reps: int) -> list[float]:
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_sweep needs a CUDA card")

    from mdx_torch import kernels
    from mdx_torch.core import tuning
    from mdx_torch.tools import card_line, make_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    img512 = make_batch(1)[0]
    img2048 = make_batch(1, 2048, seed=1)[0]
    frames = make_batch(4, seed=2)
    rows = (
        ("autotune", "1x512x512", 27,
         lambda: tuning.autotune(img512, ISSUES, device=dev)),
        ("autotune", "1x2048x2048", 27,
         lambda: tuning.autotune(img2048, ISSUES, device=dev)),
        ("autotune_batch", "4x512x512", 108,
         lambda: tuning.autotune_batch(frames, [ISSUES] * 4, device=dev)),
    )
    for name, shape, lanes, fn in rows:
        times = _times(fn, args.reps)
        kernels.reset_launches()
        fn()
        print(json.dumps({
            "sweep": name, "shape": shape, "lanes": lanes,
            "ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "reps": args.reps,
            "wavelet_launches": kernels.LAUNCHES["wavelet_denoise"],
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
