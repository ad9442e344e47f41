"""Each CUDA kernel of the tree it is run in, against its plain version.

    python -m mdx_torch.tools.time_kernels [--n 4] [--hw 2048] [--reps 20]

Times every kernel named in ``mdx_torch.kernels.LAUNCHES`` on one
``[n, hw, hw]`` float32 batch of uniform noise (seed 0), with CUDA events
(mean of ``--reps`` launches after a warm-up; TV 3 reps), in the order
plain, kernel, kernel, plain, and prints one JSON line per kernel: kernel
and plain ms, max|kernel - plain|, and the card's ``name, power.limit``.

It imports only what every tree of the port has had (the kernels, the op
modules and their plain versions), so it also times an older checkout:
copy this file into that checkout's ``mdx_torch/tools/`` and run it there,
in one call with this tree's run, to compare two versions of a kernel.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _cases(x: torch.Tensor) -> dict:
    """{kernel name: (args, plain version)} for the kernels of this tree."""
    from mdx_torch import kernels
    from mdx_torch.core import metrics as M
    from mdx_torch.ops import clahe as C
    from mdx_torch.ops import filters as F
    from mdx_torch.ops import tv as T

    full = lambda v: torch.full((x.shape[0],), float(v), device=x.device)  # noqa: E731
    cases = {"box_stats": ((x,), M._lv_box_stats_plain),
             "unsharp": ((x, full(1.0), full(0.6)), F.unsharp_mask_plain),
             "clahe": ((x, full(0.02), 16), C.clahe_plain),
             "tv_chambolle": ((x, full(0.05), 2e-4, 200),
                              T.tv_chambolle_plain)}
    if "bilateral" in kernels.LAUNCHES:
        from mdx_torch.ops import bilateral as B

        cases["bilateral"] = ((x, 5, full(0.05), full(0.05)),
                              B.bilateral_plain)
    return {k: v for k, v in cases.items() if k in kernels.LAUNCHES}


def _event_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(_max_abs(u, v) for u, v in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def main(argv=None) -> int:
    from mdx_torch import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--hw", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((args.n, args.hw, args.hw),
                                    dtype=np.float32)).cuda()
    for k, (kargs, plain) in _cases(x).items():
        kern = getattr(kernels, k)
        reps = 3 if k == "tv_chambolle" else args.reps
        p1 = _event_ms(lambda: plain(*kargs), reps)
        k1 = _event_ms(lambda: kern(*kargs), reps)
        k2 = _event_ms(lambda: kern(*kargs), reps)
        p2 = _event_ms(lambda: plain(*kargs), reps)
        err = _max_abs(kern(*kargs), plain(*kargs))
        print(json.dumps({"kernel": k, "shape": list(x.shape),
                          "ms": (k1 + k2) / 2, "ms_runs": [k1, k2],
                          "plain_ms": (p1 + p2) / 2, "max_abs_err": err,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
