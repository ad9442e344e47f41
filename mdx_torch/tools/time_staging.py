"""The batch runner's staging of a directory on the host: ms per frame of
``batch_runner._collect_inputs_raw``, the stage the benchmark's ``decode``
span covers.

    python -m mdx_torch.tools.time_staging [--syntax rle] [--n 64]
                                           [--size 512] [--reps 5]

Run from the root of a checkout.  Writes ``--n`` single-frame 12-bit
``--size``² slices (a smooth scene with light noise) in one transfer
syntax (``explicit-le``, ``rle``, ``jpeg-ll``, ``jpeg-ls``, ``j2k``) into a
temporary directory, stages the directory once to warm the codecs' host
library and the page cache (the reads are warm), then ``--reps`` times.
Needs no card: the chunk buffers are plain host memory.  To time another
tree, copy this file into its ``mdx_torch/tools/`` and run it there.
Prints one JSON object with the host's CPU model and core count.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import tempfile
import time

import numpy as np

_SYNTAX = {"explicit-le": "TS_EXPLICIT_LE", "rle": "TS_RLE",
           "jpeg-ll": "TS_JPEG_LL_SV1", "jpeg-ls": "TS_JPEG_LS",
           "j2k": "TS_J2K_LOSSLESS"}


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def write_slices(root: str, n: int, size: int, syntax: str,
                 seed: int = 0) -> None:
    """``n`` 12-bit uint16 slices, one a file, in ``syntax``."""
    from mdx_torch.io import dicom, write_dicom

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1)
    for i in range(n):
        img = (1500 + 1200 * np.sin(3 * xx + i / n) * np.cos(2 * yy)
               + rng.normal(0, 20, (size, size)))
        write_dicom(os.path.join(root, f"s{i:04d}.dcm"),
                    np.clip(img, 0, 4095).astype(np.uint16),
                    transfer_syntax=getattr(dicom, _SYNTAX[syntax]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--syntax", choices=sorted(_SYNTAX), default="rle")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from mdx_torch.pipeline import batch_runner

    with tempfile.TemporaryDirectory() as root:
        write_slices(root, args.n, args.size, args.syntax)
        batch_runner._collect_inputs_raw(root)
        ms = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            batch_runner._collect_inputs_raw(root)
            ms.append((time.perf_counter() - t0) * 1e3 / args.n)
    out = {"syntax": args.syntax, "n": args.n, "size": args.size,
           "ms_per_frame": [round(v, 4) for v in ms],
           "median_ms_per_frame": round(statistics.median(ms), 4),
           "cwd": os.getcwd(), "cpu": _cpu(), "cores": os.cpu_count()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
