"""The lossless JPEG codecs on the host: ms per frame, and a compressed
series through ``--batch`` on the card.

    python -m mdx_torch.tools.time_codecs [--reps 5] [--python-reps 1]
                                          [--frames 64] [--device cuda]

Run from the root of a checkout.  The decode of a compressed file runs on
the host (``mdx_torch.io.jpegll``, ``mdx_torch.io.jpegls`` and their C++
loops in ``mdx_torch.io.native``), so each number is printed beside the
host's CPU model and core count, and the card's ``name, power.limit``:

* ms per frame to encode and to decode, JPEG Lossless SV1 and JPEG-LS
  lossless, through the host C++ loops at 512^2 (a 12-bit CT-like slice)
  and 2048^2 (a 16-bit chest X-ray, ``make_batch``), median of ``--reps``
  after one warm-up; through the Python loops (``MDX_NO_NATIVE=1``) at
  512^2 only, ``--python-reps`` calls (about a second each);
* frames/s of ``run_pipeline_batch`` on a ``--frames``-frame 512^2 12-bit
  series stored in explicit VR LE, ``.4.70`` and ``.4.80``, one warm-up
  each, median of 3 (``cli_latency.batch_fps``), in turns in one process.

``--device cpu`` skips the card and times the codecs alone; its times are
this host's.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import tempfile
import time
from contextlib import contextmanager, nullcontext

import numpy as np


def host_line() -> str:
    """The host's CPU model (``/proc/cpuinfo``, else ``lscpu``, else the
    machine type) and ``os.cpu_count()``."""
    model = None
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            model = next((ln.split(":", 1)[1].strip()
                          for ln in out.splitlines()
                          if ln.lower().startswith("model name")), None)
        except (OSError, subprocess.TimeoutExpired):
            pass
    return (f"{model or 'CPU model not reported'} ({platform.machine()}), "
            f"{os.cpu_count()} cores")


@contextmanager
def python_loops():
    """``MDX_NO_NATIVE=1`` for the duration: the codecs' Python loops."""
    old = os.environ.get("MDX_NO_NATIVE")
    os.environ["MDX_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MDX_NO_NATIVE")
        else:
            os.environ["MDX_NO_NATIVE"] = old


def _median_ms(fn, reps: int, warm: bool = True) -> float:
    if warm:
        fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def frame_times(frame: np.ndarray, reps: int, python: bool = False
                ) -> dict[str, float]:
    """ms to encode and to decode one uint16 ``frame`` in each family
    (container precision 16, as the writer codes it): through the host
    C++ loops, or with ``python`` through the Python loops (no warm-up:
    there is nothing to warm)."""
    from mdx_torch.io import jpegll, jpegls

    codecs = {"jpegll": (lambda: jpegll.encode(frame, precision=16,
                                               predictor=1), jpegll.decode),
              "jpegls": (lambda: jpegls.encode(frame, precision=16),
                         jpegls.decode)}
    out = {}
    for name, (enc, dec) in codecs.items():
        stream = enc()
        with python_loops() if python else nullcontext():
            out[f"{name}_encode_ms"] = _median_ms(enc, reps, not python)
            out[f"{name}_decode_ms"] = _median_ms(lambda: dec(stream), reps,
                                                  not python)
    return out


def frames() -> dict[str, np.ndarray]:
    """The 512^2 12-bit CT-like slice and the 2048^2 16-bit chest X-ray."""
    from mdx_torch.tools import make_batch

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:512, 0:512] / 511.0
    r = np.hypot(yy - 0.5, xx - 0.5)
    ct = (r < 0.4) * (0.6 + 0.3 * np.cos(8 * np.pi * r))
    ct = np.clip(ct + rng.normal(0, 0.02, ct.shape), 0, 1) * 4095
    cxr = np.rint(make_batch(1, 2048, seed=8)[0] * 65535)
    return {"512": ct.astype(np.uint16), "2048": cxr.astype(np.uint16)}


def series_fps(tmp: str, n_frames: int, device) -> dict[str, dict]:
    """frames/s of the batch runner on one series in three syntaxes."""
    from mdx_torch.io.dicom import TS_EXPLICIT_LE, TS_JPEG_LL_SV1, TS_JPEG_LS
    from mdx_torch.tools.cli_latency import batch_fps, series_file

    paths = {name: series_file(os.path.join(tmp, f"series_{name}.dcm"),
                               n_frames, 512, transfer_syntax=ts)
             for name, ts in (("explicit_le", TS_EXPLICIT_LE),
                              ("jpeg_ll", TS_JPEG_LL_SV1),
                              ("jpeg_ls", TS_JPEG_LS))}
    out = os.path.join(tmp, "out")
    return {name: batch_fps(p, out, device) for name, p in paths.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--python-reps", type=int, default=1)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from mdx_torch.io import native

    native.load()
    fr = frames()
    times = {size: frame_times(f, args.reps) for size, f in fr.items()}
    times["512_python"] = frame_times(fr["512"], args.python_reps,
                                      python=True)
    res = {"tool": "time_codecs", "host": host_line(),
           "build": dict(native.BUILD), "ms_per_frame": times}
    if args.device != "cpu":
        import torch

        from mdx_torch.pipeline.runner import resolve_device
        from mdx_torch.tools import card_line

        dev = resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res.update(device=torch.cuda.get_device_name(0), card=card_line())
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["MDX_DB_PATH"] = os.path.join(tmp, "runs.db")
            res["series"] = series_fps(tmp, args.frames, dev)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
