"""The JPEG codecs and the transcoder on the host: ms per frame, and a
compressed series through ``--batch`` on the card.

    python -m mdx_torch.tools.time_codecs [--reps 5] [--python-reps 1]
                                          [--frames 64] [--device cuda]

Run from the root of a checkout.  The decode of a compressed file runs on
the host (``mdx_torch.io.jpegll``, ``jpegls``, ``jpeg2k`` and their C++
loops in ``mdx_torch.io.native``), so each number is printed beside the
host's CPU model and core count, and the card's ``name, power.limit``:

* ms per frame to encode and to decode, JPEG Lossless SV1, JPEG-LS
  lossless and JPEG 2000 lossless (``.4.90``: 5/3, five levels, 64 x 64
  code-blocks, as the writer codes it), through the host C++ loops at
  512^2 (a 12-bit CT-like slice) and 2048^2 (a 16-bit chest X-ray,
  ``make_batch``), median of ``--reps`` after one warm-up; through the
  Python loops (``MDX_NO_NATIVE=1``), ``--python-reps`` calls: the two
  lossless JPEG families at 512^2 (about a second each), JPEG 2000 at
  128^2 (the slice's corner; its Python Tier-1 takes seconds at 512^2),
  where the host loops are timed too;
* a ``.4.90`` decode at 512^2 and 2048^2 split into the Tier-1 block
  decodes, the inverse DWT and the rest (``j2k_decode_split``);
* a DCT JPEG (``.4.50``/``.4.51``) decode of each committed fixture of
  ``tests/torch_fixtures/jpegdct/`` (a 512^2 8-bit slice sequential with
  restart intervals and progressive, a 480 x 640 YBR 4:2:2 ultrasound
  frame, a 256^2 12-bit slice; the card's machine has no JPEG encoder),
  through the host C++ loops, split into the entropy loops, the
  reconstruction (dequantisation and the float64 IDCT einsum) and the rest
  (``dct_decode_split``);
* ms to transcode (``mdx_torch.io.transcode``) the 512^2 and the 2048^2
  frame from explicit VR LE to each lossless target, and the 512^2 and the
  480 x 640 ``.4.50`` fixtures to explicit VR LE (``transcode_times``);
* frames/s of ``run_pipeline_batch`` on a ``--frames``-frame 512^2 12-bit
  series stored in explicit VR LE, ``.4.70``, ``.4.80`` and ``.4.90``, one
  warm-up each, median of 3 (``cli_latency.batch_fps``), in turns in one
  process.

``--device cpu`` skips the card and times the codecs alone; its times are
this host's.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import tempfile
import time
from contextlib import contextmanager, nullcontext

import numpy as np


def host_line() -> str:
    """The host's CPU model and ``os.cpu_count()``.  Where the kernel names
    no model (``model name: unknown`` in ``/proc/cpuinfo``, as in some
    virtual machines), the vendor, family, model number and clock it gives,
    and the machine's DMI product name where it is readable."""
    cpu: dict[str, str] = {}
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    break                      # the first processor only
                key, _, val = line.partition(":")
                cpu[key.strip().lower()] = val.strip()
    except OSError:
        pass
    model = cpu.get("model name", "")
    if not model or model.lower() == "unknown":
        model = (f"CPU model name not reported ({cpu.get('vendor_id', '?')} "
                 f"family {cpu.get('cpu family', '?')} model "
                 f"{cpu.get('model', '?')}, {cpu.get('cpu mhz', '?')} MHz")
        try:
            with open("/sys/devices/virtual/dmi/id/product_name",
                      encoding="utf-8") as f:
                model += f", {f.read().strip()}"
        except OSError:
            pass
        model += ")"
    return f"{model} ({platform.machine()}), {os.cpu_count()} cores"


def _timing(spent: dict, key: str, fn):
    """``fn`` adding its wall ms to ``spent[key]`` at each call."""
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spent[key] += (time.perf_counter() - t0) * 1e3
    return wrapper


def j2k_decode_split(frame: np.ndarray, reps: int) -> dict[str, float]:
    """Median ms of a ``.4.90`` decode of ``frame`` and of its parts: the
    Tier-1 code-block decodes (the wall of ``jpeg2k._map_parallel``, the
    host C++ loops on the block pool), the inverse DWT (NumPy) and the
    rest (codestream and packet headers, dequantisation, level shift),
    timed by wrapping the two module functions for the duration."""
    from mdx_torch.io import jpeg2k

    stream = jpeg2k.encode(frame)
    spent = {"tier1_ms": 0.0, "dwt_ms": 0.0}
    real = jpeg2k._map_parallel, jpeg2k._inverse_dwt
    jpeg2k._map_parallel = _timing(spent, "tier1_ms", real[0])
    jpeg2k._inverse_dwt = _timing(spent, "dwt_ms", real[1])
    rows = []
    try:
        jpeg2k.decode(stream)
        for _ in range(reps):
            spent.update(tier1_ms=0.0, dwt_ms=0.0)
            t0 = time.perf_counter()
            jpeg2k.decode(stream)
            total = (time.perf_counter() - t0) * 1e3
            rows.append((total, spent["tier1_ms"], spent["dwt_ms"]))
    finally:
        jpeg2k._map_parallel, jpeg2k._inverse_dwt = real
    total, tier1, dwt = (statistics.median(c) for c in zip(*rows))
    return {"total_ms": total, "tier1_ms": tier1, "dwt_ms": dwt,
            "rest_ms": total - tier1 - dwt}


DCT_FIXTURES = ("ct512_rst.jpg", "ct512_prog.jpg", "us480x640_422.jpg",
                "ct256_12bit.jpg")


def dct_fixtures() -> dict[str, bytes]:
    """The committed DCT JPEG codestreams, by file name."""
    from pathlib import Path

    d = Path(__file__).resolve().parents[2] / "tests" / "torch_fixtures" \
        / "jpegdct"
    return {name: (d / name).read_bytes() for name in DCT_FIXTURES}


def dct_decode_split(stream: bytes, reps: int) -> dict[str, float]:
    """Median ms of a DCT JPEG decode of ``stream`` and of its parts: the
    entropy loops (every restart segment's host C++ call, sequential or
    progressive), the reconstruction of each component (dequantisation,
    inverse zigzag, the float64 IDCT einsum, round and clip) and the rest
    (marker parsing, destuffing, cropping, chroma upsampling), timed by
    wrapping the module functions for the duration."""
    from mdx_torch.io import jpegdct

    keys = ("entropy_ms", "idct_ms")
    spent = dict.fromkeys(keys, 0.0)
    real = (jpegdct._decode_segment, jpegdct._decode_prog_segment,
            jpegdct._reconstruct)
    jpegdct._decode_segment = _timing(spent, "entropy_ms", real[0])
    jpegdct._decode_prog_segment = _timing(spent, "entropy_ms", real[1])
    jpegdct._reconstruct = _timing(spent, "idct_ms", real[2])
    rows = []
    try:
        jpegdct.decode(stream)
        for _ in range(reps):
            spent.update(dict.fromkeys(keys, 0.0))
            t0 = time.perf_counter()
            jpegdct.decode(stream)
            total = (time.perf_counter() - t0) * 1e3
            rows.append((total, spent["entropy_ms"], spent["idct_ms"]))
    finally:
        (jpegdct._decode_segment, jpegdct._decode_prog_segment,
         jpegdct._reconstruct) = real
    total, entropy, idct = (statistics.median(c) for c in zip(*rows))
    return {"total_ms": total, "entropy_ms": entropy, "idct_ms": idct,
            "rest_ms": total - entropy - idct}


def dct_decode_split_all(reps: int) -> dict[str, dict[str, float]]:
    """:func:`dct_decode_split` of every committed fixture, by file name."""
    return {name: dct_decode_split(s, reps)
            for name, s in dct_fixtures().items()}


def transcode_times(tmp: str, frames_by_size: dict, reps: int
                    ) -> dict[str, float]:
    """Median ms of ``transcode`` (one warm-up): each uint16 frame of
    ``frames_by_size`` from explicit VR LE to every lossless target, and
    the 512^2 and 480 x 640 ``.4.50`` fixtures to explicit VR LE."""
    from mdx_torch.io import transcode, write_dicom
    from mdx_torch.io.dicom import TS_JPEG_BASELINE
    from mdx_torch.io.dicom_write import write_codestreams
    from mdx_torch.io.transcode import TARGET_ALIASES

    out = {}
    dst = os.path.join(tmp, "transcoded.dcm")
    for size, frame in frames_by_size.items():
        src = write_dicom(os.path.join(tmp, f"le_{size}.dcm"), frame)
        for target in TARGET_ALIASES:
            if target != "explicit-le":
                out[f"explicit-le_{size}_to_{target}_ms"] = _median_ms(
                    lambda: transcode(src, dst, target), reps)
    fx = dct_fixtures()
    for name, shape, kw in (("ct512_rst.jpg", (512, 512), {}),
                            ("us480x640_422.jpg", (480, 640),
                             {"samples": 3, "photometric": "YBR_FULL_422",
                              "modality": "US"})):
        src = write_codestreams(os.path.join(tmp, f"{name}.dcm"), [fx[name]],
                                *shape, transfer_syntax=TS_JPEG_BASELINE,
                                bits=8, **kw)
        out[f"4.50_{shape[0]}x{shape[1]}_to_explicit-le_ms"] = _median_ms(
            lambda: transcode(src, dst, "explicit-le"), reps)
    return out


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


FAMILIES = ("jpegll", "jpegls", "jpeg2k")


def frame_times(frame: np.ndarray, reps: int, python: bool = False,
                families=FAMILIES) -> dict[str, float]:
    """ms to encode and to decode one uint16 ``frame`` in each of
    ``families`` (container precision 16, as the writer codes it): through
    the host C++ loops, or with ``python`` through the Python loops (no
    warm-up: there is nothing to warm)."""
    from mdx_torch.io import jpeg2k, jpegll, jpegls

    codecs = {"jpegll": (lambda: jpegll.encode(frame, precision=16,
                                               predictor=1), jpegll.decode),
              "jpegls": (lambda: jpegls.encode(frame, precision=16),
                         jpegls.decode),
              "jpeg2k": (lambda: jpeg2k.encode(frame), jpeg2k.decode)}
    out = {}
    for name in families:
        enc, dec = codecs[name]
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
    """frames/s of the batch runner on one series in four syntaxes."""
    from mdx_torch.io.dicom import (TS_EXPLICIT_LE, TS_J2K_LOSSLESS,
                                    TS_JPEG_LL_SV1, TS_JPEG_LS)
    from mdx_torch.tools.cli_latency import batch_fps, series_file

    paths = {name: series_file(os.path.join(tmp, f"series_{name}.dcm"),
                               n_frames, 512, transfer_syntax=ts)
             for name, ts in (("explicit_le", TS_EXPLICIT_LE),
                              ("jpeg_ll", TS_JPEG_LL_SV1),
                              ("jpeg_ls", TS_JPEG_LS),
                              ("j2k", TS_J2K_LOSSLESS))}
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
                                      python=True, families=FAMILIES[:2])
    corner = fr["512"][:128, :128]
    times["128"] = frame_times(corner, args.reps, families=("jpeg2k",))
    times["128_python"] = frame_times(corner, args.python_reps, python=True,
                                      families=("jpeg2k",))
    res_split = {size: j2k_decode_split(f, args.reps) for size, f in fr.items()}
    dct = dct_decode_split_all(args.reps)
    with tempfile.TemporaryDirectory() as tmp:
        tc = transcode_times(tmp, fr, args.reps)
    res = {"tool": "time_codecs", "host": host_line(),
           "build": dict(native.BUILD), "ms_per_frame": times,
           "j2k_decode_split": res_split, "dct_decode_split": dct,
           "transcode_ms": tc}
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
