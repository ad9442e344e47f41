"""Plain reading and normalisation of the benchmark's DICOM files.

Reads an Explicit VR Little Endian part-10 file (the only syntax the
benchmark writes) and brings its pixels into the QA pass's [0, 1] float32
input, in the two ways the program's entry points do:

* :func:`single_input` — one file run by itself: the modality rescale
  (float32 multiply, then add), the MONOCHROME1 inversion about the
  maximum, min-max normalisation on the host (DICOM PS3.3 C.7.6.3.1.4,
  C.11.1.1.2; ref pipeline/dicom_io.py:29-91).
* :func:`batch_inputs` — frames of a batch call, normalised on the device
  from the stored integers: the rescale, then the stored linear VOI window
  (PS3.3 C.11.2.1.2) clipped to [0, 1] where the call applies it, else each
  frame's own min-max.

Written from the standard, not from the program; imports nothing of it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_LONG_VRS = (b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN")
_TAGS = {(0x0002, 0x0010): "ts", (0x0028, 0x0004): "photometric",
         (0x0028, 0x0010): "rows", (0x0028, 0x0011): "cols",
         (0x0028, 0x0100): "bits", (0x0028, 0x0103): "signed",
         (0x0028, 0x1050): "wc", (0x0028, 0x1051): "ww",
         (0x0028, 0x1052): "intercept", (0x0028, 0x1053): "slope",
         (0x7FE0, 0x0010): "pixels"}


def read(path: str) -> dict:
    """The attributes the QA input needs, and the stored frame."""
    with open(path, "rb") as f:
        data = f.read()
    if data[128:132] != b"DICM":
        raise ValueError(f"{path}: not a part-10 file")
    pos, out = 132, {}
    while pos + 8 <= len(data):
        group, elem, vr = struct.unpack_from("<HH2s", data, pos)
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", data, pos + 8)
            pos += 12
        else:
            (length,) = struct.unpack_from("<H", data, pos + 6)
            pos += 8
        raw = data[pos:pos + length]
        pos += length
        key = _TAGS.get((group, elem))
        if key is None:
            continue
        if vr == b"US":
            out[key] = struct.unpack("<H", raw)[0]
        elif key == "pixels":
            out[key] = raw
        else:
            out[key] = raw.rstrip(b" \x00").decode("ascii")
    if out.get("ts") != TS_EXPLICIT_LE:
        raise ValueError(f"{path}: transfer syntax {out.get('ts')}")
    if out["bits"] != 16:
        raise ValueError(f"{path}: BitsAllocated {out['bits']}")
    dt = np.dtype("<i2" if out["signed"] else "<u2")
    frame = np.frombuffer(out["pixels"], dtype=dt,
                          count=out["rows"] * out["cols"])
    out["frame"] = frame.reshape(out["rows"], out["cols"]).astype(
        dt.newbyteorder("="))
    out["slope"] = float(out.get("slope", 1.0) or 1.0)
    out["intercept"] = float(out.get("intercept", 0.0) or 0.0)
    return out


def _mono1(ds: dict) -> bool:
    return ds.get("photometric", "").strip().upper() == "MONOCHROME1"


def single_input(path: str) -> np.ndarray:
    """[H, W] float32 in [0, 1]: the input of a single-file run."""
    ds = read(path)
    img = (ds["frame"].astype(np.float32) * np.float32(ds["slope"])
           + np.float32(ds["intercept"]))
    if _mono1(ds):
        img = img.max() - img
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-8:
        return np.zeros_like(img, dtype=np.float32)
    return ((img - lo) / (hi - lo)).astype(np.float32)


def batch_inputs(paths: list[str], window: bool, dev) -> torch.Tensor:
    """[N, H, W] float32 in [0, 1] on ``dev``: the inputs of a batch call's
    frames (``window``: the call applies the stored VOI window)."""
    dss = [read(p) for p in paths]
    raw = torch.from_numpy(np.stack([d["frame"] for d in dss])).to(dev)

    def col(vals):
        return torch.tensor(vals, dtype=torch.float32,
                            device=dev)[:, None, None]

    v = (raw.to(torch.float32) * col([d["slope"] for d in dss])
         + col([d["intercept"] for d in dss]))
    if any(_mono1(d) for d in dss):
        raise ValueError("MONOCHROME1 batch frames are not generated")
    if window and all("wc" in d and "ww" in d for d in dss):
        lo, den = [], []
        for d in dss:
            width = max(float(d["ww"]), 1.0 + 1e-6)
            lo.append(float(d["wc"]) - 0.5 - (width - 1.0) / 2.0)
            den.append(width - 1.0)
        return torch.clamp((v - col(lo)) / col(den), 0.0, 1.0)
    if window:
        raise ValueError("windowed batch frames without a stored window")
    zlo = torch.amin(v, dim=(1, 2), keepdim=True)
    zhi = torch.amax(v, dim=(1, 2), keepdim=True)
    rng = zhi - zlo
    flat = rng < 1e-8
    return torch.where(flat, 0.0, (v - zlo) / torch.where(flat, 1.0, rng))
