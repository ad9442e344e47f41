"""DICOM RLE Lossless codec (PS3.5 Annex G): PackBits byte segments.

The port's copy of ``mdx/io/rle.py``.  PackBits decode and encode run in
the port's host C++ loops (:mod:`mdx_torch.io.native`:
``packbits_decode``, ``packbits_encode``), as the JAX package's run in its
``native/mdxio.cpp``; the Python bodies here are their plain versions,
taken only under ``MDX_NO_NATIVE=1``.  The plain decoder is the original's
Python loop, one iteration per control byte.  The plain encoder makes the
same greedy choices as the original's Python loop (replicate runs of 3 to
128, literals up to 128 that stop before the next run of 3), but finds
each run's end and the next run of 3 from arrays computed with numpy, so
its Python loop takes one iteration per output run and not one per byte.
CPU tests hold both paths byte-equal to each other and to the JAX
package's.

Format recap (PS3.5 Annex G):

* Each frame is ONE encapsulated fragment: a 64-byte RLE header — 16
  little-endian uint32s: the segment count then up to 15 segment offsets
  (measured from the start of the header; unused entries 0) — followed by
  the segments.
* Pixels are split into "composite pixel code" byte planes: for each
  sample, one segment per byte, most-significant byte first (so 16-bit
  grayscale = 2 segments: MSB plane then LSB plane).
* Every segment is PackBits-encoded and padded to even length.
"""

from __future__ import annotations

import struct

import numpy as np

from mdx_torch.io import native as _native

_HEADER_LEN = 64
_MAX_SEGMENTS = 15


class RleError(ValueError):
    """Malformed RLE frame."""


def packbits_decode(data: bytes, expected: int) -> bytes:
    """Decode a PackBits stream to exactly ``expected`` bytes.

    Control byte n: 0..127 → copy the next n+1 literal bytes; 129..255 →
    repeat the next byte 257-n times; 128 → no-op.  Trailing pad bytes
    beyond ``expected`` are ignored (segments are even-padded)."""
    if _native.disabled():
        return _packbits_decode_py(data, expected)
    rc, out = _native.packbits_decode(data, expected)
    if rc == -1:
        raise RleError("Truncated PackBits literal run.")
    if rc == -2:
        raise RleError("Truncated PackBits replicate run.")
    if rc < expected:
        raise RleError(
            f"PackBits stream too short: {rc} < {expected} bytes.")
    return out


def _packbits_decode_py(data: bytes, expected: int) -> bytes:
    """The plain version of ``native.packbits_decode``."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 128:
            cnt = ctrl + 1
            if i + cnt > n:
                raise RleError("Truncated PackBits literal run.")
            out += data[i:i + cnt]
            i += cnt
        elif ctrl > 128:
            if i >= n:
                raise RleError("Truncated PackBits replicate run.")
            out += data[i:i + 1] * (257 - ctrl)
            i += 1
        # ctrl == 128: no-op
    if len(out) < expected:
        raise RleError(
            f"PackBits stream too short: {len(out)} < {expected} bytes.")
    return bytes(out[:expected])


def packbits_encode(data: bytes) -> bytes:
    """Encode ``data`` with PackBits (replicate runs ≥3, literals ≤128)."""
    if _native.disabled():
        return _packbits_encode_py(data)
    return _native.packbits_encode(bytes(data))


def _packbits_encode_py(data: bytes) -> bytes:
    """The plain version of ``native.packbits_encode``."""
    data = bytes(data)
    n = len(data)
    if n == 0:
        return b""
    d = np.frombuffer(data, np.uint8)
    # run_end[i]: one past the last byte of the run of equal bytes holding i
    bounds = np.append(np.flatnonzero(d[1:] != d[:-1]) + 1, n)
    run_end = np.repeat(bounds, np.diff(bounds, prepend=0)).tolist()
    # next3[i]: the first j >= i that starts a run of 3 equal bytes, else n
    starts = np.flatnonzero((d[:-2] == d[1:-1]) & (d[1:-1] == d[2:])) \
        if n >= 3 else np.zeros(0, np.int64)
    next3 = np.append(starts, n)[np.searchsorted(starts, np.arange(n + 1))
                                 ].tolist()
    out = bytearray()
    i = 0
    while i < n:
        run = min(run_end[i] - i, 128)
        if run >= 3:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal block: up to the next replicate run of ≥3 (or 128 bytes)
        j = min(next3[i + 1], i + 128, n)
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def decode_frame(fragment: bytes, rows: int, cols: int, samples: int,
                 bytes_per_sample: int) -> np.ndarray:
    """One RLE fragment → flat uint-composed pixel array.

    Returns a 1-D array of ``rows*cols*samples`` unsigned integers of width
    ``bytes_per_sample`` (caller views signed / reshapes).
    """
    if len(fragment) < _HEADER_LEN:
        raise RleError("RLE fragment shorter than its 64-byte header.")
    n_seg = struct.unpack("<I", fragment[:4])[0]
    offsets = struct.unpack("<15I", fragment[4:_HEADER_LEN])
    expected_segs = samples * bytes_per_sample
    if n_seg != expected_segs:
        raise RleError(
            f"RLE header advertises {n_seg} segments, geometry needs "
            f"{expected_segs} (samples={samples} × {bytes_per_sample} B).")
    if n_seg < 1 or n_seg > _MAX_SEGMENTS:
        raise RleError(f"RLE segment count {n_seg} out of range 1..15.")
    npix = rows * cols
    bounds = list(offsets[:n_seg]) + [len(fragment)]
    planes = []
    for s in range(n_seg):
        start, end = bounds[s], bounds[s + 1]
        if not (_HEADER_LEN <= start <= end <= len(fragment)):
            raise RleError("RLE segment offsets out of order / range.")
        planes.append(np.frombuffer(
            packbits_decode(fragment[start:end], npix), dtype=np.uint8))

    out_dtype = np.dtype(f"<u{bytes_per_sample}")
    out = np.zeros(npix * samples, dtype=out_dtype)
    # segment order: per sample, MSB plane → LSB plane (PS3.5 G.2)
    for s in range(samples):
        val = planes[s * bytes_per_sample].astype(out_dtype)
        for b in range(1, bytes_per_sample):
            val = (val << out_dtype.type(8)) | planes[s * bytes_per_sample + b]
        out[s::samples] = val  # interleave samples back into composite order
    return out


def encode_frame(frame: np.ndarray) -> bytes:
    """Flat/2-D/3-D frame of (u)int8/16/32 samples → one RLE fragment.

    ``frame`` is ``[rows, cols]`` or ``[rows, cols, samples]`` (or already
    flat in composite order).
    """
    samples = frame.shape[-1] if frame.ndim == 3 else 1
    bps = frame.dtype.itemsize
    n_seg = samples * bps
    if n_seg > _MAX_SEGMENTS:
        raise RleError(f"{n_seg} segments exceed the RLE limit of 15.")
    # big-endian byte view: [npix, samples*bps] with MSB-first per sample
    be = np.ascontiguousarray(frame).astype(
        frame.dtype.newbyteorder(">")).view(np.uint8)
    planes = be.reshape(-1, n_seg).T  # [n_seg, npix]

    segments = []
    for plane in planes:
        seg = packbits_encode(plane.tobytes())
        if len(seg) % 2:
            seg += b"\x00"  # PS3.5 G.3.1: segments are even-length
        segments.append(seg)

    offsets = []
    pos = _HEADER_LEN
    for seg in segments:
        offsets.append(pos)
        pos += len(seg)
    header = struct.pack(
        "<16I", n_seg, *(offsets + [0] * (_MAX_SEGMENTS - len(offsets))))
    return header + b"".join(segments)
