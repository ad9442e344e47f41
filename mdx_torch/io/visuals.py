"""Before/after PNGs, written with ``zlib`` and ``struct`` alone.

Counterpart of ``mdx/io/visuals.py`` (ref pipeline/dicom_io.py:99-146),
with the same file names and dict keys.  The JAX package draws with
matplotlib, which the card's machine does not have, so the port writes an
8-bit grayscale PNG itself: each panel min-max scaled to 0..255 as
``imshow(cmap="gray")`` scales it, the two panels side by side with a
white gap, no titles, and no window is ever opened.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

import numpy as np

_GAP = 8          # white columns between the panels
_LEVEL = 1        # zlib level: the PNG is written on every run
_PIECE = 1 << 20  # bytes of rows a thread deflates


def to_gray8(image: np.ndarray) -> np.ndarray:
    """[H, W] → uint8 0..255, min-max scaled; constant or non-finite
    pixels → 0."""
    img = np.array(image, np.float32)
    finite = np.isfinite(img)
    if not finite.all():
        if not finite.any():
            return np.zeros(img.shape, np.uint8)
        img[~finite] = img[finite].min()
    lo, hi = float(img.min()), float(img.max())
    img -= lo
    img *= np.float32(255.0 / (hi - lo) if hi > lo else 0.0)
    np.rint(img, out=img)
    np.clip(img, 0, 255, out=img)
    return img.astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _deflate(data: bytes) -> bytes:
    """One zlib stream of ``data``, its pieces deflated on threads (zlib
    releases the GIL): each piece a raw deflate ended by a sync flush (on a
    byte boundary, not final) and the last by the final block, between the
    zlib header and the Adler-32 of the whole, as pigz does."""
    from concurrent.futures import ThreadPoolExecutor

    def piece(i: int) -> bytes:
        c = zlib.compressobj(_LEVEL, zlib.DEFLATED, -15)
        last = i + _PIECE >= len(data)
        return c.compress(data[i:i + _PIECE]) + c.flush(
            zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    starts = range(0, max(len(data), 1), _PIECE)
    with ThreadPoolExecutor(max_workers=min(len(starts), 8)) as pool:
        body = b"".join(pool.map(piece, starts))
    return b"\x78\x01" + body + struct.pack(">I", zlib.adler32(data))


def write_png(path: str, gray: np.ndarray) -> str:
    """An 8-bit grayscale [H, W] uint8 array → PNG file (filter 0 rows)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), gray], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + _chunk(b"IDAT", _deflate(rows.tobytes()))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def read_png(path: str) -> np.ndarray:
    """Decode a PNG that :func:`write_png` wrote → [H, W] uint8 (checks
    the signature, every chunk's CRC, the header and the row filters)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit grayscale PNG: {hdr}")
    w, h = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8
                         ).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: row filters other than 0")
    return rows[:, 1:].copy()


def side_by_side(original: np.ndarray, enhanced: np.ndarray) -> np.ndarray:
    """The before/after panel: both images as 8-bit gray, a white gap."""
    a, b = to_gray8(original), to_gray8(enhanced)
    h = max(a.shape[0], b.shape[0])
    out = np.full((h, a.shape[1] + _GAP + b.shape[1]), 255, np.uint8)
    out[:a.shape[0], :a.shape[1]] = a
    out[:b.shape[0], a.shape[1] + _GAP:] = b
    return out


def save_visuals(original: np.ndarray, enhanced: np.ndarray,
                 out_dir: str, base_name: str) -> Dict[str, str]:
    """Save the side-by-side before/after comparison PNG."""
    os.makedirs(out_dir, exist_ok=True)
    figure_path = os.path.join(out_dir, f"{base_name}_before_after.png")
    write_png(figure_path, side_by_side(original, enhanced))
    return {"before_after": figure_path}


def save_single_image(image: np.ndarray, out_path: str, title: str = "") -> str:
    """Save one image as an 8-bit grayscale PNG (``title`` is accepted for
    the JAX package's signature; the port draws no text)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    return write_png(out_path, to_gray8(image))
