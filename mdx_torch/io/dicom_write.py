"""Minimal DICOM writer for tests, demos and the smoke run.

The port's copy of ``mdx/io/dicom_write.py``; a CPU test holds its files
byte-equal to the original's for the same arguments.  Produces standard
part-10 files (preamble + DICM + file meta) carrying MONOCHROME1/2 pixel
data, readable by :mod:`mdx_torch.io.dicom` and by any standard DICOM
toolkit.  Transfer syntaxes: Explicit VR Little Endian (default), RLE
Lossless (encapsulated, ``mdx_torch.io.rle``), JPEG Lossless SV1
``1.2.840.10008.1.2.4.70`` (encapsulated, ``mdx_torch.io.jpegll``),
JPEG-LS Lossless ``1.2.840.10008.1.2.4.80`` (encapsulated,
``mdx_torch.io.jpegls``) and Deflated Explicit VR LE (zlib raw deflate of
the post-meta stream, PS3.5 A.5).  JPEG 2000 Lossless, which the JAX
package also writes, raises ``ValueError`` until the port has its codec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mdx_torch.io.dicom import (JPEG_FAMILY_TS, TS_DEFLATED_LE,
                                TS_EXPLICIT_LE, TS_J2K_LOSSLESS,
                                TS_JPEG_LL_SV1, TS_JPEG_LS, TS_RLE)

_SOP_CLASS_SC = "1.2.840.10008.5.1.4.1.1.7"  # Secondary Capture


_TEXT_VRS = (b"CS", b"DS", b"IS", b"LO", b"SH", b"ST", b"PN", b"AE")


def _el(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        # DICOM PS3.5: text VRs pad to even length with SPACE; UI and
        # binary VRs pad with NUL
        value += b" " if vr in _TEXT_VRS else b"\x00"
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def _txt(s: str) -> bytes:
    return s.encode("ascii")


def write_dicom(
    path: str,
    pixels: np.ndarray,
    *,
    modality: str = "CT",
    body_part: str = "CHEST",
    study_description: str = "mdx synthetic",
    photometric: str = "MONOCHROME2",
    rescale_slope: float | None = None,
    rescale_intercept: float | None = None,
    window_center: float | None = None,
    window_width: float | None = None,
    signed: bool = False,
    transfer_syntax: str = TS_EXPLICIT_LE,
) -> str:
    """Write ``pixels`` (uint8/uint16/int16 2-D or [F,H,W] 3-D) to *path*."""
    if transfer_syntax == TS_J2K_LOSSLESS:
        raise ValueError(
            f"transfer syntax {transfer_syntax} "
            f"({JPEG_FAMILY_TS[transfer_syntax]}) is not yet in mdx_torch "
            "(ROADMAP Queue 1: the codec slice)")
    if transfer_syntax not in (TS_EXPLICIT_LE, TS_RLE, TS_DEFLATED_LE,
                               TS_JPEG_LL_SV1, TS_JPEG_LS):
        raise ValueError(f"unsupported transfer syntax {transfer_syntax!r}")
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype == np.uint8:
        bits = 8
    elif pixels.dtype == np.int8:
        bits = 8
        signed = True
    elif pixels.dtype in (np.uint16, np.int16):
        bits = 16
        signed = signed or pixels.dtype == np.int16
    else:
        raise ValueError(f"unsupported pixel dtype {pixels.dtype}")
    if pixels.ndim == 2:
        frames, (rows, cols) = 1, pixels.shape
    elif pixels.ndim == 3:
        frames, rows, cols = pixels.shape
    else:
        raise ValueError("pixels must be 2-D or 3-D")

    sop_uid = "1.2.826.0.1.3680043.9.9999.1.1"
    body = b"".join([
        _el(0x0008, 0x0016, b"UI", _txt(_SOP_CLASS_SC)),
        _el(0x0008, 0x0018, b"UI", _txt(sop_uid)),
        _el(0x0008, 0x0060, b"CS", _txt(modality)),
        _el(0x0008, 0x1030, b"LO", _txt(study_description)),
        _el(0x0018, 0x0015, b"CS", _txt(body_part)),
        _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        _el(0x0028, 0x0004, b"CS", _txt(photometric)),
    ])
    if frames > 1:
        body += _el(0x0028, 0x0008, b"IS", _txt(str(frames)))
    body += b"".join([
        _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0101, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0102, b"US", struct.pack("<H", bits - 1)),
        _el(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0)),
    ])
    if window_center is not None:
        body += _el(0x0028, 0x1050, b"DS", _txt(f"{window_center:g}"))
    if window_width is not None:
        body += _el(0x0028, 0x1051, b"DS", _txt(f"{window_width:g}"))
    if rescale_intercept is not None:
        body += _el(0x0028, 0x1052, b"DS", _txt(f"{rescale_intercept:g}"))
    if rescale_slope is not None:
        body += _el(0x0028, 0x1053, b"DS", _txt(f"{rescale_slope:g}"))
    if transfer_syntax == TS_RLE:
        body += _encapsulated_rle(pixels.reshape(frames, rows, cols))
    elif transfer_syntax == TS_JPEG_LL_SV1:
        body += _encapsulated_jpegll(pixels.reshape(frames, rows, cols), bits)
    elif transfer_syntax == TS_JPEG_LS:
        body += _encapsulated_jpegls(pixels.reshape(frames, rows, cols), bits)
    else:
        pixel_bytes = pixels.astype(pixels.dtype.newbyteorder("<")).tobytes()
        body += _el(0x7FE0, 0x0010, b"OW" if bits == 16 else b"OB",
                    pixel_bytes)

    meta_elements = b"".join([
        _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
        _el(0x0002, 0x0002, b"UI", _txt(_SOP_CLASS_SC)),
        _el(0x0002, 0x0003, b"UI", _txt(sop_uid)),
        _el(0x0002, 0x0010, b"UI", _txt(transfer_syntax)),
        _el(0x0002, 0x0012, b"UI", _txt("1.2.826.0.1.3680043.9.9999")),
    ])
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_elements))) + meta_elements

    if transfer_syntax == TS_DEFLATED_LE:
        # PS3.5 A.5: the file meta stays uncompressed; the dataset is one
        # raw-deflate stream.
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        body = co.compress(body) + co.flush()

    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(meta)
        f.write(body)
    return path


def _encapsulated_rle(frames_arr: np.ndarray) -> bytes:
    """[F, H, W] → encapsulated RLE PixelData element bytes."""
    from mdx_torch.io import rle

    out = [struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF),
           struct.pack("<HHI", 0xFFFE, 0xE000, 0)]  # empty offset table
    for frame in frames_arr:
        frag = rle.encode_frame(frame)
        if len(frag) % 2:
            frag += b"\x00"
        out.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag)
    out.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return b"".join(out)


def _encapsulated_jpegll(frames_arr: np.ndarray, bits: int) -> bytes:
    """[F, H, W] → encapsulated JPEG Lossless SV1 PixelData element bytes.

    Signed data is coded as its unsigned two's-complement representation
    at full container precision; the reader sign-extends from the
    codestream precision (see mdx_torch/io/dicom.py:_decode_jpegll).
    """
    from mdx_torch.io import jpegll

    out = [struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF),
           struct.pack("<HHI", 0xFFFE, 0xE000, 0)]  # empty offset table
    for frame in frames_arr:
        u = (frame.astype(np.int64) & ((1 << bits) - 1)).astype(np.uint16)
        frag = jpegll.encode(u, precision=bits, predictor=1)
        if len(frag) % 2:
            frag += b"\x00"
        out.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag)
    out.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return b"".join(out)


def _encapsulated_jpegls(frames_arr: np.ndarray, bits: int) -> bytes:
    """[F, H, W] → encapsulated JPEG-LS Lossless PixelData element bytes.

    Same signed-container convention as :func:`_encapsulated_jpegll`:
    signed data is coded as its unsigned two's-complement representation
    at full container precision and the reader sign-extends from the
    codestream precision (mdx_torch/io/dicom.py:_decode_jpegls).
    """
    from mdx_torch.io import jpegls

    out = [struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF),
           struct.pack("<HHI", 0xFFFE, 0xE000, 0)]  # empty offset table
    for frame in frames_arr:
        u = (frame.astype(np.int64) & ((1 << bits) - 1)).astype(np.uint16)
        frag = jpegls.encode(u, precision=bits)
        if len(frag) % 2:
            frag += b"\x00"
        out.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag)
    out.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return b"".join(out)


def write_synthetic_dicom(path: str, kind: str = "noisy", size: int = 256,
                          frames: int = 1, seed: int = 0, **kwargs) -> str:
    """Generate a synthetic test DICOM: 'noisy', 'low_contrast', 'clipped',
    'clean', or 'phantom' (12-bit CT-like with rescale)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / (size - 1)

    def _one(i):
        if kind == "noisy":
            img = 0.5 + 0.2 * (xx - 0.5) + rng.normal(0, 0.15, (size, size))
        elif kind == "low_contrast":
            img = 0.5 + 0.05 * np.tanh(rng.normal(0, 1, (size, size)))
        elif kind == "clipped":
            img = (xx - 0.25) * 2.0
        elif kind == "phantom":
            r = np.hypot(yy - 0.5, xx - 0.5)
            img = (r < 0.4).astype(float) * (0.6 + 0.3 * np.cos(8 * np.pi * r))
            img += rng.normal(0, 0.02, (size, size)) + 0.05 * i
        else:  # clean
            img = 0.25 + 0.5 * (xx + yy) / 2 + 0.05 * np.sin(xx * 12) * np.cos(yy * 17)
        return np.clip(img, 0.0, 1.0)

    stack = np.stack([_one(i) for i in range(frames)])
    if kind == "phantom":
        pix = (stack * 4095).astype(np.uint16)
        kwargs.setdefault("rescale_slope", 1.0)
        kwargs.setdefault("rescale_intercept", -1024.0)
    else:
        pix = (stack * 65535).astype(np.uint16)
    if frames == 1:
        pix = pix[0]
    return write_dicom(path, pix, **kwargs)
