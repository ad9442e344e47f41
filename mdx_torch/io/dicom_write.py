"""Minimal DICOM writer for tests, demos and the smoke run.

The port's copy of ``mdx/io/dicom_write.py``; a CPU test holds its files
byte-equal to the original's for the same arguments.  Produces standard
part-10 files (preamble + DICM + file meta) carrying MONOCHROME1/2 pixel
data, readable by :mod:`mdx_torch.io.dicom` and by any standard DICOM
toolkit.  Transfer syntaxes: Explicit VR Little Endian (default), RLE
Lossless (encapsulated, ``mdx_torch.io.rle``), JPEG Lossless SV1
``1.2.840.10008.1.2.4.70`` (encapsulated, ``mdx_torch.io.jpegll``),
JPEG-LS Lossless ``1.2.840.10008.1.2.4.80`` (encapsulated,
``mdx_torch.io.jpegls``), JPEG 2000 Lossless ``1.2.840.10008.1.2.4.90``
(encapsulated, ``mdx_torch.io.jpeg2k``) and Deflated Explicit VR LE (zlib
raw deflate of the post-meta stream, PS3.5 A.5).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mdx_torch.io.dicom import (TS_DEFLATED_LE, TS_EXPLICIT_LE,
                                TS_J2K_LOSSLESS, TS_JPEG_LL_SV1, TS_JPEG_LS,
                                TS_RLE)

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
    if transfer_syntax not in (TS_EXPLICIT_LE, TS_RLE, TS_DEFLATED_LE,
                               TS_JPEG_LL_SV1, TS_JPEG_LS,
                               TS_J2K_LOSSLESS):
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

    body = _image_elements(modality, study_description, body_part, 1,
                           photometric, frames, rows, cols, bits, signed)
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
    elif transfer_syntax == TS_J2K_LOSSLESS:
        body += _encapsulated_jpeg2k(pixels.reshape(frames, rows, cols),
                                     bits, signed)
    else:
        pixel_bytes = pixels.astype(pixels.dtype.newbyteorder("<")).tobytes()
        body += _el(0x7FE0, 0x0010, b"OW" if bits == 16 else b"OB",
                    pixel_bytes)

    return _write_part10(path, transfer_syntax, body)


_SOP_UID = "1.2.826.0.1.3680043.9.9999.1.1"


def _image_elements(modality: str, study_description: str, body_part: str,
                    samples: int, photometric: str, frames: int, rows: int,
                    cols: int, bits: int, signed: bool) -> bytes:
    """The dataset's elements up to the pixel module's last, in tag order."""
    body = b"".join([
        _el(0x0008, 0x0016, b"UI", _txt(_SOP_CLASS_SC)),
        _el(0x0008, 0x0018, b"UI", _txt(_SOP_UID)),
        _el(0x0008, 0x0060, b"CS", _txt(modality)),
        _el(0x0008, 0x1030, b"LO", _txt(study_description)),
        _el(0x0018, 0x0015, b"CS", _txt(body_part)),
        _el(0x0028, 0x0002, b"US", struct.pack("<H", samples)),
        _el(0x0028, 0x0004, b"CS", _txt(photometric)),
    ])
    if samples > 1:
        body += _el(0x0028, 0x0006, b"US", struct.pack("<H", 0))
    if frames > 1:
        body += _el(0x0028, 0x0008, b"IS", _txt(str(frames)))
    return body + b"".join([
        _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0101, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0102, b"US", struct.pack("<H", bits - 1)),
        _el(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0)),
    ])


def _write_part10(path: str, transfer_syntax: str, body: bytes) -> str:
    """Preamble, file meta and ``body`` (deflated for that syntax)."""
    meta_elements = b"".join([
        _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
        _el(0x0002, 0x0002, b"UI", _txt(_SOP_CLASS_SC)),
        _el(0x0002, 0x0003, b"UI", _txt(_SOP_UID)),
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


def _fragments(frags) -> bytes:
    """Encapsulated PixelData: an empty offset table, one item a fragment
    (padded to even length), the sequence delimiter."""
    out = [struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF),
           struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
    for frag in frags:
        if len(frag) % 2:
            frag += b"\x00"
        out.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag)
    out.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return b"".join(out)


def write_codestreams(path: str, streams: list, rows: int, cols: int, *,
                      transfer_syntax: str, bits: int = 16,
                      samples: int = 1, photometric: str = "MONOCHROME2",
                      signed: bool = False, modality: str = "CT",
                      body_part: str = "CHEST",
                      study_description: str = "mdx synthetic") -> str:
    """Write frame codestreams another encoder made, one fragment a frame,
    as an encapsulated part-10 file of ``transfer_syntax`` (for example a
    ``.4.91`` JPEG 2000 file from irreversible 9/7 codestreams, which no
    encoder of the port writes).  The streams are written as given."""
    body = _image_elements(modality, study_description, body_part, samples,
                           photometric, len(streams), rows, cols, bits,
                           signed)
    return _write_part10(path, transfer_syntax,
                         body + _fragments(bytes(s) for s in streams))


def _encapsulated_rle(frames_arr: np.ndarray) -> bytes:
    """[F, H, W] → encapsulated RLE PixelData element bytes."""
    from mdx_torch.io import rle

    return _fragments(rle.encode_frame(frame) for frame in frames_arr)


def _twos_complement(frame: np.ndarray, bits: int) -> np.ndarray:
    """A frame's unsigned two's-complement representation in ``bits``."""
    return (frame.astype(np.int64) & ((1 << bits) - 1)).astype(np.uint16)


def _encapsulated_jpegll(frames_arr: np.ndarray, bits: int) -> bytes:
    """[F, H, W] → encapsulated JPEG Lossless SV1 PixelData element bytes.

    Signed data is coded as its unsigned two's-complement representation
    at full container precision; the reader sign-extends from the
    codestream precision (see mdx_torch/io/dicom.py:_decode_jpegll).
    """
    from mdx_torch.io import jpegll

    return _fragments(
        jpegll.encode(_twos_complement(frame, bits), precision=bits,
                      predictor=1) for frame in frames_arr)


def _encapsulated_jpegls(frames_arr: np.ndarray, bits: int) -> bytes:
    """[F, H, W] → encapsulated JPEG-LS Lossless PixelData element bytes.

    Same signed-container convention as :func:`_encapsulated_jpegll`:
    signed data is coded as its unsigned two's-complement representation
    at full container precision and the reader sign-extends from the
    codestream precision (mdx_torch/io/dicom.py:_decode_jpegls).
    """
    from mdx_torch.io import jpegls

    return _fragments(jpegls.encode(_twos_complement(frame, bits),
                                    precision=bits) for frame in frames_arr)


def _encapsulated_jpeg2k(frames_arr: np.ndarray, bits: int,
                         signed: bool) -> bytes:
    """[F, H, W] → encapsulated JPEG 2000 Lossless PixelData bytes.

    Unlike the JPEG-LL/LS convention, J2K codes signedness in the
    codestream itself (SIZ sign flag, no DC shift for signed data), and
    the reader cross-checks it against PixelRepresentation
    (mdx_torch/io/dicom.py:_decode_jpeg2k)."""
    from mdx_torch.io import jpeg2k

    # depth follows the container: int8 keeps an 8-bit SIZ (a 16-bit
    # codestream in a BitsAllocated=8 container would be refused by the
    # reader's p > bits check)
    if signed:
        dt = np.int8 if bits == 8 else np.int16
    else:
        dt = np.uint8 if bits == 8 else np.uint16
    return _fragments(jpeg2k.encode(frame.astype(dt), signed=signed)
                      for frame in frames_arr)


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
