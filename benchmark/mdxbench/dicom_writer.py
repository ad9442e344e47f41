"""Part-10 DICOM writer that makes the benchmark's input files.

Frozen copy of ``mdx_torch/io/dicom_write.py`` at commit 3b08b1a (its
``write_dicom`` on the Explicit VR Little Endian path, ``_el``,
``_image_elements`` and ``_write_part10``), kept here so that the inputs do
not move when the program's writer changes.  One departure: ``bits_stored``
writes BitsStored and HighBit apart from BitsAllocated (the original writes
the container's width for both), since a CT slice stores 12 bits in a
16-bit container.
"""

from __future__ import annotations

import struct

import numpy as np

TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_SOP_CLASS_SC = "1.2.840.10008.5.1.4.1.1.7"  # Secondary Capture
_SOP_UID = "1.2.826.0.1.3680043.9.9999.1.1"
_TEXT_VRS = (b"CS", b"DS", b"IS", b"LO", b"SH", b"ST", b"PN", b"AE")


def _el(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        # PS3.5: text VRs pad to even length with SPACE, UI and binary with NUL
        value += b" " if vr in _TEXT_VRS else b"\x00"
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def _txt(s: str) -> bytes:
    return s.encode("ascii")


def _image_elements(modality: str, study_description: str, body_part: str,
                    photometric: str, rows: int, cols: int, bits: int,
                    bits_stored: int, signed: bool) -> bytes:
    """The dataset's elements up to the pixel module's last, in tag order."""
    return b"".join([
        _el(0x0008, 0x0016, b"UI", _txt(_SOP_CLASS_SC)),
        _el(0x0008, 0x0018, b"UI", _txt(_SOP_UID)),
        _el(0x0008, 0x0060, b"CS", _txt(modality)),
        _el(0x0008, 0x1030, b"LO", _txt(study_description)),
        _el(0x0018, 0x0015, b"CS", _txt(body_part)),
        _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        _el(0x0028, 0x0004, b"CS", _txt(photometric)),
        _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0101, b"US", struct.pack("<H", bits_stored)),
        _el(0x0028, 0x0102, b"US", struct.pack("<H", bits_stored - 1)),
        _el(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0)),
    ])


def write_dicom(path: str, pixels: np.ndarray, *, modality: str,
                body_part: str, study_description: str = "mdx benchmark",
                photometric: str = "MONOCHROME2",
                rescale_slope: float | None = None,
                rescale_intercept: float | None = None,
                window_center: float | None = None,
                window_width: float | None = None,
                bits_stored: int | None = None) -> str:
    """Write one 2-D uint16 or int16 frame to ``path`` (Explicit VR LE)."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype not in (np.uint16, np.int16) or pixels.ndim != 2:
        raise ValueError(f"expected a 2-D uint16 or int16 frame, got "
                         f"{pixels.dtype} {pixels.shape}")
    rows, cols = pixels.shape
    signed = pixels.dtype == np.int16
    body = _image_elements(modality, study_description, body_part,
                           photometric, rows, cols, 16, bits_stored or 16,
                           signed)
    if window_center is not None:
        body += _el(0x0028, 0x1050, b"DS", _txt(f"{window_center:g}"))
    if window_width is not None:
        body += _el(0x0028, 0x1051, b"DS", _txt(f"{window_width:g}"))
    if rescale_intercept is not None:
        body += _el(0x0028, 0x1052, b"DS", _txt(f"{rescale_intercept:g}"))
    if rescale_slope is not None:
        body += _el(0x0028, 0x1053, b"DS", _txt(f"{rescale_slope:g}"))
    body += _el(0x7FE0, 0x0010, b"OW",
                pixels.astype(pixels.dtype.newbyteorder("<")).tobytes())
    meta_elements = b"".join([
        _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
        _el(0x0002, 0x0002, b"UI", _txt(_SOP_CLASS_SC)),
        _el(0x0002, 0x0003, b"UI", _txt(_SOP_UID)),
        _el(0x0002, 0x0010, b"UI", _txt(TS_EXPLICIT_LE)),
        _el(0x0002, 0x0012, b"UI", _txt("1.2.826.0.1.3680043.9.9999")),
    ])
    meta = (_el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_elements)))
            + meta_elements)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(meta)
        f.write(body)
    return path
