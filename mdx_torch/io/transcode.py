"""DICOM transfer-syntax transcoding: archive normalisation.

The port's copy of ``mdx/io/transcode.py``; a CPU test holds its output
files byte-equal to the original's for every source syntax and target.

``transcode(src, dst, target_ts)`` rewrites a DICOM part-10 file into
another transfer syntax while preserving EVERY dataset element byte-for-
byte (private tags, sequences, unknown attributes included) — only the
file meta's TransferSyntaxUID and the PixelData element change.  This is
what the codecs exist for operationally: pull a lossy `.4.50` ultrasound
or a plugin-hostile `.4.70` CT out of an archive and normalise it to
Explicit-LE / RLE / JPEG-LL / JPEG-LS / JPEG 2000 Lossless without
touching the rest of the object.

Element fidelity rules:

* Explicit-VR LE / Deflated / encapsulated sources: the dataset body is
  already Explicit-LE encoded, so non-pixel elements are copied as RAW
  BYTE SPANS (undefined-length sequences included, located with the
  reader's sequence walker) — nothing is reinterpreted.
* Implicit-VR LE sources: elements are re-encoded Explicit with the VR
  from a dictionary of common tags; unknown tags carry VR ``UN``
  (PS3.5 6.2.2) and undefined-length sequences become ``UN`` with
  undefined length, whose contents the standard defines as Implicit-LE
  — the body bytes are copied verbatim, staying conformant without
  guessing VRs.
* Explicit-VR Big Endian sources raise: honest byte-swapping of
  arbitrary unknown VRs is not possible, and the syntax is retired.

Pixel handling: frames decode through
:func:`mdx_torch.io.dicom.decode_pixels` (so every readable syntax is a
valid source, lossy ones included) and re-encode through the writer's
encapsulation helpers.  Color (3-sample) sources transcode to Explicit LE
(or deflated) only — the lossless codecs here are single-component — and
because the replacement pixels are interleaved
4:4:4, subsampled photometrics are rewritten (YBR_FULL_422 → YBR_FULL)
and PlanarConfiguration is forced to 0 (inserted if the source lacked
it); unmappable color photometrics are refused.  Lossy targets are
refused (decode-only stance).

CLI: ``python -m mdx_torch.io.transcode src.dcm dst.dcm --to jpeg-ls``.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import BinaryIO, Dict, Tuple

import numpy as np

from mdx_torch.io.dicom import (
    _UNDEFINED,
    TS_DEFLATED_LE,
    TS_EXPLICIT_BE,
    TS_EXPLICIT_LE,
    TS_IMPLICIT_LE,
    TS_J2K,
    TS_J2K_LOSSLESS,
    TS_JPEG_BASELINE,
    TS_JPEG_EXTENDED,
    TS_JPEG_LL,
    TS_JPEG_LL_SV1,
    TS_JPEG_LS,
    TS_JPEG_LS_NEAR,
    TS_RLE,
    DicomError,
    _read_file_meta,
    _skip_sequence,
    decode_pixels,
    read_dataset,
)

__all__ = ["transcode", "TARGET_ALIASES"]

TARGET_ALIASES = {
    "explicit-le": TS_EXPLICIT_LE,
    "deflated": TS_DEFLATED_LE,
    "rle": TS_RLE,
    "jpeg-ll": TS_JPEG_LL_SV1,
    "jpeg-ls": TS_JPEG_LS,
    "j2k": TS_J2K_LOSSLESS,
}

_LOSSY_TS = {TS_JPEG_BASELINE, TS_JPEG_EXTENDED, TS_JPEG_LS_NEAR}
_PIXEL_TAG = (0x7FE0, 0x0010)

# VR dictionary for implicit→explicit conversion of common tags; anything
# absent is written as UN (legal per PS3.5 6.2.2).
_VR_DICT: Dict[Tuple[int, int], bytes] = {
    (0x0008, 0x0005): b"CS", (0x0008, 0x0008): b"CS",
    (0x0008, 0x0016): b"UI", (0x0008, 0x0018): b"UI",
    (0x0008, 0x0020): b"DA", (0x0008, 0x0030): b"TM",
    (0x0008, 0x0060): b"CS", (0x0008, 0x1030): b"LO",
    (0x0010, 0x0010): b"PN", (0x0010, 0x0020): b"LO",
    (0x0018, 0x0015): b"CS",
    (0x0020, 0x000D): b"UI", (0x0020, 0x000E): b"UI",
    (0x0020, 0x0013): b"IS",
    (0x0028, 0x0002): b"US", (0x0028, 0x0004): b"CS",
    (0x0028, 0x0006): b"US", (0x0028, 0x0008): b"IS",
    (0x0028, 0x0010): b"US", (0x0028, 0x0011): b"US",
    (0x0028, 0x0100): b"US", (0x0028, 0x0101): b"US",
    (0x0028, 0x0102): b"US", (0x0028, 0x0103): b"US",
    (0x0028, 0x1050): b"DS", (0x0028, 0x1051): b"DS",
    (0x0028, 0x1052): b"DS", (0x0028, 0x1053): b"DS",
}

_LONG_EXPLICIT = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}


def _body_bytes(path: str) -> Tuple[str, bytes, Dict[str, str]]:
    """(source_ts, dataset body bytes, meta UIDs of interest)."""
    with open(path, "rb") as f:
        preamble = f.read(132)
        if len(preamble) >= 132 and preamble[128:132] == b"DICM":
            ts = _read_file_meta(f)
        else:
            f.seek(0)
            ts = TS_IMPLICIT_LE
        body = f.read()
    if ts == TS_DEFLATED_LE:
        try:
            body = zlib.decompressobj(-15).decompress(body)
        except zlib.error as exc:
            raise DicomError(f"Corrupt deflated stream: {exc}") from exc
        ts = TS_EXPLICIT_LE  # body is now plain explicit LE
    return ts, body, {}


def _walk_spans(body: bytes, explicit: bool):
    """Yield (tag, vr, value_span_or_None, element_span) over the top
    level of the dataset body.  ``element_span`` covers the WHOLE raw
    element (header + value + any sequence delimiters); ``vr`` is b'UN'
    for implicit streams."""
    f: BinaryIO = io.BytesIO(body)
    while True:
        start = f.tell()
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        group, elem = struct.unpack("<HH", hdr[:4])
        tag = (group, elem)
        if explicit:
            vr = hdr[4:6]
            if vr in _LONG_EXPLICIT or not (65 <= vr[0] <= 90):
                # long form (or implicit-looking garbage -> error later)
                if vr in _LONG_EXPLICIT:
                    (length,) = struct.unpack("<I", f.read(4))
                else:
                    raise DicomError(
                        f"Unparseable element header at offset {start}.")
            else:
                (length,) = struct.unpack("<H", hdr[6:8])
        else:
            vr = b"UN"
            (length,) = struct.unpack("<I", hdr[4:8])
        if length == _UNDEFINED:
            _skip_sequence(f, explicit, False)
            end = f.tell()
            yield tag, vr, None, (start, end)
        else:
            val_start = f.tell()
            f.seek(length, os.SEEK_CUR)
            end = f.tell()
            if end > len(body):
                raise DicomError("Truncated element value.")
            yield tag, vr, (val_start, end), (start, end)


def _explicit_el(tag: Tuple[int, int], vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00"
    head = struct.pack("<HH", *tag) + vr
    if vr in _LONG_EXPLICIT:
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    if len(value) > 0xFFFF:
        raise DicomError(f"Value too long for short VR {vr!r}.")
    return head + struct.pack("<H", len(value)) + value


def _undefined_un(tag: Tuple[int, int], raw_body: bytes) -> bytes:
    """UN, undefined length: contents are Implicit-LE per PS3.5 6.2.2."""
    return (struct.pack("<HH", *tag) + b"UN\x00\x00"
            + struct.pack("<I", _UNDEFINED) + raw_body)


def _encode_pixels(ds, target_ts: str) -> bytes:
    """The replacement (7FE0,0010) element bytes for ``target_ts``."""
    from mdx_torch.io.dicom_write import (
        _encapsulated_jpeg2k,
        _encapsulated_jpegll,
        _encapsulated_jpegls,
        _encapsulated_rle,
    )

    arr = decode_pixels(ds)
    rows, cols = ds.get("Rows"), ds.get("Columns")
    samples = ds.get("SamplesPerPixel", 1) or 1
    frames = ds.get("NumberOfFrames", 1) or 1
    bits = ds.get("BitsAllocated", 16)
    if target_ts in (TS_EXPLICIT_LE, TS_DEFLATED_LE):
        # deflated = the same Explicit-LE body, raw-deflated afterwards
        pix = np.ascontiguousarray(arr)
        pix = pix.astype(pix.dtype.newbyteorder("<"))
        vr = b"OW" if bits == 16 else b"OB"
        return _explicit_el(_PIXEL_TAG, vr, pix.tobytes())
    if samples != 1:
        raise DicomError(
            "Color pixel data transcodes to Explicit LE only "
            "(the lossless codecs here are single-component).")
    if bits not in (8, 16):
        raise DicomError(
            f"BitsAllocated={bits} unsupported for encapsulated targets.")
    stack = np.ascontiguousarray(arr).reshape(frames, rows, cols)
    if target_ts == TS_RLE:
        return _encapsulated_rle(stack)
    if target_ts == TS_JPEG_LL_SV1:
        return _encapsulated_jpegll(stack, bits)
    if target_ts == TS_JPEG_LS:
        return _encapsulated_jpegls(stack, bits)
    if target_ts == TS_J2K_LOSSLESS:
        signed = (ds.get("PixelRepresentation", 0) or 0) == 1
        return _encapsulated_jpeg2k(stack, bits, signed)
    raise DicomError(f"Unsupported transcode target {target_ts!r}.")


def _color_conformance(ds) -> str:
    """Photometric replacement (or '') for color sources whose pixels are
    re-written as interleaved 4:4:4 — the stored value may imply a packing
    the replacement pixels no longer have (the `.4.50` YBR_FULL_422
    ultrasound case: decoders upsample chroma, so preserving the stored
    photometric byte-for-byte would yield a non-conformant file whose
    photometric promises 2-samples-per-2-pixels packing)."""
    pm = str(ds.get("PhotometricInterpretation", "") or "").strip().upper()
    if pm in ("RGB", "YBR_FULL", ""):
        return ""           # already describes full interleaved samples
    if pm == "YBR_FULL_422":
        return "YBR_FULL"   # chroma upsampled to 4:4:4, range unchanged
    if pm in ("YBR_RCT", "YBR_ICT"):
        # JPEG 2000 color: the decoder inverts the MCT, so the
        # replacement pixels are RGB samples
        return "RGB"
    raise DicomError(
        f"Color source with PhotometricInterpretation={pm!r} cannot be "
        "re-written conformantly as interleaved 4:4:4 samples.")


def transcode(src_path: str, dst_path: str, target_ts: str) -> str:
    """Rewrite ``src_path`` as ``dst_path`` in ``target_ts``; all
    non-pixel dataset elements are preserved (see module docstring)."""
    target_ts = TARGET_ALIASES.get(target_ts, target_ts)
    if target_ts not in (TS_EXPLICIT_LE, TS_DEFLATED_LE, TS_RLE,
                         TS_JPEG_LL_SV1, TS_JPEG_LS, TS_J2K_LOSSLESS):
        if target_ts in _LOSSY_TS | {TS_JPEG_LL, TS_JPEG_LS_NEAR,
                                     TS_J2K}:
            raise DicomError(
                f"Refusing lossy/unwritable target {target_ts!r} "
                "(decode-only stance for lossy syntaxes).")
        raise DicomError(f"Unknown transcode target {target_ts!r}.")
    src_ts, body, _meta = _body_bytes(src_path)
    if src_ts == TS_EXPLICIT_BE:
        raise DicomError(
            "Explicit VR Big Endian sources cannot be transcoded "
            "faithfully (unknown-VR byte order); convert externally.")
    explicit = src_ts != TS_IMPLICIT_LE

    ds = read_dataset(src_path)  # typed view for the pixel work
    if not ds.pixel_bytes and ds.fragments is None:
        raise DicomError("Source has no pixel data to transcode.")
    samples = ds.get("SamplesPerPixel", 1) or 1
    pm_rewrite = _color_conformance(ds) if samples != 1 else ""

    out_body = bytearray()
    sop_class = sop_inst = ""
    saw_pixels = False
    planar_done = samples == 1
    for tag, vr, vspan, espan in _walk_spans(body, explicit):
        if tag[0] == 0x0002:
            continue  # never valid in a body; skip defensively
        if not planar_done and tag > (0x0028, 0x0006):
            # PlanarConfiguration is Type 1C (required when
            # SamplesPerPixel>1) and the replacement pixels are
            # interleaved — insert it in tag order if the source lacks it
            out_body += _explicit_el((0x0028, 0x0006), b"US",
                                     struct.pack("<H", 0))
            planar_done = True
        if tag == _PIXEL_TAG:
            saw_pixels = True
            out_body += _encode_pixels(ds, target_ts)
            continue
        if tag == (0x0028, 0x0004) and pm_rewrite:
            out_body += _explicit_el(tag, b"CS",
                                     pm_rewrite.encode("ascii"))
            continue
        if tag == (0x0028, 0x0006) and samples != 1:
            out_body += _explicit_el(tag, b"US", struct.pack("<H", 0))
            planar_done = True
            continue
        if tag in ((0x0008, 0x0016), (0x0008, 0x0018)) and vspan:
            text = body[vspan[0]:vspan[1]].decode(
                "ascii", errors="replace").strip("\x00 ")
            if tag == (0x0008, 0x0016):
                sop_class = text
            else:
                sop_inst = text
        if explicit:
            out_body += body[espan[0]:espan[1]]
        elif vspan is None:
            hdr_len = 8
            out_body += _undefined_un(
                tag, body[espan[0] + hdr_len:espan[1]])
        else:
            value = body[vspan[0]:vspan[1]]
            out_body += _explicit_el(tag, _VR_DICT.get(tag, b"UN"), value)
    if not saw_pixels:
        raise DicomError("Source body has no (7FE0,0010) element.")

    def _meta_el(elem: int, vr: bytes, value: bytes) -> bytes:
        return _explicit_el((0x0002, elem), vr, value)

    def _txt(s: str) -> bytes:
        b = s.encode("ascii")
        return b + (b"\x00" if len(b) % 2 else b"")

    meta_elements = b"".join([
        _meta_el(0x0001, b"OB", b"\x00\x01"),
        _meta_el(0x0002, b"UI",
                 _txt(sop_class or "1.2.840.10008.5.1.4.1.1.7")),
        _meta_el(0x0003, b"UI",
                 _txt(sop_inst or "1.2.826.0.1.3680043.9.9999.1")),
        _meta_el(0x0010, b"UI", _txt(target_ts)),
        _meta_el(0x0012, b"UI", _txt("1.2.826.0.1.3680043.9.9999")),
    ])
    meta = _meta_el(0x0000, b"UL",
                    struct.pack("<I", len(meta_elements))) + meta_elements

    payload = bytes(out_body)
    if target_ts == TS_DEFLATED_LE:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        payload = co.compress(payload) + co.flush()
    with open(dst_path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(meta)
        f.write(payload)
    return dst_path


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Transcode a DICOM file between transfer syntaxes "
                    "(dataset elements preserved byte-for-byte).")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--to", default="explicit-le",
                    choices=sorted(TARGET_ALIASES),
                    help="target syntax (default explicit-le)")
    args = ap.parse_args()
    transcode(args.src, args.dst, args.to)
    print(f"{args.src} -> {args.dst} [{TARGET_ALIASES[args.to]}]")


if __name__ == "__main__":
    _main()
