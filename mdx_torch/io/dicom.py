"""From-scratch DICOM reader (no pydicom), on the host in numpy.

The port's copy of ``mdx/io/dicom.py``; a CPU test holds it equal to the
original, bit for bit, on files of every syntax it reads:

* Implicit VR Little Endian        1.2.840.10008.1.2
* Explicit VR Little Endian        1.2.840.10008.1.2.1
* Deflated Explicit VR LE          1.2.840.10008.1.2.1.99  (zlib raw inflate)
* Explicit VR Big Endian (retired) 1.2.840.10008.1.2.2
* RLE Lossless                     1.2.840.10008.1.2.5     (mdx_torch.io.rle)
* JPEG Lossless (Process 14)       1.2.840.10008.1.2.4.57  (mdx_torch.io.jpegll)
* JPEG Lossless SV1 (14, pred 1)   1.2.840.10008.1.2.4.70  (mdx_torch.io.jpegll)
* JPEG-LS Lossless                 1.2.840.10008.1.2.4.80  (mdx_torch.io.jpegls)
* JPEG-LS Near-Lossless            1.2.840.10008.1.2.4.81  (mdx_torch.io.jpegls)

plus headerless "raw" datasets (no preamble, implicit VR).  The compressed
frames of a multi-frame file decode on a thread pool (:func:`_map_frames`);
the codecs' entropy loops run in the port's host C++ library
(:mod:`mdx_torch.io.native`), which releases the GIL.  The JPEG-family
syntaxes the JAX package also decodes and the port does not yet (baseline
and extended DCT, JPEG 2000) raise :class:`CodecNotPorted`, naming the
transfer-syntax UID: their codecs are a later slice of the port.

Behavioural contract (ref pipeline/dicom_io.py:29-57): modality rescale
(slope/intercept), MONOCHROME1 inversion, grayscale / middle-slice
reduction, and the non-PHI metadata whitelist {Modality, BodyPartExamined,
StudyDescription}.  :func:`load_series` keeps all frames as [F, H, W].  The
modality rescale is float32 multiply, then add, in numpy: the JAX package
takes its C++ ``rescale_f32`` where that library is built, and that loop
is compiled into fused multiply-adds, one rounding instead of two, so for
a slope and intercept whose product does not round exactly the two differ
by one ulp on many pixels (ROADMAP Queue 3); the port matches the JAX
package's numpy body and its own raw-ingest bounds.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, Optional, Tuple

import numpy as np

from mdx_torch.io.normalize import normalize_image, to_grayscale, window_level


class DicomError(ValueError):
    """Invalid, truncated, or unsupported DICOM input."""


class CodecNotPorted(DicomError):
    """A transfer syntax the JAX package decodes and the port does not yet
    (DCT JPEG and JPEG 2000: ROADMAP Queue 1, the codec slice)."""


# Transfer syntaxes
TS_IMPLICIT_LE = "1.2.840.10008.1.2"
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
TS_DEFLATED_LE = "1.2.840.10008.1.2.1.99"
TS_EXPLICIT_BE = "1.2.840.10008.1.2.2"
TS_RLE = "1.2.840.10008.1.2.5"
TS_JPEG_LL = "1.2.840.10008.1.2.4.57"
TS_JPEG_LL_SV1 = "1.2.840.10008.1.2.4.70"
TS_JPEG_LS = "1.2.840.10008.1.2.4.80"
TS_JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
TS_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
TS_JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
TS_J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"
TS_J2K = "1.2.840.10008.1.2.4.91"
_ENCAPSULATED_TS = {TS_RLE, TS_JPEG_LL, TS_JPEG_LL_SV1,
                    TS_JPEG_LS, TS_JPEG_LS_NEAR}
_SUPPORTED_TS = {TS_IMPLICIT_LE, TS_EXPLICIT_LE, TS_DEFLATED_LE,
                 TS_EXPLICIT_BE} | _ENCAPSULATED_TS
# the JAX package's JPEG-family syntaxes, by name
JPEG_FAMILY_TS = {
    TS_JPEG_LL: "JPEG Lossless", TS_JPEG_LL_SV1: "JPEG Lossless SV1",
    TS_JPEG_LS: "JPEG-LS Lossless", TS_JPEG_LS_NEAR: "JPEG-LS Near-Lossless",
    TS_JPEG_BASELINE: "JPEG Baseline", TS_JPEG_EXTENDED: "JPEG Extended",
    TS_J2K_LOSSLESS: "JPEG 2000 Lossless", TS_J2K: "JPEG 2000"}
# those of them the port does not decode yet
_NOT_PORTED_TS = set(JPEG_FAMILY_TS) - _ENCAPSULATED_TS

# VRs with the 2-byte-VR + 2-reserved + 4-byte-length layout
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# Tags we materialise (group, element) → name
TAGS = {
    (0x0008, 0x0060): "Modality",
    (0x0008, 0x1030): "StudyDescription",
    (0x0018, 0x0015): "BodyPartExamined",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0006): "PlanarConfiguration",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0101): "BitsStored",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1050): "WindowCenter",
    (0x0028, 0x1051): "WindowWidth",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
}
_PIXEL_DATA = (0x7FE0, 0x0010)
_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)
_UNDEFINED = 0xFFFFFFFF


@dataclass
class DicomDataset:
    """Minimal decoded dataset: typed attributes + raw pixel bytes.

    For encapsulated (RLE) pixel data, ``fragments`` holds one compressed
    fragment per frame instead of ``pixel_bytes``.
    """
    attrs: Dict[str, object] = field(default_factory=dict)
    pixel_bytes: bytes = b""
    transfer_syntax: str = TS_EXPLICIT_LE
    fragments: Optional[list] = None

    def get(self, name, default=None):
        return self.attrs.get(name, default)


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise DicomError("Truncated DICOM stream.")
    return b


def _iter_elements(f: BinaryIO, explicit: bool, big_endian: bool,
                   end: Optional[int] = None) -> Iterator[Tuple[Tuple[int, int], bytes, int]]:
    """Yield ((group, elem), vr, length) with the file positioned at the value."""
    e = ">" if big_endian else "<"
    while True:
        if end is not None and f.tell() >= end:
            return
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        group, elem = struct.unpack(e + "HH", hdr[:4])
        tag = (group, elem)
        if tag in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
            (length,) = struct.unpack(e + "I", hdr[4:8])
            yield tag, b"  ", length
            continue
        if explicit:
            vr = hdr[4:6]
            if vr in _LONG_VRS:
                (length,) = struct.unpack(e + "I", _read_exact(f, 4))
            else:
                (length,) = struct.unpack(e + "H", hdr[6:8])
        else:
            vr = b"UN"
            (length,) = struct.unpack(e + "I", hdr[4:8])
        yield tag, vr, length


def _skip_sequence(f: BinaryIO, explicit: bool, big_endian: bool) -> None:
    """Skip an undefined-length sequence (nested items included)."""
    depth = 1
    for tag, vr, length in _iter_elements(f, explicit, big_endian):
        if tag == _SEQ_DELIM:
            depth -= 1
            if depth == 0:
                return
        elif tag == _ITEM:
            if length != _UNDEFINED:
                f.seek(length, os.SEEK_CUR)
        elif tag == _ITEM_DELIM:
            continue
        elif length == _UNDEFINED:
            depth += 1
        else:
            f.seek(length, os.SEEK_CUR)
    raise DicomError("Unterminated sequence.")


def _decode_value(name: str, vr: bytes, raw: bytes, big_endian: bool):
    e = ">" if big_endian else "<"
    if name in ("Rows", "Columns", "BitsAllocated", "BitsStored",
                "SamplesPerPixel", "PixelRepresentation",
                "PlanarConfiguration"):
        if len(raw) >= 2:
            return struct.unpack(e + "H", raw[:2])[0]
        return None
    text = raw.decode("latin-1", errors="replace").strip("\x00 ").strip()
    if name in ("RescaleSlope", "RescaleIntercept", "WindowCenter", "WindowWidth"):
        try:
            return float(text.split("\\")[0])
        except ValueError:
            return None
    if name == "NumberOfFrames":
        try:
            return int(text)
        except ValueError:
            return None
    return text


def read_dataset(path: str) -> DicomDataset:
    """Parse a DICOM file into a :class:`DicomDataset`."""
    try:
        f = open(path, "rb")
    except FileNotFoundError as exc:
        raise DicomError("Invalid or missing DICOM file.") from exc
    with f:
        preamble = f.read(132)
        ts = TS_EXPLICIT_LE
        if len(preamble) >= 132 and preamble[128:132] == b"DICM":
            ts = _read_file_meta(f)
        else:
            # No preamble: probe implicit-LE dataset (first tag group 0002/0008)
            f.seek(0)
            probe = f.read(4)
            f.seek(0)
            if len(probe) < 4:
                raise DicomError("Invalid or missing DICOM file.")
            group = struct.unpack("<H", probe[:2])[0]
            if group not in (0x0002, 0x0008, 0x0010, 0x0018, 0x0020, 0x0028):
                raise DicomError("Invalid or missing DICOM file.")
            ts = TS_IMPLICIT_LE
        if ts in _NOT_PORTED_TS:
            raise CodecNotPorted(
                f"transfer syntax {ts} ({JPEG_FAMILY_TS[ts]}) is not yet in "
                "mdx_torch (ROADMAP Queue 1: the codec slice)")
        if ts not in _SUPPORTED_TS:
            raise DicomError(f"Unsupported transfer syntax {ts!r}.")
        if ts == TS_DEFLATED_LE:
            # PS3.5 A.5: everything after the (uncompressed) file meta is
            # one raw-deflate stream of an Explicit VR LE dataset.
            import io
            import zlib

            try:
                inflated = zlib.decompressobj(-15).decompress(f.read())
            except zlib.error as exc:
                raise DicomError(
                    f"Corrupt deflated DICOM stream: {exc}") from exc
            body: BinaryIO = io.BytesIO(inflated)
        else:
            body = f

        explicit = ts != TS_IMPLICIT_LE
        big_endian = ts == TS_EXPLICIT_BE
        ds = DicomDataset(transfer_syntax=ts)
        _parse_body(body, ds, explicit, big_endian,
                    encapsulated=(ts in _ENCAPSULATED_TS))
        return ds


def _parse_body(f: BinaryIO, ds: DicomDataset, explicit: bool,
                big_endian: bool, encapsulated: bool) -> None:
    """Populate ``ds`` from the main dataset stream."""
    for tag, vr, length in _iter_elements(f, explicit, big_endian):
        if tag == _PIXEL_DATA:
            if length == _UNDEFINED:
                if not encapsulated:
                    raise DicomError(
                        "Encapsulated PixelData in a native transfer "
                        "syntax.")
                ds.fragments = _read_encapsulated(f)
                continue
            if encapsulated:
                raise DicomError(
                    "This transfer syntax requires encapsulated "
                    "(undefined-length) PixelData.")
            ds.pixel_bytes = _read_exact(f, length)
            continue
        if length == _UNDEFINED or vr == b"SQ":
            if length == _UNDEFINED:
                _skip_sequence(f, explicit, big_endian)
            else:
                f.seek(length, os.SEEK_CUR)
            continue
        name = TAGS.get(tag)
        if name is None:
            f.seek(length, os.SEEK_CUR)
            continue
        raw = _read_exact(f, length)
        val = _decode_value(name, vr, raw, big_endian)
        if val is not None:
            ds.attrs[name] = val


def _read_encapsulated(f: BinaryIO) -> list:
    """Read encapsulated PixelData items → per-frame fragment list.

    Layout (PS3.5 A.4): Basic Offset Table item first (possibly empty),
    then one item per fragment, terminated by a sequence delimiter.  For
    RLE every frame is exactly one fragment (PS3.5 G.3).
    """
    fragments = []
    while True:
        group, elem, length = struct.unpack("<HHI", _read_exact(f, 8))
        tag = (group, elem)
        if tag == _SEQ_DELIM:
            break
        if tag != _ITEM or length == _UNDEFINED:
            raise DicomError("Malformed encapsulated PixelData items.")
        fragments.append(_read_exact(f, length) if length else b"")
    if len(fragments) < 2:  # first item is the (possibly empty) offset table
        raise DicomError("Encapsulated PixelData has no frame fragments.")
    return fragments[1:]  # drop the Basic Offset Table


def _read_file_meta(f: BinaryIO) -> str:
    """Parse the group-0002 file meta (always explicit VR LE); return the
    transfer syntax UID and leave the stream at the start of the dataset."""
    ts = TS_EXPLICIT_LE
    meta_end = None
    for tag, vr, length in _iter_elements(f, explicit=True, big_endian=False):
        group, elem = tag
        if meta_end is None:
            if tag != (0x0002, 0x0000):
                raise DicomError("Missing FileMetaInformationGroupLength.")
            raw = _read_exact(f, length)
            (meta_len,) = struct.unpack("<I", raw[:4])
            meta_end = f.tell() + meta_len
            continue
        if f.tell() > meta_end:
            break
        raw = _read_exact(f, length)
        if tag == (0x0002, 0x0010):
            ts = raw.decode("ascii", errors="replace").strip("\x00 ").strip()
        if f.tell() >= meta_end:
            break
    return ts


def decode_pixels(ds: DicomDataset) -> np.ndarray:
    """Raw or encapsulated (RLE, JPEG Lossless, JPEG-LS) pixel bytes →
    numpy array in stored shape/dtype."""
    if not ds.pixel_bytes and ds.fragments is None:
        raise DicomError("DICOM file does not contain pixel data.")
    rows = ds.get("Rows")
    cols = ds.get("Columns")
    if not rows or not cols:
        raise DicomError("Unable to decode DICOM pixel data.")
    bits = ds.get("BitsAllocated", 16)
    signed = ds.get("PixelRepresentation", 0) == 1
    samples = ds.get("SamplesPerPixel", 1) or 1
    frames = ds.get("NumberOfFrames", 1) or 1

    if bits == 8:
        dtype = np.int8 if signed else np.uint8
    elif bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 32:
        dtype = np.int32 if signed else np.uint32
    else:
        raise DicomError(f"Unsupported BitsAllocated={bits}.")
    dtype = np.dtype(dtype)
    if ds.transfer_syntax == TS_EXPLICIT_BE:
        dtype = dtype.newbyteorder(">")

    expect = rows * cols * samples * frames
    if ds.fragments is not None:
        if ds.transfer_syntax in (TS_JPEG_LL, TS_JPEG_LL_SV1):
            arr = _decode_jpegll(ds.fragments, rows, cols, samples, frames,
                                 bits, signed)
        elif ds.transfer_syntax in (TS_JPEG_LS, TS_JPEG_LS_NEAR):
            arr = _decode_jpegls(ds.fragments, rows, cols, samples, frames,
                                 bits, signed)
        else:
            from mdx_torch.io import rle

            if len(ds.fragments) != frames:
                raise DicomError(
                    f"RLE PixelData has {len(ds.fragments)} frame "
                    f"fragments, NumberOfFrames says {frames}.")
            try:
                decoded = _map_frames(
                    lambda frag: rle.decode_frame(frag, rows, cols,
                                                  samples, bits // 8),
                    list(ds.fragments))
            except rle.RleError as exc:
                raise DicomError(f"Corrupt RLE pixel data: {exc}") from exc
            arr = np.concatenate(decoded).view(dtype)
    else:
        arr = np.frombuffer(ds.pixel_bytes, dtype=dtype, count=-1)
    if arr.size < expect:
        raise DicomError("Unable to decode DICOM pixel data (short buffer).")
    arr = arr[:expect]
    # PlanarConfiguration=1 (uncompressed only: encapsulated codecs
    # define their own layout and require the attribute be 0) stores
    # per-frame color planes RR..GG..BB, not interleaved samples
    planar = (ds.get("PlanarConfiguration", 0) or 0) == 1 \
        and ds.fragments is None
    if frames > 1 and samples > 1:
        if planar:
            arr = arr.reshape(frames, samples, rows, cols
                              ).transpose(0, 2, 3, 1)
        else:
            arr = arr.reshape(frames, rows, cols, samples)
    elif frames > 1:
        arr = arr.reshape(frames, rows, cols)
    elif samples > 1:
        if planar:
            arr = arr.reshape(samples, rows, cols).transpose(1, 2, 0)
        else:
            arr = arr.reshape(rows, cols, samples)
    else:
        arr = arr.reshape(rows, cols)
    return arr

def _decode_jpegll(fragments: list, rows: int, cols: int, samples: int,
                   frames: int, bits: int, signed: bool) -> np.ndarray:
    """JPEG Lossless fragments → flat pixel array in the stored dtype.

    Fragment → frame grouping (PS3.5 A.4 allows a frame to span
    fragments): one-fragment-per-frame when the counts match, otherwise
    a single frame owns every fragment, otherwise fragments are grouped
    on their SOI prefix (each codestream starts FF D8).  Signed data is
    sign-extended from the codestream's own precision P — the encoder
    codes the unsigned two's-complement representation and the mod-2^16
    arithmetic makes the round trip exact.
    """
    from mdx_torch.io import jpegll

    if bits not in (8, 16):
        raise DicomError(
            f"JPEG Lossless carries at most 16 bits (BitsAllocated={bits}).")
    streams = _group_frame_streams(fragments, frames, "JPEG Lossless")

    def _one(stream: bytes) -> np.ndarray:
        try:
            img, p = jpegll.decode(stream)
        except jpegll.JpegLLError as exc:
            raise DicomError(
                f"Corrupt JPEG Lossless pixel data: {exc}") from exc
        shape = img.shape if img.ndim == 3 else img.shape + (1,)
        if shape != (rows, cols, samples):
            raise DicomError(
                f"JPEG Lossless frame is {shape}, dataset says "
                f"({rows}, {cols}, {samples}).")
        a = img.reshape(-1).astype(np.int64)   # composite (interleaved) order
        if signed:
            a = np.where(a >= (1 << (p - 1)), a - (1 << p), a)
        return a

    flat = np.concatenate(_map_frames(_one, streams))
    base = {8: np.int8 if signed else np.uint8,
            16: np.int16 if signed else np.uint16}[bits]
    lo, hi = np.iinfo(base).min, np.iinfo(base).max
    if flat.size and (int(flat.min()) < lo or int(flat.max()) > hi):
        raise DicomError(
            f"JPEG Lossless sample out of range for BitsAllocated={bits}.")
    return flat.astype(base)


def _map_frames(fn, items: list) -> list:
    """Order-preserving map over per-frame decode work, fanned out over a
    thread pool when there are multiple frames and cores.

    The compressed codecs' hot loops (``mdx_torch.io.native``) run in C++
    with the GIL released for the duration of the ctypes call, so
    frame-level threads scale on multi-core hosts; the Python loops
    (``MDX_NO_NATIVE=1``) still overlap their NumPy portions.  Serial
    path (no pool, identical exception propagation) for single-frame
    input, single-core hosts, or ``MDX_IO_THREADS=1``/``0``.
    ``MDX_IO_THREADS=N`` caps the pool.
    """
    env = os.environ.get("MDX_IO_THREADS")
    limit = int(env) if env else (os.cpu_count() or 1)
    workers = min(len(items), limit, 16)
    if workers <= 1:
        return [fn(it) for it in items]
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


# per-codec frame-start prefixes for fragment grouping.  They must be
# codec-specific: FF 4F can legally appear inside JPEG-LS bit-stuffed
# entropy data (any byte with MSB 0 may follow FF), so splitting JLS
# fragments on the J2K SOC would false-split spanning frames; FF D8
# can never follow FF inside JPEG-family entropy data, making it safe
# for those codecs.
_FRAME_PREFIXES = {
    "jpeg": (b"\xff\xd8",),
    "jpeg2k": (b"\xff\x4f", b"\x00\x00\x00\x0cjP\x20\x20"),
}


def _group_frame_streams(fragments: list, frames: int,
                         codec: str, kind: str = "jpeg") -> list:
    """Fragment → frame grouping (PS3.5 A.4: a frame may span fragments):
    one-fragment-per-frame when the counts match, otherwise a single
    frame owns every fragment, otherwise fragments are grouped on their
    codec-specific start prefix (``kind``: JPEG-family FF D8; JPEG 2000
    SOC FF 4F or the JP2 signature box)."""
    if len(fragments) == frames:
        return [bytes(f) for f in fragments]
    if frames == 1:
        return [b"".join(fragments)]
    prefixes = _FRAME_PREFIXES[kind]

    def _starts(frag: bytes) -> bool:
        return any(frag[:len(p)] == p for p in prefixes)

    streams, cur = [], []
    for frag in fragments:
        if _starts(frag) and cur:
            streams.append(b"".join(cur))
            cur = []
        cur.append(frag)
    if cur:
        streams.append(b"".join(cur))
    if len(streams) != frames:
        raise DicomError(
            f"{codec} PixelData groups into {len(streams)} "
            f"codestreams, NumberOfFrames says {frames}.")
    return streams


def _decode_jpegls(fragments: list, rows: int, cols: int, samples: int,
                   frames: int, bits: int, signed: bool) -> np.ndarray:
    """JPEG-LS fragments → flat pixel array in the stored dtype.

    Same frame grouping and signed-container handling as
    :func:`_decode_jpegll`: signed data is sign-extended from the
    codestream's own precision P (the encoder codes the unsigned
    two's-complement representation).  For the near-lossless syntax the
    codec's NEAR parameter comes from the codestream itself; values are
    reconstructed within ±NEAR per T.87.
    """
    from mdx_torch.io import jpegls

    if bits not in (8, 16):
        raise DicomError(
            f"JPEG-LS carries at most 16 bits (BitsAllocated={bits}).")
    streams = _group_frame_streams(fragments, frames, "JPEG-LS")

    def _one(stream: bytes) -> np.ndarray:
        try:
            img, p, _near = jpegls.decode(stream)
        except jpegls.JpegLSError as exc:
            raise DicomError(
                f"Corrupt JPEG-LS pixel data: {exc}") from exc
        shape = img.shape if img.ndim == 3 else img.shape + (1,)
        if shape != (rows, cols, samples):
            raise DicomError(
                f"JPEG-LS frame is {shape}, dataset says "
                f"({rows}, {cols}, {samples}).")
        a = img.reshape(-1).astype(np.int64)   # composite order
        if signed:
            a = np.where(a >= (1 << (p - 1)), a - (1 << p), a)
        return a

    flat = np.concatenate(_map_frames(_one, streams))
    base = {8: np.int8 if signed else np.uint8,
            16: np.int16 if signed else np.uint16}[bits]
    lo, hi = np.iinfo(base).min, np.iinfo(base).max
    if flat.size and (int(flat.min()) < lo or int(flat.max()) > hi):
        raise DicomError(
            f"JPEG-LS sample out of range for BitsAllocated={bits}.")
    return flat.astype(base)


def _rescale(image: np.ndarray, ds: DicomDataset) -> np.ndarray:
    """Modality rescale (slope/intercept), float32."""
    slope = ds.get("RescaleSlope", 1.0) or 1.0
    intercept = ds.get("RescaleIntercept", 0.0) or 0.0
    return (image.astype(np.float32) * np.float32(slope)
            + np.float32(intercept))


def _is_mono1(ds: DicomDataset) -> bool:
    return str(ds.get("PhotometricInterpretation", "")
               ).upper() == "MONOCHROME1"


def apply_window(image: np.ndarray, ds: "DicomDataset"
                 ) -> Tuple[np.ndarray, bool]:
    """Apply the dataset's VOI window when present → (image, applied).

    Callers need ``applied`` to decide whether min-max normalisation is
    still required (frames without stored windows would otherwise reach QA
    with raw modality-scale intensities)."""
    center = ds.get("WindowCenter")
    width = ds.get("WindowWidth")
    if center is None or width is None:
        return image, False
    return window_level(image, float(center), float(width)), True


def _pixels(ds: DicomDataset, window: bool) -> np.ndarray:
    """Decode → modality rescale → optional VOI window → presentation
    inversion, in the DICOM pipeline order (PS3.14: the VOI LUT is defined
    on modality-rescale values, BEFORE any MONOCHROME1 inversion).

    With ``window=True`` the output is always in [0, 1]: files without a
    stored window fall back to min-max normalisation, so windowed batch
    paths never feed raw modality-scale intensities to QA."""
    raw = decode_pixels(ds)
    photometric = str(ds.get("PhotometricInterpretation", "")
                      or "").strip().upper()
    if photometric.startswith("YBR") and \
            photometric not in ("YBR_RCT", "YBR_ICT") and \
            raw.ndim >= 3 and raw.shape[-1] == 3:
        # YCbCr: Y is BT.601 luma, the reduction to_grayscale's RGB
        # weights approximate (weighting YCbCr channels as RGB would be
        # wrong); YBR_RCT/YBR_ICT samples arrive as RGB
        raw = raw[..., 0]
    image = _rescale(raw, ds)
    windowed = False
    if window:
        image, windowed = apply_window(image, ds)
    if _is_mono1(ds):
        # windowed output lives in [0,1]; raw values invert about their max
        image = (1.0 - image) if windowed else (image.max() - image)
    if window and not windowed:
        image = normalize_image(image)
    return image


def _metadata(ds: DicomDataset) -> Dict[str, str]:
    """The non-PHI metadata whitelist (ref pipeline/dicom_io.py:47-57)."""
    return {k: str(ds.get(k, "Unknown") or "Unknown")
            for k in ("Modality", "BodyPartExamined", "StudyDescription")}


def load_dicom(path: str, window: bool = False
               ) -> Tuple[np.ndarray, Dict[str, str]]:
    """Load a DICOM file → (2-D float32 image, non-PHI metadata).

    Reference-compatible behaviour (pipeline/dicom_io.py:29-81): modality
    rescale, MONOCHROME1 inversion, RGB→luma / middle-frame reduction, and
    the three-key metadata whitelist.
    """
    ds = read_dataset(path)
    image = _pixels(ds, window)
    image = to_grayscale(image)
    metadata = _metadata(ds)
    return image, metadata


def raw_ingest_descriptor(ds: DicomDataset, raw: np.ndarray
                          ) -> Dict[str, object]:
    """Per-file scalars for device-side normalisation of raw pixels
    (``mdx_torch.ops.ingest``).

    The rescaled stack bounds come from the raw integer min/max pushed
    through the same f32 mul-then-add the host rescale applies: the map is
    monotone and f32 ops are exactly rounded, so ``min(f(raw)) ==
    f(min(raw))`` — identical to reducing the rescaled array, without
    materialising it."""
    slope = float(ds.get("RescaleSlope", 1.0) or 1.0)
    intercept = float(ds.get("RescaleIntercept", 0.0) or 0.0)
    f = np.float32
    rmin, rmax = int(raw.min()), int(raw.max())
    v0 = float(f(f(rmin) * f(slope)) + f(intercept))
    v1 = float(f(f(rmax) * f(slope)) + f(intercept))
    gmin, gmax = (v0, v1) if slope >= 0 else (v1, v0)
    wc, ww = ds.get("WindowCenter"), ds.get("WindowWidth")
    return {
        "slope": slope, "intercept": intercept,
        "mono1": _is_mono1(ds), "gmin": gmin, "gmax": gmax,
        "window": (float(wc), float(ww))
                  if wc is not None and ww is not None else None,
    }


def load_frames_raw(path: str, window: bool = False
                    ) -> Tuple[np.ndarray, Dict[str, object] | None,
                               Dict[str, str]]:
    """Load for device-side normalisation: → (frames, descriptor, meta).

    When the pixels are plain grayscale integers, ``frames`` is the RAW
    stored [F, H, W] stack (native byte order) and ``descriptor`` the
    :func:`raw_ingest_descriptor` scalars — 2× (uint16) to 4× (uint8)
    fewer host→device bytes than decoded float32 on the upload-bound
    batch paths.  Anything else (RGB, float pixel data) falls back to the
    host pipeline: ``descriptor`` is None and ``frames`` is the
    :func:`load_series` float32 stack (windowed per ``window``)."""
    ds = read_dataset(path)
    raw = decode_pixels(ds)
    if (raw.dtype.kind not in "iu" or raw.ndim not in (2, 3)
            or (raw.ndim == 3 and raw.shape[-1] in (3, 4))):
        image = _pixels(ds, window)
        if image.ndim == 2:
            image = image[None]
        return np.asarray(image, np.float32), None, _metadata(ds)
    if raw.ndim == 2:
        raw = raw[None]
    if raw.dtype.byteorder == ">":
        raw = raw.astype(raw.dtype.newbyteorder("="))
    raw = np.ascontiguousarray(raw)
    return raw, raw_ingest_descriptor(ds, raw), _metadata(ds)


def load_series(path: str, window: bool = False
                ) -> Tuple[np.ndarray, Dict[str, str]]:
    """Load a DICOM file keeping *all* frames: → ([F, H, W] float32, metadata).

    Extension over the reference (which reduces to the middle slice,
    pipeline/dicom_io.py:60-81): the full frame stack is returned so a
    multi-frame series can be sharded across a device mesh.
    """
    ds = read_dataset(path)
    image = _pixels(ds, window)
    if image.ndim == 2:
        image = image[None]
    elif image.ndim == 3 and image.shape[-1] in (3, 4):
        rgb = image[..., :3]
        image = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                 + 0.114 * rgb[..., 2]).astype(np.float32)[None]
    elif image.ndim == 4:  # frames × H × W × samples
        rgb = image[..., :3]
        image = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                 + 0.114 * rgb[..., 2]).astype(np.float32)
    metadata = _metadata(ds)
    return image.astype(np.float32), metadata
