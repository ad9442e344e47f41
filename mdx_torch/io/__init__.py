"""Host-side I/O of the port: DICOM read and write, normalisation, the
markdown report and the before/after PNG.

Counterpart of ``mdx.io``, in numpy, ``zlib`` and ``struct`` (no JAX, no
pydantic, no matplotlib).  The reader covers the uncompressed syntaxes,
deflate, RLE (``mdx_torch.io.rle``), JPEG Lossless (``mdx_torch.io.jpegll``),
JPEG-LS (``mdx_torch.io.jpegls``), DCT JPEG (``mdx_torch.io.jpegdct``,
decode-only) and JPEG 2000 (``mdx_torch.io.jpeg2k``), whose entropy loops
run in the port's host C++ library (``mdx_torch.io.native``, built at first
use); :func:`transcode` (``mdx_torch.io.transcode``) rewrites a file in
another transfer syntax.
"""

from mdx_torch.io.dicom import DicomError, load_dicom, load_series
from mdx_torch.io.dicom_write import write_dicom, write_synthetic_dicom
from mdx_torch.io.normalize import normalize_image, to_grayscale
from mdx_torch.io.report import build_markdown_report
from mdx_torch.io.transcode import transcode
from mdx_torch.io.visuals import save_single_image, save_visuals

__all__ = [
    "load_dicom", "load_series", "DicomError", "write_dicom",
    "write_synthetic_dicom", "normalize_image", "to_grayscale",
    "build_markdown_report", "save_visuals", "save_single_image",
    "transcode",
]
