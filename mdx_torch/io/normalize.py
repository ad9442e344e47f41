"""Image normalisation and channel/frame reduction (host, numpy).

The port's copy of ``mdx/io/normalize.py`` (ref pipeline/dicom_io.py:60-91);
a CPU test holds it equal to the original.  ``normalize_image`` is the
original's numpy body: the JAX package sends images of 2^20 pixels or more
to its C++ ``normalize01``, which multiplies by the inverse of the range
instead of dividing by it and so lands one float32 ulp away on about half
the pixels (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np


def to_grayscale(image: np.ndarray) -> np.ndarray:
    """Reduce a multi-channel / multi-frame array to 2-D grayscale.

    RGB(A) → luma (BT.601 weights); volumes → the middle slice; higher-rank
    arrays reduce recursively.  (ref pipeline/dicom_io.py:60-81)
    """
    if image.ndim == 2:
        return image
    if image.ndim == 3:
        if image.shape[-1] in (3, 4):
            rgb = image[..., :3]
            return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        # a [3,H,W] array is a 3-frame volume → middle slice
        return image[image.shape[0] // 2]
    while image.ndim > 2:
        image = image[image.shape[0] // 2]
    return image


def normalize_image(image: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1] float32; constant images → zeros
    (ref pipeline/dicom_io.py:84-91)."""
    image = np.asarray(image, np.float32)
    lo = float(image.min())
    hi = float(image.max())
    if hi - lo < 1e-8:
        return np.zeros_like(image, dtype=np.float32)
    return ((image - lo) / (hi - lo)).astype(np.float32)


def normalize_batch(images: np.ndarray) -> np.ndarray:
    """Per-image min-max normalisation of [N, H, W] (batched extension)."""
    images = np.asarray(images, np.float32)
    lo = images.min(axis=(1, 2), keepdims=True)
    hi = images.max(axis=(1, 2), keepdims=True)
    rng = hi - lo
    safe = np.where(rng < 1e-8, 1.0, rng)
    out = (images - lo) / safe
    return np.where(rng < 1e-8, 0.0, out).astype(np.float32)


def window_level(image: np.ndarray, center: float, width: float) -> np.ndarray:
    """DICOM linear VOI windowing (PS3.3 C.11.2.1.2) → [0, 1] float32: a
    stored or supplied window-center/width maps the diagnostic range to
    [0, 1] before QA (mixed-modality streams, BASELINE config 5)."""
    image = np.asarray(image, np.float32)
    width = max(float(width), 1.0 + 1e-6)
    lo = float(center) - 0.5 - (width - 1.0) / 2.0
    out = (image - lo) / (width - 1.0)
    return np.clip(out, 0.0, 1.0).astype(np.float32)
