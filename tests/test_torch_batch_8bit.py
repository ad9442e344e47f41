"""The port's batch runner on 8-bit and 32-bit frames against the JAX
package's, on the CPU.

On 8-bit frames the JAX package's jitted program differs from its own
op-by-op form: XLA's fused CLAHE moves quantised values across histogram
bins (1.24e-2 on 15 % of the pixels of a 48 x 80 frame, ROADMAP Queue 3),
and the port equals the op-by-op form.  So these frames are held to the
JAX batch runner run under ``jax.disable_jit()`` (most of this file's
time is JAX's op-by-op compiles): ultrasound uint8 frames (one
MONOCHROME1), a signed 8-bit frame (which the port widens to int16) and a
32-bit frame (which the port normalises on the host), raw and
``--window``, within ``mdx_torch.parity``.
"""

import struct

import jax
import numpy as np
import pytest

from mdx.pipeline import batch_runner as JB
from mdx_torch import parity
from mdx_torch.io import write_dicom
from mdx_torch.pipeline import batch_runner as PB


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))


def _write_u32(path: str, pix: np.ndarray) -> None:
    """A 32-bit explicit-LE file (the writers take 8 and 16 bits only)."""
    def el(group, elem, vr, value: bytes) -> bytes:
        value += b"\x00" * (len(value) % 2)
        if vr == b"OW":
            return struct.pack("<HH2sHI", group, elem, vr, 0,
                               len(value)) + value
        return struct.pack("<HH2sH", group, elem, vr, len(value)) + value

    us = lambda v: struct.pack("<H", v)  # noqa: E731
    body = b"".join([
        el(0x0028, 0x0002, b"US", us(1)),
        el(0x0028, 0x0004, b"CS", b"MONOCHROME2 "),
        el(0x0028, 0x0010, b"US", us(pix.shape[0])),
        el(0x0028, 0x0011, b"US", us(pix.shape[1])),
        el(0x0028, 0x0100, b"US", us(32)), el(0x0028, 0x0101, b"US", us(32)),
        el(0x0028, 0x0103, b"US", us(0)),
        el(0x7FE0, 0x0010, b"OW", pix.astype("<u4").tobytes())])
    ts = el(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + el(0x0002, 0x0000, b"UL",
                struct.pack("<I", len(ts))) + ts + body)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eight")
    rng = np.random.default_rng(5)
    for i in range(2):
        write_dicom(str(root / f"us{i}.dcm"),
                    rng.integers(0, 256, (48, 80)).astype(np.uint8),
                    modality="US",
                    photometric="MONOCHROME1" if i else "MONOCHROME2")
    write_dicom(str(root / "s8.dcm"),
                rng.integers(-128, 128, (48, 80)).astype(np.int8),
                modality="US")
    _write_u32(str(root / "u32.dcm"),
               rng.integers(0, 1 << 20, (48, 80)).astype(np.uint32))
    return str(root)


@pytest.mark.parametrize("window", [False, True])
def test_8bit_and_32bit_frames_match_jax_op_by_op(tmp_path, db, frames_dir,
                                                  window):
    got = PB.run_pipeline_batch(frames_dir, str(tmp_path / "p"),
                                window=window, device="cpu")
    with jax.disable_jit():
        want = JB.run_pipeline_batch(frames_dir, str(tmp_path / "e"),
                                     window=window, save_artifacts=False)
    by = lambda ctx: sorted(ctx["frames"], key=lambda f: f["source"])  # noqa: E731
    assert [f["source"] for f in by(got)] == [
        "s8.dcm", "u32.dcm", "us0.dcm", "us1.dcm"]
    assert [f["source"] for f in by(got)] == [f["source"] for f in by(want)]
    for g, w in zip(by(got), by(want)):
        assert g["shape"] == w["shape"] == [48, 80]
        bad = parity.breaches(parity.flatten_batch([g]),
                              parity.flatten_batch([w]), hw=48 * 80)
        assert not bad, (g["source"], bad)
