"""Raw-integer ingest of mdx_torch (``mdx_torch.ops.ingest``) against the
JAX package's ``mdx.ops.ingest.normalize_ingest`` on the CPU.

The same raw integer stacks (uint8, int16, uint16) and the same per-frame
float32 scalars, built by the JAX package's batch runner
(``_ingest_params``) from hand-made descriptors, go through both.
Tolerance: 2e-6, tests/test_ingest.py's bar (the JAX package's XLA may
fuse the rescale into one FMA, the port rounds the product and the sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mdx.ops.ingest import normalize_ingest as j_normalize
from mdx.pipeline.batch_runner import _ingest_params

from mdx_torch.ops.ingest import normalize_ingest

ATOL = 2e-6

# (dtype, value range, slope, intercept, mono1, stored window or None)
CASES = {
    "u8_plain": (np.uint8, (0, 256), 1.0, 0.0, False, None),
    "ct_int16_window": (np.int16, (0, 4096), 1.0, -1024.0, False,
                        (40.0, 400.0)),
    "u16_mono1_window": (np.uint16, (0, 65536), 1.0, 0.0, True,
                         (30000.0, 50000.0)),
    "u16_mono1_nowindow": (np.uint16, (100, 4000), 1.0, 0.0, True, None),
    "u16_fractional_slope": (np.uint16, (0, 1000), 0.75, 12.5, False,
                             (300.0, 500.0)),
    "int16_negative": (np.int16, (-2000, 3000), 1.0, 0.0, False, None),
}


def _stack(case: str, seed: int = 0):
    """(raw [3,40,48] of the case's dtype, its descriptor)."""
    dtype, (lo, hi), slope, intercept, mono1, window = CASES[case]
    rng = np.random.default_rng(seed)
    raw = rng.integers(lo, hi, (3, 40, 48)).astype(dtype)
    v = raw.astype(np.float32) * np.float32(slope) + np.float32(intercept)
    desc = {"slope": slope, "intercept": intercept, "mono1": mono1,
            "gmin": float(v.min()), "gmax": float(v.max()), "window": window}
    return raw, desc


@pytest.mark.parametrize("per_frame_minmax", [True, False])
@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_normalize_ingest_vs_jax(case, window, per_frame_minmax):
    raw, desc = _stack(case)
    params = _ingest_params([desc] * raw.shape[0], window, raw.shape[0])
    want = np.asarray(j_normalize(jnp.asarray(raw), *map(jnp.asarray, params),
                                  per_frame_minmax=per_frame_minmax))
    got = normalize_ingest(torch.from_numpy(raw),
                           *map(torch.from_numpy, params),
                           per_frame_minmax=per_frame_minmax)
    assert got.dtype == torch.float32 and got.shape == raw.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_per_frame_scalars_differ_per_frame():
    # frames of one stack with their own slope, window and MONO1 flag
    raw, _ = _stack("u16_fractional_slope", seed=1)
    descs = [_stack(c, seed=1)[1] for c in ("u16_fractional_slope",
                                             "u16_mono1_window",
                                             "u16_mono1_nowindow")]
    params = _ingest_params(descs, True, 4)          # padded to 4 frames
    raw = np.concatenate([raw, raw[-1:]])
    for pfm in (True, False):
        want = np.asarray(j_normalize(jnp.asarray(raw),
                                      *map(jnp.asarray, params),
                                      per_frame_minmax=pfm))
        got = normalize_ingest(torch.from_numpy(raw),
                               *map(torch.from_numpy, params),
                               per_frame_minmax=pfm)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_flat_frame_normalises_to_zero():
    raw = np.full((2, 8, 8), 700, np.uint16)
    raw[1, 0, 0] = 701
    params = [np.zeros(2, np.float32) for _ in range(9)]
    params[0][:] = 1.0                                  # slope
    got = normalize_ingest(torch.from_numpy(raw),
                           *map(torch.from_numpy, params),
                           per_frame_minmax=True)
    assert float(got[0].abs().max()) == 0.0
    assert float(got[1, 0, 0]) == 1.0 and float(got[1, 0, 1]) == 0.0


def test_refuses_float_frames():
    with pytest.raises(ValueError, match="uint8, int16 or uint16"):
        normalize_ingest(torch.zeros(1, 4, 4), *[torch.zeros(1)] * 9,
                         per_frame_minmax=True)
