"""The port's deploy-time primer (``mdx_torch/pipeline/prime.py``) against
the JAX package's (``mdx/pipeline/prime.py``), on the CPU.

The copied helpers equal JAX's bit for bit; ``prime``, ``prime_tuning``
and ``prime_spatial`` return JAX's count and log JAX's step lines (numbers
masked, the port's seconds taken off; the port's two library lines stand
where JAX logs its compile cache).  Spies show that the product's own
functions ran (``qa_deterministic``, the batch runner's ``_device_qa``,
``autotune``, the spatial rank body in one launch), and one primed chunk's
packed results are held to JAX's raw-ingest program on the same frames
within ``mdx_torch.parity``.  JAX's primer runs once per argument set (a
module fixture each) and the file makes one launch of ranks.
"""

import re

import numpy as np
import pytest
import torch

from mdx.pipeline import prime as JP
from mdx_torch import parity
from mdx_torch.core import qa as PQA
from mdx_torch.core import tuning as PT
from mdx_torch.parallel import launch
from mdx_torch.pipeline import batch_runner as PB
from mdx_torch.pipeline import prime as PP

TUNING_SETS = (("noise", "low_contrast"), ("low_contrast",), ("blur",))
# the same gates as low_contrast alone: deduplicated
SPATIAL_SETS = (("noise",), ("low_contrast",),
                ("clipping_low", "clipping_high"))
MINIMAL = dict(chunk=2, dtypes=("uint16",), window_modes=(False,))
_PORT_ONLY = ("kernel library:", "host codec library:")
# the batch runner's packed rows: the metrics, 5 issue masks, SSIM, PSNR,
# quality improvement, pass, score
PACKED_ROWS = len(PB.METRIC_KEYS) + 10


def _masked(lines, drop=()) -> list[str]:
    """Log lines without ``drop``-prefixed ones, the port's trailing
    seconds taken off and every number masked."""
    out = []
    for line in lines:
        if line.startswith(drop):
            continue
        line = re.sub(r" in [\d.]+ s$", "", line)
        out.append(re.sub(r"\d+(?:\.\d+)?", "#", line))
    return out


def _spy(mp, module, name, calls: list):
    """Replace ``module.name`` by a wrapper that records (args, kwargs,
    result) and calls the original."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    mp.setattr(module, name, spy)


@pytest.fixture(scope="module")
def jax_tuning():
    msgs = []
    return JP.prime_tuning([(64, 64)], issue_sets=TUNING_SETS,
                           log=msgs.append), msgs


@pytest.fixture(scope="module")
def jax_prime():
    from mdx.parallel import make_mesh

    msgs = []
    return JP.prime([(64, 64)], mesh=make_mesh(n_data=1), log=msgs.append,
                    **MINIMAL), msgs


@pytest.fixture(scope="module")
def jax_spatial():
    from mdx.parallel import make_mesh2d

    msgs = []
    return JP.prime_spatial([(64, 64)],
                            mesh=make_mesh2d(n_data=1, n_sy=2, n_sx=2),
                            issue_sets=SPATIAL_SETS, log=msgs.append), msgs


@pytest.fixture(scope="module")
def port_prime():
    msgs, qa_calls, dev_calls = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, PQA, "qa_deterministic", qa_calls)
        _spy(mp, PB, "_device_qa", dev_calls)
        n = PP.prime([(64, 64)], device="cpu", log=msgs.append, **MINIMAL)
    return n, msgs, qa_calls, dev_calls


@pytest.fixture(scope="module")
def port_tuning():
    msgs, calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, PT, "autotune", calls)
        n = PP.prime_tuning([(64, 64)], issue_sets=TUNING_SETS,
                            device="cpu", log=msgs.append)
    return n, msgs, calls


@pytest.fixture(scope="module")
def port_spatial():
    msgs, calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, launch, "run", calls)
        n = PP.prime_spatial([(64, 64)], n_space=(2, 2),
                             issue_sets=SPATIAL_SETS, device="cpu",
                             log=msgs.append)
    return n, msgs, calls


# ---------------------------------------------------------------------------
# the copies


@pytest.mark.parametrize("text", ["512x512,1024x768", "256", "64X32",
                                  "512x512"])
def test_parse_shapes_equals_jax(text):
    assert PP._parse_shapes(text) == JP._parse_shapes(text)


@pytest.mark.parametrize("shape", [(5, 7), (16, 12)])
@pytest.mark.parametrize("dtype", ["uint16", "int16", "uint8", "float32"])
def test_synthetic_frames_equal_jax(dtype, shape):
    got = PP._synthetic_frames(*shape, 3, dtype)
    want = JP._synthetic_frames(*shape, 3, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["uint16", "int16", "uint8"])
def test_synthetic_descs_equal_jax(dtype):
    assert PP._synthetic_descs(dtype, 5) == JP._synthetic_descs(dtype, 5)


def test_constants_equal_jax():
    assert PP.RAW_DTYPES == JP.RAW_DTYPES
    assert PP.SPATIAL_ISSUE_SETS == JP.SPATIAL_ISSUE_SETS


# ---------------------------------------------------------------------------
# prime


def test_prime_count_and_lines_match_jax(port_prime, jax_prime):
    n, msgs, _, _ = port_prime
    want_n, want_msgs = jax_prime
    assert n == want_n == 2
    assert _masked(msgs, _PORT_ONLY) == _masked(want_msgs,
                                                ("compile cache:",))
    assert msgs[0] == ("kernel library: not built (device cpu: the plain "
                       "versions run)")
    assert msgs[1].startswith("host codec library: ")
    assert all(re.search(r" in [\d.]+ s$", m) for m in msgs[2:])


def test_prime_runs_the_product_functions(port_prime):
    _, _, qa_calls, dev_calls = port_prime
    # the single-image pass, then the chunk's pass inside _device_qa
    assert [tuple(a[0].shape) for a, _, _ in qa_calls] == [(1, 64, 64),
                                                          (2, 64, 64)]
    assert qa_calls[0][0][0].dtype == torch.float32
    (args, _, packed), = dev_calls
    x, params, dev, window = args
    assert x.dtype == np.uint16 and x.shape == (2, 64, 64)
    assert params.shape == (9, 2) and dev.type == "cpu" and window is False
    np.testing.assert_array_equal(
        x, PP._synthetic_frames(64, 64, 2, "uint16"))
    np.testing.assert_array_equal(
        params, PB._ingest_params(PP._synthetic_descs("uint16", 2), False))
    assert tuple(packed.shape) == (PACKED_ROWS, 2)


def _records(packed: np.ndarray) -> list[dict]:
    frames = [("prime", i, None, {}, None) for i in range(packed.shape[1])]
    out: list = []
    PB._collect(frames, packed, 64, 64, out, False)
    return out


def test_primed_chunk_matches_jax_raw_program(port_prime):
    import jax.numpy as jnp

    from mdx.pipeline import batch_runner as JB

    packed = port_prime[3][0][2].numpy()
    frames = PP._synthetic_frames(64, 64, 2, "uint16")
    params = JB._ingest_params(PP._synthetic_descs("uint16", 2), False, 2)
    want = np.asarray(JB._pack_outputs(
        JB._raw_qa_program(False)(jnp.asarray(frames), *params)))
    assert want.shape == packed.shape
    bad = parity.breaches(parity.flatten_batch(_records(packed)),
                          parity.flatten_batch(_records(want)), hw=64 * 64)
    assert not bad, bad


def test_prime_full_matrix_counts_eight():
    msgs = []
    n = PP.prime([(32, 32)], device="cpu", log=msgs.append)
    # the single pass + 3 integer dtypes × 2 window modes + float32 unwindowed
    assert n == 8
    chunks = [m for m in msgs if "chunk=" in m]
    assert [re.search(r"dtype=(\w+) window=(\w+)", m).groups()
            for m in chunks] == [
        (t, w) for t in PP.RAW_DTYPES for w in ("False", "True")
    ] + [("float32", "False")]
    assert all("chunk=64 " in m for m in chunks)


# ---------------------------------------------------------------------------
# prime_tuning


def test_prime_tuning_count_and_lines_match_jax(port_tuning, jax_tuning):
    n, msgs, _ = port_tuning
    want_n, want_msgs = jax_tuning
    assert n == want_n == 5
    assert _masked(msgs) == _masked(want_msgs)
    assert any("K=9" in m for m in msgs) and any("K=27" in m for m in msgs)


def test_prime_tuning_runs_autotune_once_per_k(port_tuning):
    _, _, calls = port_tuning
    assert [(a[0].shape, a[1], kw["device"].type) for a, kw, _ in calls] == [
        ((64, 64), ["noise", "low_contrast"], "cpu"),
        ((64, 64), ["blur"], "cpu")]
    np.testing.assert_array_equal(
        calls[0][0][0], PP._synthetic_frames(64, 64, 1, "float32")[0])


# ---------------------------------------------------------------------------
# prime_spatial


def test_prime_spatial_count_and_lines_match_jax(port_spatial, jax_spatial):
    n, msgs, _ = port_spatial
    want_n, want_msgs = jax_spatial
    assert n == want_n == 4
    assert _masked(msgs) == _masked(want_msgs)
    assert any("2 gate combos" in m and "sy=2 sx=2" in m for m in msgs)


def test_prime_spatial_is_one_launch_of_its_rank_body(port_spatial):
    _, _, calls = port_spatial
    (args, kwargs, res), = calls
    assert args[0] is PP.prime_spatial_block
    assert kwargs["n_space"] == (2, 2) and kwargs["device"] == "cpu"
    assert res.backend == "gloo" and len(res.results) == 4
    assert len(kwargs["gates"]) == 2
    assert kwargs["gates"][0]["denoise"] is True
    assert "clahe_clip_limit" in kwargs["gates"][1]
    assert "clahe" in kwargs["ops"] and kwargs["tile_size"] == 16
    # stats, two gate combinations, the sweep: each timed on every rank
    assert all(r["seconds"].shape == (4,) for r in res.results)


# ---------------------------------------------------------------------------
# the card by default, the CLI


@pytest.mark.parametrize("fn", [PP.prime, PP.prime_tuning, PP.prime_spatial])
def test_default_device_raises_without_a_card(fn):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device 'cuda'.*"
                                           "torch.cuda.is_available"):
        fn([(32, 32)])


def test_main_on_the_cpu_and_without_a_card(caplog, capsys):
    import logging

    with caplog.at_level(logging.INFO, logger="mdx_torch.pipeline.prime"):
        rc = PP.main(["--shapes", "32x32", "--chunk", "2", "--dtypes",
                      "uint8, float32", "--window", "off", "--tuning",
                      "--issues", "low_contrast"], device="cpu")
    assert rc == 0
    # single + uint8 + float32, then one sweep and the three tool functions
    assert "primed 7 programs" in caplog.messages
    if not torch.cuda.is_available():
        assert PP.main(["--shapes", "32x32"]) == 1
        assert capsys.readouterr().out.startswith(
            "ERROR: mdx_torch runs on device 'cuda'")


def test_host_build_failure_raises(monkeypatch):
    from mdx_torch.io import native

    def refuse(*_args, **_kwargs):
        raise native.NativeBuildError("g++ refused the source")

    monkeypatch.delenv("MDX_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "build", refuse)
    with pytest.raises(native.NativeBuildError, match="refused"):
        PP.prime([(32, 32)], device="cpu", log=lambda _m: None)


def test_no_native_builds_no_host_library(monkeypatch):
    from mdx_torch.io import native

    def refuse(*_args, **_kwargs):
        raise AssertionError("built with MDX_NO_NATIVE set")

    monkeypatch.setenv("MDX_NO_NATIVE", "1")
    monkeypatch.setattr(native, "build", refuse)
    msgs = []
    PP.build_libraries(torch.device("cpu"), log=msgs.append)
    assert msgs[1] == ("host codec library: not built (MDX_NO_NATIVE is "
                       "set: the Python loops run)")
