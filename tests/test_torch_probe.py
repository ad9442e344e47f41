"""The capability probe's plain versions (``mdx_torch.tools.probe_nvcc``)
against the TPU probe ``tools/probe_mosaic.py`` in interpret mode, on the
CPU.

``tools/probe_mosaic.py`` parses its arguments and picks its backend when it
is imported, so it is loaded by path with ``sys.argv`` set to
``["probe_mosaic.py", "--interpret"]``.  Every probe's ``PLAIN`` function
must equal ``_run(kernel, out_shape, *xs, interpret=True)`` exactly (the
inputs are integers below 2^17 and every probe moves or adds two of them).
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdx_torch.tools import probe_nvcc as PN

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def mosaic(monkeypatch_module):
    monkeypatch_module.setattr(sys, "argv", ["probe_mosaic.py",
                                             "--interpret"])
    spec = importlib.util.spec_from_file_location(
        "probe_mosaic_under_test", ROOT / "tools" / "probe_mosaic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def tpu_probes(mosaic):
    return mosaic._probes(True)


def test_probe_sets_agree(tpu_probes):
    sources = {p.stem for p in PN.PROBE_DIR.glob("*.cu")}
    assert sources == set(tpu_probes) == set(PN.PROBES) == set(PN.PLAIN)


@pytest.mark.parametrize("name", sorted(PN.PROBES))
def test_plain_equals_the_tpu_probe(mosaic, tpu_probes, name):
    kernel, out_shape, xs, check = tpu_probes[name]
    want = mosaic._run(kernel, out_shape, *xs, interpret=True)
    x = PN.probe_input(name)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xs[0]))
    got = PN.plain_output(name, x).numpy()
    np.testing.assert_array_equal(got, want)
    assert check(got)
    lib = PN.LIBRARY[name](x).reshape(got.shape).numpy()
    np.testing.assert_array_equal(lib, want)


def test_matches_uses_the_tpu_check_kind():
    x = PN.probe_input("transpose_2d")
    want = PN.plain_output("transpose_2d", x)
    assert PN.matches("transpose_2d", want.clone(), want)
    assert not PN.matches("transpose_2d", want + 1e-3, want)
    x = PN.probe_input("reshape_split_lanes")
    want = PN.plain_output("reshape_split_lanes", x)
    assert PN.matches("reshape_split_lanes", want * (1 + 1e-7), want)
    assert not PN.matches("reshape_split_lanes", want[:, :-1], want)


def test_launch_refuses_cpu_tensors_and_the_tool_needs_a_card():
    built = PN.Built("transpose_2d", None, "not built", None, None, None, "")
    with pytest.raises(ValueError, match="CUDA"):
        PN.launch("transpose_2d", built, PN.probe_input("transpose_2d"))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import subprocess

    r = subprocess.run([sys.executable, "-m", "mdx_torch.tools.probe_nvcc"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout
