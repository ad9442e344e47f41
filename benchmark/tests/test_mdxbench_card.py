"""On the card, at 64 x 64: the program with its kernels passes every limit
of ``mdxbench.check`` and the bfloat16 control fails one.  Skips without
a card; on the card: ``python -m pytest benchmark/tests -m gpu``."""

import pytest
import torch

import control
from mdxbench import check, spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ct512.series", "cxr2048.series",
                                      "ct512.single", "ct512.autotune"])
def test_limits_on_the_card(tiny, tmp_path, monkeypatch, card, workload):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    cell = spec.load(tiny, workload, tiny.parent)
    keys = check.LIMITS
    sound = control.readings(cell, 717171, str(tmp_path / "p"), card, False)
    ok, checks = check.verdict({k: sound[k] for k in keys if k in sound})
    assert ok and sound["failed"] == 0, checks
    low = control.readings(cell, 727272, str(tmp_path / "c"), card, True)
    ok, checks = check.verdict({k: low[k] for k in keys if k in low})
    assert not ok, checks
