"""The generator: the same seed gives the same files, another seed other
pixels but the same conditions and sizes."""

import collections
import json

import numpy as np
import pytest
import torch

from mdxbench import inputs, spec
from reference import dicom as RD


def _pool(tiny, workload, seed, root):
    cell = spec.load(tiny, workload, tiny.parent)
    return spec.entry(cell).pool(cell, str(root), seed, torch.device("cpu"))


@pytest.mark.parametrize("workload", ["ct512.series", "cxr2048.series",
                                      "ct512.single"])
def test_same_seed_same_files(tiny, tmp_path, workload):
    a = _pool(tiny, workload, 2**31 + 11, tmp_path / "a")
    b = _pool(tiny, workload, 2**31 + 11, tmp_path / "b")
    c = _pool(tiny, workload, 2**31 + 12, tmp_path / "c")
    fa = [it.path for g in a for it in g]
    fb = [it.path for g in b for it in g]
    fc = [it.path for g in c for it in g]
    assert all(open(x, "rb").read() == open(y, "rb").read()
               for x, y in zip(fa, fb))
    assert any(not np.array_equal(RD.read(x)["frame"], RD.read(y)["frame"])
               for x, y in zip(fa, fc))
    # the same conditions in another order
    count = lambda pool: collections.Counter(  # noqa: E731
        it.conditions for g in pool for it in g)
    assert count(a) == count(c)


def test_condition_shares(tiny):
    mix = json.loads((tiny.parent / "traffic" / "series.json").read_text())
    n = 1024
    got = collections.Counter(c for j in range(n)
                              for c in inputs.conditions(j, n, mix))
    for name in ("noise", "blur", "compressed"):
        assert got[name] == round(mix["conditions"][name]["share"] * n)


def test_stored_values(tiny, tmp_path):
    pool = _pool(tiny, "ct512.series", 5, tmp_path)
    ds = RD.read(pool[0][0].path)
    lo, hi = inputs.stored_range(json.loads(
        (tiny.parent / "configs" / "ct512.json").read_text()))
    assert ds["frame"].dtype == np.int16 and ds["signed"] == 1
    assert lo <= ds["frame"].min() and ds["frame"].max() <= hi
    assert (ds["wc"], ds["ww"], ds["intercept"]) == ("40", "400", -1024.0)
