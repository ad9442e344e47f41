"""The plain reference against the program's CPU path at a small size, and
the lower-precision control against the limits."""

import numpy as np
import pytest
import torch

import control
from mdxbench import check, spec
from reference import dicom as RD
from reference import qa as RQ

CELLS = ["ct512.series", "cxr2048.series", "ct512.single", "ct512.autotune"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_program_on_cpu(tiny, tmp_path, monkeypatch,
                                              workload):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    cell = spec.load(tiny, workload, tiny.parent)
    r = control.readings(cell, 424242, str(tmp_path), torch.device("cpu"),
                         control=False)
    assert r["mismatch"] == 0 and r["failed"] == 0
    # the program's CPU path sums the box statistics in float32, the
    # reference (as the card's kernel) in float64: a few float32 ulp
    for key in ("gap", "pixel", "plan"):
        assert r.get(key, 0.0) <= 1e-4, r
    assert r["frames_off"] == 0, r


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails(tiny, tmp_path, monkeypatch, workload):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    cell = spec.load(tiny, workload, tiny.parent)
    r = control.readings(cell, 515151, str(tmp_path), torch.device("cpu"),
                         control=True)
    readings = {k: r[k] for k in check.LIMITS if k in r}
    ok, _ = check.verdict(readings)
    assert not ok, readings


def test_ingest_matches_program(tiny, tmp_path):
    """The reference's windowed and min-max ingest against the program's
    normalize_ingest on the same stored integers."""
    from mdx_torch.io.dicom import load_frames_raw
    from mdx_torch.ops.ingest import normalize_ingest
    from mdx_torch.pipeline.batch_runner import _ingest_params

    for workload, window in (("ct512.series", True),
                             ("cxr2048.series", False)):
        cell = spec.load(tiny, workload, tiny.parent)
        pool = spec.entry(cell).pool(cell, str(tmp_path / workload), 9,
                                     torch.device("cpu"))
        paths = [it.path for it in pool[0]]
        raws = [load_frames_raw(p, window=window) for p in paths]
        x = torch.from_numpy(np.concatenate([r[0] for r in raws]))
        params = torch.from_numpy(_ingest_params([r[1] for r in raws],
                                                 window))
        prog = normalize_ingest(x, *params, per_frame_minmax=not window)
        ref = RD.batch_inputs(paths, window, torch.device("cpu"))
        assert torch.equal(prog, ref)


def test_single_input_matches_program(tiny, tmp_path):
    from mdx_torch.io import load_dicom, normalize_image

    cell = spec.load(tiny, "ct512.single", tiny.parent)
    pool = spec.entry(cell).pool(cell, str(tmp_path), 3,
                                 torch.device("cpu"))
    for it in pool[0][:3]:
        prog = normalize_image(load_dicom(it.path)[0])
        assert np.array_equal(prog, RD.single_input(it.path))


def test_margin_marks_a_threshold():
    """A frame whose noise estimate sits on the threshold is left out."""
    m = {k: torch.tensor([0.5]) for k in RQ.METRIC_KEYS}
    m["sigma"] = torch.tensor([RQ.THRESHOLDS["noise_sigma"]])
    _, margin = RQ.detect_issues(m)
    assert float(margin[0]) < check.MARGIN


def test_field_limits_by_name_prefix_and_default():
    assert check.field_limit("after.snr_proxy") == 0.2
    assert check.field_limit("after.sigma") == check.FIELD_LIMITS["after.*"]
    assert check.field_limit("before.sigma") == check.FIELD_LIMITS["*"]
    assert check.field_limit("ssim") == check.FIELD_LIMITS["*"]


def _answer(values, margin=1.0):
    return {"issues": set(), "passed": True, "values": values,
            "margin": margin}


def test_every_frame_is_held():
    """One frame of 64 off by 1 % in one field leaves the median at 0 and
    is counted; a pixel's share flipped next to a share of 0 is not."""
    ref = [_answer({"before.sigma": 0.1, "after.pct_high": 0.0})
           for _ in range(64)]
    prog = [_answer(dict(r["values"])) for r in ref]
    prog[5]["values"]["before.sigma"] = 0.101
    prog[9]["values"]["after.pct_high"] = 1.0 / 512 ** 2
    out, left_out, _ = check.compare(prog, ref)
    assert (out["frames_off"], out["gap"], left_out) == (1, 0.0, 0)
