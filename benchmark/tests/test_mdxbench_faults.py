"""A whole run on the CPU, with the look for a card skipped: sound, it is
correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault a cell can have on one chip."""

import numpy as np
import pytest
import torch

CELLS = ["ct512.series", "cxr2048.series", "ct512.single", "ct512.autotune"]


def _state_unchanged(monkeypatch):
    """The enhancement step returns its input."""
    from mdx_torch.core import enhance

    orig_plan = enhance.apply_plan
    monkeypatch.setattr(enhance, "apply_issue_driven",
                        lambda x, issues: (x, {"noise_amp": issues["noise"]}))
    monkeypatch.setattr(enhance, "apply_plan",
                        lambda x, *a, **k: (x, orig_plan(x, *a, **k)[1]))


def _half_batch(monkeypatch):
    """The metric pass sees half of the batch; the other half gets the
    mean of its results."""
    from mdx_torch.core import metrics

    orig = metrics.image_stats

    def half(x):
        n = x.shape[0]
        if n < 2:
            return {k: v * 1.5 for k, v in orig(x).items()}
        s = orig(x[: n // 2])
        return {k: torch.cat([v, v.float().mean().expand(n - n // 2)
                              .to(v.dtype)]) for k, v in s.items()}

    monkeypatch.setattr(metrics, "image_stats", half)


def _quarter_off(monkeypatch):
    """A quarter of the frames comes out 1 % off: the last quarter of each
    batch the metric pass sees (one group of 16 in a 64-image call), or the
    runs of every fourth file of a single-file pool."""
    import os
    import re

    from mdx_torch.core import metrics
    from mdx_torch.pipeline import runner

    orig, orig_run = metrics.image_stats, runner.run_pipeline
    state = {"on": False}

    def stats(x):
        n = x.shape[0]
        lo = n - n // 4 if n >= 4 else (0 if state["on"] else n)
        return {k: torch.cat([v[:lo], (v[lo:].double() * 1.01).to(v.dtype)])
                for k, v in orig(x).items()}

    def run(path, *a, **k):
        index = int(re.sub(r"\D", "", os.path.basename(path)) or 1)
        state["on"] = index % 4 == 0
        try:
            return orig_run(path, *a, **k)
        finally:
            state["on"] = False

    monkeypatch.setattr(metrics, "image_stats", stats)
    monkeypatch.setattr(runner, "run_pipeline", run)


def _answer_altered(monkeypatch):
    """The objective (batch) or the enhanced pixels (single runs) are
    altered where they are produced."""
    from mdx_torch.core import qa, score, tuning

    orig_score = score.objective_score
    monkeypatch.setattr(qa, "objective_score",
                        lambda v: (lambda s: (s[0] * 1.01 + 1e-3, s[1]))(
                            orig_score(v)))
    orig_auto = tuning.autotune

    def auto(*a, **k):
        plan, img, rec = orig_auto(*a, **k)
        return plan, np.clip(img + 0.01, 0.0, 1.0), rec

    monkeypatch.setattr(tuning, "autotune", auto)
    orig_det = qa.qa_deterministic

    def det(x, groups=None):
        out = list(orig_det(x, groups))
        out[0] = torch.clamp(out[0] + 0.01, 0.0, 1.0)
        return tuple(out)

    monkeypatch.setattr(qa, "qa_deterministic", det)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, cpu_run, workload):
    result, notes = cpu_run(tiny, workload)
    assert result["correct"], notes
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _quarter_off, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tiny, cpu_run, monkeypatch, workload, fault):
    fault(monkeypatch)
    result, notes = cpu_run(tiny, workload)
    assert result is not None and not result["correct"], notes


@pytest.mark.parametrize("workload", CELLS)
def test_quarter_off_is_held_frame_by_frame(tiny, cpu_run, monkeypatch,
                                            workload):
    """The frames a fault hit are counted; in a batch, where it hit a
    quarter of them, every field's median stays within its limit."""
    _quarter_off(monkeypatch)
    result, notes = cpu_run(tiny, workload)
    assert result["checks"]["frames_off"][0] > 0, notes
    if workload.endswith(".series"):
        assert result["checks"]["gap"][0] <= result["checks"]["gap"][1]
