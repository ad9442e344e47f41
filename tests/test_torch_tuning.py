"""The tuning sweep of mdx_torch against the JAX package, on the CPU.

``candidate_grid`` and the record dataclasses must equal the JAX package's
exactly.  ``autotune`` and ``autotune_batch`` run the same numpy images
through both packages: the best index and each record's params and
``chosen`` flag equal, the enhanced pick within ``parity.PIXEL_ATOL``.
``autotune``'s scores agree within ``SCORE_ATOL`` (1e-5: each score is a
weighted sum of validation fields that the port computes in the JAX
package's float32 order; measured 1e-6 on the 64^2 noisy image).
``autotune_batch``'s within ``parity.SCORE_ATOL`` (1e-3): its
low-contrast frame, squeezed into [0.45, 0.55], has gradients on the edges
of the gradient-entropy histogram's bins, so a last-ulp difference moves a
pixel one bin (the ``ENTROPY_ATOL`` case of ``mdx_torch.parity``; measured
2.6e-4 in gradient entropy, 3.9e-4 in the score after its weight of 1.5).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from mdx.core import tuning as JT
from mdx.pipeline import schemas as JS

from mdx_torch import ISSUE_ORDER, parity
from mdx_torch.core import schemas as TS
from mdx_torch.core import tuning as TT

torch.set_num_threads(1)

SCORE_ATOL = 1e-5

SUBSETS = [list(c) for r in range(len(ISSUE_ORDER) + 1)
           for c in itertools.combinations(ISSUE_ORDER, r)]


@pytest.mark.parametrize("issues", SUBSETS, ids=lambda s: "+".join(s) or "none")
def test_candidate_grid_equal(issues):
    assert TT.candidate_grid(issues) == JT.candidate_grid(issues)


@pytest.mark.parametrize("name", ["EnhancementParams", "EnhancementPlan",
                                  "IterationRecord"])
def test_record_fields_and_defaults_equal(name):
    ours = {f.name: f for f in dataclasses.fields(getattr(TS, name))}
    theirs = getattr(JS, name).model_fields
    assert list(ours) == list(theirs)
    for k, f in ours.items():
        t = theirs[k]
        if t.is_required():
            assert f.default is dataclasses.MISSING, k
            assert f.default_factory is dataclasses.MISSING, k
        elif f.default_factory is not dataclasses.MISSING:
            made = f.default_factory()
            want = t.get_default(call_default_factory=True)
            if hasattr(want, "model_dump"):
                made, want = dataclasses.asdict(made), want.model_dump()
            assert made == want, k
        else:
            assert f.default == t.default, k


def _records_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.iteration == b.iteration and a.chosen == b.chosen
        assert dataclasses.asdict(a.plan.params) == b.plan.params.model_dump()
        assert a.plan.recommended_ops == b.plan.recommended_ops


def _noisy_blurred():
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:64, 0:64]
    base = 0.5 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
    return np.clip(base + rng.normal(0, 0.1, (64, 64)), 0, 1).astype(
        np.float32)


def _spy_scores(monkeypatch, module, seen):
    """Record the raw scores ``module.autotune`` hands to plan_records
    (the records round them to 4 places)."""
    inner = module.plan_records

    def rec(cands, ops, tile, scores, *a, **kw):
        seen[module.__name__] = np.asarray(scores, np.float64)
        return inner(cands, ops, tile, scores, *a, **kw)

    monkeypatch.setattr(module, "plan_records", rec)


def test_autotune_vs_jax(monkeypatch):
    img = _noisy_blurred()
    issues = ["noise", "blur"]
    seen = {}
    _spy_scores(monkeypatch, TT, seen)
    _spy_scores(monkeypatch, JT, seen)
    plan, enh, recs = TT.autotune(img, issues, device="cpu")
    j_plan, j_enh, j_recs = JT.autotune(img, issues)
    got, want = seen[TT.__name__], seen[JT.__name__]
    assert got.shape == (27,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert int(np.argmax(got)) == int(np.argmax(want))
    _records_equal(recs, j_recs)
    assert sum(r.chosen for r in recs) == 1
    assert dataclasses.asdict(plan.params) == j_plan.params.model_dump()
    np.testing.assert_allclose(enh, np.asarray(j_enh), rtol=0,
                               atol=parity.PIXEL_ATOL)


def test_autotune_batch_vs_jax(noisy_image, low_contrast_image):
    imgs = np.stack([noisy_image, low_contrast_image])
    issues = [["noise"], ["low_contrast"]]
    plans, enh, scores = TT.autotune_batch(imgs, issues, device="cpu")
    j_plans, j_enh, j_scores = JT.autotune_batch(imgs, issues)
    assert enh.shape == imgs.shape and scores.shape == np.shape(j_scores)
    np.testing.assert_allclose(scores, np.asarray(j_scores), rtol=0,
                               atol=parity.SCORE_ATOL)
    np.testing.assert_array_equal(np.argmax(scores, 1),
                                  np.argmax(np.asarray(j_scores), 1))
    for a, b in zip(plans, j_plans):
        assert dataclasses.asdict(a.params) == b.params.model_dump()
    np.testing.assert_allclose(enh, np.asarray(j_enh), rtol=0,
                               atol=parity.PIXEL_ATOL)
    # each frame's pick equals the single-image sweep on the union grid
    single_plan, single_img, _ = TT.autotune(
        noisy_image, ["noise", "low_contrast"], device="cpu")
    np.testing.assert_array_equal(enh[0], single_img)
    assert plans[0].params == single_plan.params


# ------------------------------------------------------------ the TV mode
# A sweep whose ops hold tv_denoise: the JAX package takes the TV mode from
# MDX_TV_MODE, the port from the ``tv_mode`` argument.  Every candidate has
# tv_denoise_weight 0, so apply_plan masks TV's output away and the mode
# changes the work (the cap on TV's iterations), not the result.
TV_OPS = TT.DEFAULT_OPS + ("tv_denoise",)


def _spy_tv_cap(monkeypatch, seen):
    """Record the ``max_iter`` each TV call of the port's chain receives."""
    from mdx_torch.core import enhance as TE

    inner = TE._tv_chambolle

    def rec(x, weight, eps=2e-4, max_iter=200):
        seen.append(max_iter)
        return inner(x, weight, eps=eps, max_iter=max_iter)

    monkeypatch.setattr(TE, "_tv_chambolle", rec)


@pytest.mark.parametrize("tv_mode,cap", [(None, 200), ("ref", 200),
                                         ("fast", 40), (" FAST ", 40)])
def test_autotune_tv_mode_caps_tv(monkeypatch, tv_mode, cap):
    seen = []
    _spy_tv_cap(monkeypatch, seen)
    img = _noisy_blurred()[:32, :32]
    TT.autotune(img, ["noise"], ops=TV_OPS, device="cpu", tv_mode=tv_mode)
    TT.autotune_batch(np.stack([img, img.T]), [["noise"], ["blur"]],
                      ops=TV_OPS, device="cpu", tv_mode=tv_mode)
    assert seen == [cap, cap]


@pytest.mark.parametrize("call", ["autotune", "autotune_batch"])
def test_autotune_unknown_tv_mode_raises(call):
    img = _noisy_blurred()[:16, :16]
    args = ((img, ["noise"]) if call == "autotune"
            else (img[None], [["noise"]]))
    with pytest.raises(ValueError, match="tv_mode"):
        getattr(TT, call)(*args, ops=TV_OPS, device="cpu", tv_mode="slow")


def test_autotune_fast_tv_vs_jax(monkeypatch):
    monkeypatch.setenv("MDX_TV_MODE", "fast")
    img = _noisy_blurred()
    issues = ["noise", "blur"]
    seen = {}
    _spy_scores(monkeypatch, TT, seen)
    _spy_scores(monkeypatch, JT, seen)
    plan, enh, recs = TT.autotune(img, issues, ops=TV_OPS, device="cpu",
                                  tv_mode="fast")
    j_plan, j_enh, j_recs = JT.autotune(img, issues, ops=TV_OPS)
    got, want = seen[TT.__name__], seen[JT.__name__]
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert int(np.argmax(got)) == int(np.argmax(want))
    _records_equal(recs, j_recs)
    assert dataclasses.asdict(plan.params) == j_plan.params.model_dump()
    np.testing.assert_allclose(enh, np.asarray(j_enh), rtol=0,
                               atol=parity.PIXEL_ATOL)


def test_autotune_batch_fast_tv_vs_jax(monkeypatch, noisy_image):
    monkeypatch.setenv("MDX_TV_MODE", "fast")
    imgs = np.stack([noisy_image, _noisy_blurred()])
    issues = [["noise"], ["blur"]]
    plans, enh, scores = TT.autotune_batch(imgs, issues, ops=TV_OPS,
                                           device="cpu", tv_mode="fast")
    j_plans, j_enh, j_scores = JT.autotune_batch(imgs, issues, ops=TV_OPS)
    # parity.SCORE_ATOL as in test_autotune_batch_vs_jax: the noisy frame's
    # scores differ from JAX's by 3.1e-4 with or without tv_denoise in ops
    np.testing.assert_allclose(scores, np.asarray(j_scores), rtol=0,
                               atol=parity.SCORE_ATOL)
    # the mode changes the work, not the result: TV's output is masked away
    _, enh_no_tv, scores_no_tv = TT.autotune_batch(imgs, issues,
                                                   device="cpu")
    np.testing.assert_array_equal(scores, scores_no_tv)
    np.testing.assert_array_equal(enh, enh_no_tv)
    np.testing.assert_array_equal(np.argmax(scores, 1),
                                  np.argmax(np.asarray(j_scores), 1))
    for a, b in zip(plans, j_plans):
        assert dataclasses.asdict(a.params) == b.params.model_dump()
    np.testing.assert_allclose(enh, np.asarray(j_enh), rtol=0,
                               atol=parity.PIXEL_ATOL)
