"""Entry kind ``single``: ``mdx_torch.pipeline.runner.run_pipeline`` on one
file of the pool a call, the files in turn (``autotune`` from the mix).

A pool of ``pool_files`` files in one directory.  The warm-up takes one
file of each set of conditions, since each set runs other ops (and the
tuning sweep another number of lanes).  A run's answer adds the enhanced
image and the metrics after it, and a tuning run's the chosen plan; the
sample adds the window's slowest run.
"""

from __future__ import annotations

import numpy as np
import torch

from mdxbench import check, inputs
from reference import dicom as RD
from reference import qa as RQ

# (module, attribute, span) wrapped in a traced run; the sweep's span
# closes after a device synchronise
SPANS = (
    ("mdx_torch.pipeline.runner", "load_dicom", "decode"),
    ("mdx_torch.pipeline.runner", "normalize_image", "normalize"),
    ("mdx_torch.core.qa", "qa_deterministic", "device_qa"),
    ("mdx_torch.core.qa", "detect", "detect"),
    ("mdx_torch.core.tuning", "autotune", "sweep"),
    ("mdx_torch.core.validate", "validate", "validate"),
    ("mdx_torch.pipeline.runner", "save_visuals", "png"),
    ("mdx_torch.pipeline.runner", "build_markdown_report", "report"),
    ("mdx_torch.pipeline.runner", "_persist_run", "db"),
)
SYNCED = frozenset({"sweep"})


def pool(cell, root: str, seed: int, dev) -> list[list[inputs.Item]]:
    return inputs.write_pool(cell.config, cell.traffic, cell.windowed, root,
                             [int(cell.traffic["pool_files"])], seed, dev)


def targets(groups) -> list[str]:
    return [it.path for g in groups for it in g]


def warmup(groups) -> list[str]:
    seen = {}
    for g in groups:
        for it in g:
            seen.setdefault(it.conditions, it.path)
    return list(seen.values())


def call(cell, target: str, out_dir: str, dev):
    """([(file, the program's raw answer)], frames, phase_ms)."""
    from mdx_torch.pipeline.runner import run_pipeline

    res = run_pipeline(target, out_dir, save_artifacts=True,
                       autotune=bool(cell.traffic.get("autotune")),
                       device=dev)
    return [(target, res)], 1, res["phase_ms"]


def extra(runs) -> list[str]:
    """The slowest run's file."""
    slow = max((r for r in runs if r["frames"]), key=lambda r: r["ms"],
               default=None)
    return [] if slow is None else [slow["target"]]


def answer(ctx: dict) -> dict:
    """A single-file run's context -> an answer."""
    v = ctx["validation"]
    vals = check.metric_values("before", ctx["metrics_before"])
    vals.update(check.metric_values("after", ctx["metrics_after"]))
    vals.update(ssim=v.ssim, psnr=v.psnr,
                quality_improvement=v.quality_improvement)
    out = {"issues": set(ctx["issues"]), "passed": bool(v.passes),
           "values": vals,
           "image": np.asarray(ctx["enhanced_image"], np.float32)}
    plan = ctx.get("genai_plan")
    if plan is not None:
        p = plan.params
        out["plan"] = (p.clahe_clip_limit, p.gamma, p.unsharp_radius,
                       p.unsharp_amount, p.post_denoise_strength)
    return out


def reference(cell, paths: list[str], dev,
              dtype=torch.float32) -> list[dict]:
    auto = bool(cell.traffic.get("autotune"))
    return [_reference_run(p, auto, dev, dtype) for p in paths]


def _reference_run(path: str, autotune: bool, dev, dtype) -> dict:
    """The reference's answer for one single-file run."""
    x = torch.from_numpy(RD.single_input(path))[None].to(dev).to(dtype)
    if not autotune:
        r = RQ.qa_deterministic(x)
        issues = check.issues(r["issues"], 0)
        enhanced, v, margin = r["enhanced"], r["validation"], r["margin"]
        stats, extra_ = r["stats"], {}
    else:
        stats = RQ.image_stats(x)
        masks, m_det = RQ.detect_issues(stats)
        issues = check.issues(masks, 0)
        cands = RQ.candidate_grid(sorted(issues))
        p = RQ.qa_plan(x, cands, stats)
        scores = p["score"].to(torch.float64).cpu().numpy()
        best = int(np.argmax(scores))
        enhanced = p["enhanced"][best:best + 1]
        v, m_val = RQ.validate(x, enhanced, stats)
        margin = torch.minimum(torch.minimum(m_det, p["margin"][best:best + 1]),
                               m_val)
        extra_ = {"scores": scores, "plan": best,
                  "grid": [(c["clahe_clip_limit"], c["gamma"],
                            c["unsharp_radius"], c["unsharp_amount"],
                            c["post_denoise_strength"]) for c in cands]}
    vals = {f"before.{k}": float(stats[k][0]) for k in RQ.METRIC_KEYS}
    vals.update({f"after.{k}": float(v["metrics_after"][k][0])
                 for k in RQ.METRIC_KEYS})
    vals.update(ssim=float(v["ssim"][0]), psnr=float(v["psnr"][0]),
                quality_improvement=float(v["quality_improvement"][0]))
    passed = bool(v["passes"][0])
    if not issues:
        # a run with no issues passes on SSIM and PSNR alone
        passed = bool(v["ssim"][0] >= RQ.THRESHOLDS["ssim"]
                      and v["psnr"][0] >= RQ.THRESHOLDS["psnr"])
    out = {"issues": issues, "passed": passed, "values": vals,
           "image": enhanced[0].to(torch.float32).cpu().numpy(),
           "margin": float(margin.reshape(-1)[0]), **extra_}
    if autotune and out["scores"].size > 1:
        # a near tie between the two best candidates is a branch too
        top = np.sort(out["scores"])[-2:]
        tie = abs(top[1] - top[0]) / max(abs(top[1]), 1e-12)
        out["margin"] = min(out["margin"], tie)
    return out
