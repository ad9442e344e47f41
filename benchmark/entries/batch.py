"""Entry kind ``batch``: ``mdx_torch.pipeline.batch_runner.run_pipeline_batch``
on one directory of the pool a call, the directories in turn.

A pool of directories of ``frames_per_call`` files each, as many as fill
the mix's ``pool_mib`` of stored pixels (at least one).  Each frame's
answer is its record in the call's ``frames``; the reference recomputes the
same frames from their files in blocks.
"""

from __future__ import annotations

import os

import torch

from mdxbench import check, inputs
from reference import dicom as RD
from reference import qa as RQ

# (module, attribute, span) wrapped in a traced run
SPANS = (
    ("mdx_torch.pipeline.batch_runner", "_collect_inputs_raw", "decode"),
    ("mdx_torch.pipeline.batch_runner", "_device_qa", "device_qa"),
    ("mdx_torch.pipeline.batch_runner", "_Fetch.result", "fetch"),
    ("mdx_torch.pipeline.batch_runner", "_collect", "collect"),
    ("mdx_torch.pipeline.storage", "save_runs_bulk", "db"),
)
SYNCED = frozenset()
_BLOCK_PIXELS = 1 << 24       # pixels the reference takes a block


def pool(cell, root: str, seed: int, dev) -> list[list[inputs.Item]]:
    c = cell.config
    per = int(c["frames_per_call"])
    nbytes = per * int(c["rows"]) * int(c["cols"]) * 2
    calls = max(1, (int(cell.traffic["pool_mib"]) << 20) // nbytes)
    return inputs.write_pool(c, cell.traffic, cell.windowed, root,
                             [per] * calls, seed, dev)


def targets(groups) -> list[str]:
    return [os.path.dirname(g[0].path) for g in groups]


def warmup(groups) -> list[str]:
    return targets(groups)[:1]


def call(cell, target: str, out_dir: str, dev):
    """([(file, the program's raw answer)], frames, phase_ms)."""
    from mdx_torch.pipeline.batch_runner import run_pipeline_batch

    res = run_pipeline_batch(target, out_dir, save_artifacts=True,
                             window=cell.windowed, device=dev, n_data=1)
    return ([(os.path.join(target, rec["source"]), rec)
             for rec in res["frames"]], len(res["frames"]), None)


def extra(runs) -> list[str]:
    return []


def answer(rec: dict) -> dict:
    """A batch call's per-frame record -> an answer."""
    vals = check.metric_values("before", rec["metrics"])
    vals.update(ssim=rec["ssim"], psnr=rec["psnr"],
                quality_improvement=rec["quality_improvement"],
                objective_score=rec["objective_score"])
    return {"issues": set(rec["issues"]), "passed": bool(rec["passed"]),
            "values": vals}


def reference(cell, paths: list[str], dev,
              dtype=torch.float32) -> list[dict]:
    """The reference's answers for frames of batch calls."""
    h, w = RD.read(paths[0])["frame"].shape
    block = max(1, _BLOCK_PIXELS // (h * w))
    out = []
    for s in range(0, len(paths), block):
        x = RD.batch_inputs(paths[s:s + block], cell.windowed, dev).to(dtype)
        r = RQ.qa_deterministic(x)
        v = r["validation"]
        for i in range(x.shape[0]):
            vals = {f"before.{k}": float(r["stats"][k][i])
                    for k in RQ.METRIC_KEYS}
            vals.update(ssim=float(v["ssim"][i]), psnr=float(v["psnr"][i]),
                        quality_improvement=float(
                            v["quality_improvement"][i]),
                        objective_score=float(r["score"][i]))
            out.append({"issues": check.issues(r["issues"], i),
                        "passed": bool(v["passes"][i]), "values": vals,
                        "margin": float(r["margin"][i])})
        del x, r, v
    return out
