"""Measurement scripts for mdx_torch on a CUDA card.

Run each from the root of a checkout, where ``bench.py`` gives the batch
and the plan:

    python -m mdx_torch.tools.profile_pass   # where one qa_plan pass's time goes
    python -m mdx_torch.tools.op_diff        # each op on the card against the CPU
"""

from __future__ import annotations

import torch


def bench_plan(device):
    """bench.py's plan (``_PLAN_OPS``, ``_PLAN_PARAMS``) as the port's
    ``(PlanStatic, PlanDynamic)`` on ``device``."""
    from bench import _PLAN_OPS, _PLAN_PARAMS as P
    from mdx_torch import plan_from_numpy

    static = {"ops": _PLAN_OPS, "tile_size": P["clahe_tile_size"],
              "bilateral_d": P["bilateral_d"], "plan_order": _PLAN_OPS}
    dyn = {k: P[k] for k in (
        "clahe_clip_limit", "gamma", "unsharp_radius", "unsharp_amount",
        "post_denoise_strength", "bilateral_sigma_color",
        "bilateral_sigma_space", "tv_denoise_weight")}
    dyn["denoise_soft"] = P["denoise_mode"] == "soft"
    return plan_from_numpy(static, dyn, device)


def all_ops_masks(n: int, device) -> dict[str, torch.Tensor]:
    """Per-op masks that select every image for every op."""
    from mdx_torch.core.enhance import OP_ORDER

    return {op: torch.ones(n, dtype=torch.bool, device=device)
            for op in OP_ORDER}


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]
