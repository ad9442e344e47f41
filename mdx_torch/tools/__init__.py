"""Measurement scripts for mdx_torch on a CUDA card, and the batch and
plans they share.

Run each from the root of a checkout:

    python -m mdx_torch.tools.profile_pass   # where one qa_plan pass's time goes
    python -m mdx_torch.tools.op_diff        # each op on the card against the CPU
    python -m mdx_torch.tools.sweep_knee     # qa_plan time and memory per group size
    python -m mdx_torch.tools.bench_config2  # BASELINE config 2: 64x2048^2
    python -m mdx_torch.tools.time_kernels   # each kernel against its plain version
    python -m mdx_torch.tools.profile_kernels  # kernels 10 and C launch by launch
    python -m mdx_torch.tools.tune_sweep     # ms per autotune sweep
    python -m mdx_torch.tools.spatial_check  # the row-sharded path on k ranks
    python -m mdx_torch.tools.time_tv_shard  # sharded TV solves (kernel 12)
    python -m mdx_torch.tools.time_codecs    # lossless JPEG codecs, ms a frame

The port keeps its own copies of the JAX package's benchmark batch and
plans (``bench.py`` ``_make_batch``, ``_PLAN_OPS``, ``_PLAN_PARAMS``;
``examples/bench_config2.py``'s plan); a CPU test holds them equal.
"""

from __future__ import annotations

import numpy as np
import torch

# The benched plan: all seven ops with mid-range parameters, bilateral d=5.
PLAN_OPS = ("denoise", "clahe", "gamma", "unsharp", "post_denoise",
            "bilateral", "tv_denoise")
PLAN_PARAMS = dict(
    clahe_clip_limit=0.02, clahe_tile_size=16, gamma=0.95,
    unsharp_radius=1.0, unsharp_amount=0.6, denoise_mode="soft",
    post_denoise_strength=0.3, bilateral_d=5, bilateral_sigma_color=0.05,
    bilateral_sigma_space=0.05, tv_denoise_weight=0.05)

# BASELINE config 2, batched 2048^2 chest X-ray: denoise -> CLAHE -> unsharp.
CONFIG2_OPS = ("denoise", "clahe", "unsharp")
CONFIG2_STATIC = dict(ops=CONFIG2_OPS, tile_size=16, bilateral_d=0,
                      plan_order=CONFIG2_OPS)
CONFIG2_DYN = dict(clahe_clip_limit=0.02, gamma=1.0, unsharp_radius=1.0,
                   unsharp_amount=0.6, post_denoise_strength=0.0,
                   bilateral_sigma_color=0.05, bilateral_sigma_space=0.05,
                   tv_denoise_weight=0.0, denoise_soft=True)


def make_batch(n: int, hw: int = 512, seed: int = 0) -> np.ndarray:
    """[n, hw, hw] float32 in [0, 1]: a smooth sinusoid plus N(0, 0.06)
    noise, clipped.  Drawn one image at a time from one generator, which
    gives the same numbers as one draw of the whole batch, so a 64x2048^2
    batch needs 1 GiB of float32 and not 2 GiB of float64 noise at once."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    base = 0.35 + 0.3 * np.sin(xx / 37.0) * np.cos(yy / 53.0)
    out = np.empty((n, hw, hw), np.float32)
    for i in range(n):
        out[i] = np.clip(base + rng.normal(0, 0.06, (hw, hw)), 0.0, 1.0)
    return out


def bench_plan(device):
    """The benched plan (``PLAN_OPS``, ``PLAN_PARAMS``) as the port's
    ``(PlanStatic, PlanDynamic)`` on ``device``."""
    from mdx_torch import plan_from_numpy

    P = PLAN_PARAMS
    static = {"ops": PLAN_OPS, "tile_size": P["clahe_tile_size"],
              "bilateral_d": P["bilateral_d"], "plan_order": PLAN_OPS}
    dyn = {k: P[k] for k in (
        "clahe_clip_limit", "gamma", "unsharp_radius", "unsharp_amount",
        "post_denoise_strength", "bilateral_sigma_color",
        "bilateral_sigma_space", "tv_denoise_weight")}
    dyn["denoise_soft"] = P["denoise_mode"] == "soft"
    return plan_from_numpy(static, dyn, device)


def config2_plan(device):
    """BASELINE config 2's plan as the port's ``(PlanStatic, PlanDynamic)``
    on ``device``."""
    from mdx_torch import plan_from_numpy

    return plan_from_numpy(CONFIG2_STATIC, CONFIG2_DYN, device)


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


def device_ms(fn, reps: int, names=None, tries: int = 3) -> float | None:
    """Device time of one call of ``fn`` from a ``torch.profiler`` trace of
    ``reps`` calls on the card: the mean recorded time of each kernel whose
    name holds one of ``names`` (None: every device operation), summed over
    the kernels, so each must run once a call.  The CUDA-event time of a
    call also holds its wrapper's host work whenever that is longer than
    the kernel.  A trace can lose the records of launches of a microsecond
    or so, so each kernel's time is divided by the launches the trace kept,
    not by ``reps``; a trace that kept none is taken again, up to
    ``tries`` times, and None is returned if none shows device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if (any(n in e.key for n in names) if names
                      else e.device_type == DeviceType.CUDA)
                  and e.count and e.device_time_total]
        if events:
            kept = min(e.count for e in events)
            if kept < reps:
                print(f"  the trace kept {kept} of {reps} launches of "
                      f"{[e.key[:40] for e in events]}")
            return sum(e.device_time_total / e.count for e in events) / 1e3
        print(f"  no device time for {names} in the trace; its device "
              f"events: {[e.key[:60] for e in prof.key_averages()][:12]}")
    return None
