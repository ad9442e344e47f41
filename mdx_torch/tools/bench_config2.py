"""BASELINE config 2 on the card: batched 2048^2 chest X-ray, denoise ->
CLAHE -> unsharp on a device batch of 64.

    python -m mdx_torch.tools.bench_config2 [--batch 64] [--hw 2048]
        [--groups 0] [--reps 5] [--bare] [--device cuda]

The counterpart of ``examples/bench_config2.py``.  The batch is
``make_batch(batch, hw)`` and the plan ``config2_plan`` (static ops
denoise, clahe, unsharp; tile 16; no bilateral; clip 0.02, radius 1.0,
amount 0.6, soft denoise).  It times ``apply_plan``, the guarded path, run
through ``map_subbatches`` at the port's ``group_limit`` (``--groups N``
pins the group); ``--bare`` times the bare 3-op chain (``_run_chain``
with all-ones masks, no guards).  One JSON line: hw, batch, group,
ms_per_batch (median of ``--reps`` synchronised reps after one warm-up),
img_per_s, peak_mem_gib (``torch.cuda.max_memory_allocated`` over the
timed reps) and the card's ``name, power.limit``.  ``--device cpu`` runs
the same code on the CPU (small sizes only; no card fields).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def step_fn(static, bare: bool):
    """The per-group function the benchmark maps over the batch: the
    guarded ``apply_plan`` (returns its output), or with ``bare`` the 3-op
    chain alone."""
    from mdx_torch.core import enhance as E

    if bare:
        def run(x, d):
            masks = {op: torch.ones(x.shape[0], dtype=torch.bool,
                                    device=x.device) for op in E.OP_ORDER}
            return E._run_chain(x, static.order(), static, d, masks,
                                d.unsharp_amount)
    else:
        def run(x, d):
            return E.apply_plan(x, static, d)[0]
    return run


def run_config2(x: torch.Tensor, static, dyn, group: int, bare: bool = False):
    """Config 2 on ``x`` in groups of ``group``: the enhanced batch."""
    from mdx_torch.core.batching import map_subbatches

    return map_subbatches(step_fn(static, bare), x, dyn,
                          groups=(group,))


def main(argv=None) -> int:
    from mdx_torch.core.batching import group_limit, group_size
    from mdx_torch.tools import card_line, config2_plan, make_batch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hw", type=int, default=2048)
    ap.add_argument("--groups", type=int, default=0,
                    help="0 = the port's group_limit; N pins the group")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bare", action="store_true",
                    help="time the bare 3-op chain, no safeguards")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_config2: no CUDA card (--device cpu runs "
                         "on the CPU)")
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    static, dyn = config2_plan(dev)
    group = args.groups or group_limit((1, args.hw, args.hw))
    x = torch.from_numpy(make_batch(args.batch, args.hw)).to(dev)
    out = run_config2(x, static, dyn, group, args.bare)   # warm-up
    finite = bool(torch.isfinite(out).all())
    del out
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        run_config2(x, static, dyn, group, args.bare)
        sync()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    rec = {"config": "2: denoise+clahe+unsharp",
           "path": "bare chain" if args.bare else "apply_plan",
           "hw": args.hw, "batch": args.batch,
           "group": group_size(args.batch, x.shape, (group,)) or args.batch,
           "device": str(dev), "reps": args.reps, "ms_per_batch": ms,
           "ms_min": min(times) * 1e3, "ms_max": max(times) * 1e3,
           "img_per_s": args.batch / (ms / 1e3), "finite": finite}
    if on_card:
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["card"] = card_line()
    print(json.dumps(rec))
    return 0 if finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
