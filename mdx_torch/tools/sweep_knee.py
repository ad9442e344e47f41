"""The group-size knee of ``mdx_torch.core.batching``, measured on the card.

    python -m mdx_torch.tools.sweep_knee [--reps 5]

The counterpart of ``tools/sweep_knee.py``.  Times ``qa_plan`` with the
bench plan (``bench_plan``) on ``make_batch`` batches, run through
``map_subbatches`` with the group pinned:

* 512^2: batch 32 whole, and batch 128 in groups of 32, 64 and 128;
* 2048^2: batch 64 in groups of 4, 8, 16, 32 and 64.

For each (size, batch, group) one JSON line: the median ms of ``--reps``
synchronised reps after one warm-up, ms per image, and
``torch.cuda.max_memory_allocated`` over those reps in GiB.  A group that
does not fit the card's memory reads ``"oom": true``.  The card's
``name, power.limit`` comes first.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import torch

CASES = ((512, 32, (32,)), (512, 128, (32, 64, 128)),
         (2048, 64, (4, 8, 16, 32, 64)))


def time_group(x, static, dyn, group: int, reps: int) -> dict:
    """``qa_plan`` on ``x`` in groups of ``group``: median ms of ``reps``
    synchronised reps after one warm-up, and the peak memory over them."""
    from mdx_torch.core import qa

    def run():
        out = qa.qa_plan(x, static, dyn, groups=(group,))
        torch.cuda.synchronize()
        return out

    try:
        run()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            times.append(time.perf_counter() - t0)
            del out
    except torch.cuda.OutOfMemoryError:
        gc.collect()
        torch.cuda.empty_cache()
        return {"oom": True}
    ms = statistics.median(times) * 1e3
    return {"ms": ms, "ms_min": min(times) * 1e3, "ms_max": max(times) * 1e3,
            "ms_per_image": ms / x.shape[0],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None) -> int:
    from mdx_torch.tools import bench_plan, card_line, make_batch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_knee needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    static, dyn = bench_plan(dev)
    for hw, batch, groups in CASES:
        x = torch.from_numpy(make_batch(batch, hw)).to(dev)
        for g in groups:
            rec = {"hw": hw, "batch": batch, "group": g, "reps": args.reps}
            rec.update(time_group(x, static, dyn, g, args.reps))
            print(json.dumps(rec), flush=True)
        del x
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
