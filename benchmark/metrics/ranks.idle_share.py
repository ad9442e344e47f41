"""Median over the window's calls of 100 x (1 - the ranks' mean chunk loop
/ the call's wall), in percent: a card is busy only inside its chunk loop,
so this is the least its idle share can be; the profiler of the harness's
process cannot see the ranks' cards."""

import numpy as np


def read(r):
    v = [x["phase_ms"]["ranks.idle_share"] for x in r.runs
         if x["phase_ms"] and "ranks.idle_share" in x["phase_ms"]]
    return float(np.median(v)) if v else None
