"""``run_ms_p50`` of a cell where the host's speed spreads it too widely
for a bound: the median ms of the traced window's single-file runs, host
clock."""

import numpy as np


def read(r):
    ms = [x["ms"] for x in r.runs if x["frames"]]
    return float(np.percentile(ms, 50)) if ms else None
