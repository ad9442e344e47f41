"""``run_ms_p95`` of a cell where the host's speed spreads it too widely
for a bound: the 95th percentile ms of all the traced window's
single-file runs, host clock."""

import numpy as np


def read(r):
    ms = [x["ms"] for x in r.runs if x["frames"]]
    return float(np.percentile(ms, 95)) if ms else None
