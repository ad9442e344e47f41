"""Median over the window's calls of the rank processes a call started
(a one-shot launch starts every rank each call; a pool none once up)."""

import numpy as np


def read(r):
    v = [x["phase_ms"]["ranks.starts_per_call"] for x in r.runs
         if x["phase_ms"] and "ranks.starts_per_call" in x["phase_ms"]]
    return float(np.median(v)) if v else None
