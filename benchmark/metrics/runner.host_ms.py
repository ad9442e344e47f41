"""Median over the runs of the runner's host phases (decode, normalize,
png, report, db), from each run's own ``phase_ms``."""

import numpy as np

HOST = ("decode", "normalize", "png", "report", "db")


def read(r):
    ms = [sum(x["phase_ms"].get(k, 0.0) for k in HOST) for x in r.runs
          if x["phase_ms"]]
    return float(np.median(ms)) if ms else None
