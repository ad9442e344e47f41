"""Median over the runs of the runner's ``device_qa`` phase (it ends with
the results on the host), from each run's own ``phase_ms``."""

import numpy as np


def read(r):
    ms = [x["phase_ms"]["device_qa"] for x in r.runs
          if x["phase_ms"] and "device_qa" in x["phase_ms"]]
    return float(np.median(ms)) if ms else None
