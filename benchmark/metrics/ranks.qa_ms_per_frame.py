"""Median over the window's calls of the slowest rank's chunk loop (first
upload to its last results on the host, synchronised) per frame of its
share, from each call's ``phase_ms`` (the program's ``res["launch"]``)."""

import numpy as np


def read(r):
    v = [x["phase_ms"]["ranks.qa_ms_per_frame"] for x in r.runs
         if x["phase_ms"] and "ranks.qa_ms_per_frame" in x["phase_ms"]]
    return float(np.median(v)) if v else None
