"""Median over the window's calls of the slowest rank's staging (header,
decode and pixel passes into its pinned chunk buffers) per frame of its
share, from each call's ``phase_ms`` (the program's ``res["launch"]``)."""

import numpy as np


def read(r):
    v = [x["phase_ms"]["ranks.decode_ms_per_frame"] for x in r.runs
         if x["phase_ms"] and "ranks.decode_ms_per_frame" in x["phase_ms"]]
    return float(np.median(v)) if v else None
