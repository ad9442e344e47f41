"""Median over the window's calls of the calling process's own time in a
call (listing, dispatch, records, report, DB rows: the call's wall less
its wait on the ranks) per frame."""

import numpy as np


def read(r):
    v = [x["phase_ms"]["runner.parent_ms_per_frame"] for x in r.runs
         if x["phase_ms"] and "runner.parent_ms_per_frame" in x["phase_ms"]]
    return float(np.median(v)) if v else None
