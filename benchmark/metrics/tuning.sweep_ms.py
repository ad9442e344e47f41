"""Median ms of the span around ``mdx_torch.core.tuning.autotune``, closed
by a device synchronise."""

import numpy as np


def read(r):
    ms = r.span_ms.get("sweep") if r.span_ms else None
    return float(np.median(ms)) if ms else None
