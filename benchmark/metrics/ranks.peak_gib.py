"""The largest rank's ``torch.cuda.max_memory_allocated()`` over the
window's calls (each rank resets its peak as a call starts), in GiB."""


def read(r):
    v = [x["phase_ms"]["ranks.peak_bytes"] for x in r.runs
         if x["phase_ms"] and "ranks.peak_bytes" in x["phase_ms"]]
    return max(v) / 2 ** 30 if v else None
