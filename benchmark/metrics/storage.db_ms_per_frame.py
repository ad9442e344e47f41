"""Host ms of ``storage.save_runs_bulk`` per frame of the window."""


def read(r):
    ms = r.span_ms.get("db") if r.span_ms else None
    return sum(ms) / r.frames if ms and r.frames else None
