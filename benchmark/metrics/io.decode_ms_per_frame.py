"""Host ms of the batch runner's decode stage (``_collect_inputs_raw``,
every file read before the first upload) per frame of the window."""


def read(r):
    ms = r.span_ms.get("decode") if r.span_ms else None
    return sum(ms) / r.frames if ms and r.frames else None
