"""Frames of every batch call of the window over the window's length,
host clock (the window ends when the call in flight at its end returns)."""


def read(r):
    return r.frames / r.host_window_s if r.host_window_s > 0 else None
