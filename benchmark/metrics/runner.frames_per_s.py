"""``frames_per_s`` of a cell where the host's speed spreads it too widely
for a bound: every frame of every batch call of the traced window over
the window's length, host clock."""


def read(r):
    return r.frames / r.host_window_s if r.host_window_s > 0 else None
