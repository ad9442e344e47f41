"""1 - the union of the device's operation intervals over the traced
window, in percent."""


def read(r):
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
