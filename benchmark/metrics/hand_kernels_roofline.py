"""Sum of the hand-kernel calls' bounds over the hand kernels' device time
in the traced window, in percent (bounds: mdxbench.roofline)."""


def read(r):
    if not r.kernel_s or not r.bound_ms:
        return None
    s = sum(v for name, v in r.kernel_s.items() if r.is_hand(name))
    return 100.0 * r.bound_ms / (s * 1e3) if s > 0 else None
