"""Device ms of every kernel that is not a hand kernel of the program
(PyTorch's own sorts, histograms, reductions, elementwise and index ops)
per frame of the traced window."""


def read(r):
    if not r.kernel_s or not r.frames:
        return None
    s = sum(v for name, v in r.kernel_s.items() if not r.is_hand(name))
    return s * 1e3 / r.frames
