"""Seconds from the process's start to the window's start: imports, CUDA
context, kernel library, inputs from the seed and the warm-up."""


def read(r):
    return r.setup_s
