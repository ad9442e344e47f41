"""Sub-batching of the QA steps into row groups (PyTorch).

Counterpart of ``mdx/core/batching.py``, with the same rule: a batch of N
images runs whole when N is at or below :func:`group_limit` for its image
size, or when N has no divisor ≥ 2 under that limit; otherwise it runs as
equal groups of the largest such divisor, one after another, and the
outputs are concatenated back along N.  Every QA step is per image, so
grouping is the identity on results.

On the TPU the groups keep XLA's fusion at its batch-32 operating point.
The card has its own knee, measured with ``python -m
mdx_torch.tools.sweep_knee`` (``qa_plan`` with the bench plan, median of 5
synchronised reps; NVIDIA H100 80GB HBM3, 700.00 W):

    size     batch  group  ms/batch  ms/image  peak GiB
    512^2       32     32      74.8     2.338      0.47
    512^2      128     32     325.0     2.539      0.66
    512^2      128     64     193.3     1.511      1.07
    512^2      128    128     169.7     1.325      1.75
    2048^2      64      4    1583.9    24.749      3.00
    2048^2      64      8    1223.8    19.122      3.50
    2048^2      64     16    1052.3    16.442      5.00
    2048^2      64     32    1090.0    17.031      8.00
    2048^2      64     64    1223.4    19.116     14.00

Larger groups amortise the eager pass's ~3100 launches and its host
reads up to 16 images of 2048^2 (64M pixels); past that the time per
image rises again while the memory keeps growing.  At 512^2 the largest
group measured, 128 images (32M pixels), is the fastest.  Hence
``PIXEL_KNEE`` = 16 x 2048^2 pixels and ``MAX_GROUP`` = 128.
"""

from __future__ import annotations

import torch

# Pixels per group, and the largest group: the measured knee (module
# docstring).
PIXEL_KNEE = 16 * 2048 * 2048
MAX_GROUP = 128


def group_limit(shape) -> int:
    """Largest group for images of ``shape[-2:]``: ``PIXEL_KNEE`` pixels,
    at least 1 image and at most ``MAX_GROUP``."""
    px = int(shape[-2]) * int(shape[-1]) if len(shape) >= 3 else 512 * 512
    return min(MAX_GROUP, max(1, PIXEL_KNEE // px))


def _split(tree, n: int, lo: int, hi: int):
    """``tree`` with every tensor leaf of leading size ``n`` cut to rows
    [lo, hi); other leaves as they are."""
    if torch.is_tensor(tree):
        return tree[lo:hi] if tree.ndim >= 1 and tree.shape[0] == n else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_split(v, n, lo, hi) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_split(v, n, lo, hi) for v in tree)
    if isinstance(tree, dict):
        return {k: _split(v, n, lo, hi) for k, v in tree.items()}
    return tree


def _concat(trees: list):
    """The per-group outputs, concatenated leaf by leaf along dim 0."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.cat(trees, dim=0)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_concat(list(v)) for v in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(list(v)) for v in zip(*trees))
    if isinstance(first, dict):
        return {k: _concat([t[k] for t in trees]) for k in first}
    raise TypeError(f"map_subbatches: cannot concatenate {type(first)}")


def group_size(n: int, shape, groups=None) -> int | None:
    """The group size for a batch of ``n`` images of ``shape``, or None to
    run whole.  ``groups`` overrides the knee with candidate sizes, tried
    in order (tests and sweeps)."""
    if groups is not None:
        return (None if n <= groups[0]
                else next((c for c in groups if n % c == 0), None))
    gmax = group_limit(shape)
    return (None if n <= gmax
            else next((c for c in range(gmax, 1, -1) if n % c == 0), None))


def map_subbatches(fn, x: torch.Tensor, *args, groups=None):
    """``fn(x, *args)`` over row groups of ``x`` (:func:`group_size`), the
    outputs concatenated back to leading N.  Tensor leaves of ``args``
    with a leading N axis (per-image parameters) are split with the rows;
    everything else is passed whole."""
    n = x.shape[0]
    g = group_size(n, x.shape, groups)
    if g is None:
        return fn(x, *args)
    return _concat([fn(x[lo:lo + g], *_split(args, n, lo, lo + g))
                    for lo in range(0, n, g)])
