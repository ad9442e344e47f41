"""mdx on PyTorch and CUDA: the fused QA pass on an NVIDIA Hopper card.

A port of the JAX package ``mdx`` (which stays the reference).  The layout
and function names mirror ``mdx/`` so each function's JAX counterpart is
easy to find:

* :mod:`mdx_torch.ops` — batched ``[N, H, W]`` float32 image primitives;
* :mod:`mdx_torch.core` — metrics, the 7-op enhancement plan with its
  three safeguards, validation, the objective score and the fused QA steps;
* :mod:`mdx_torch.kernels` — hand-written CUDA kernels (``csrc/*.cu``),
  built with ``nvcc`` on first use and bound with ``ctypes``;
* :mod:`mdx_torch.parallel` — the row-sharded QA path, one process per
  row block over ``torch.distributed``.

Every function takes its device from the input tensor.  On a CUDA tensor
the five kernel-backed ops (box statistics, unsharp, CLAHE, TV,
bilateral) launch their kernel, at every image size; on a CPU tensor they
run their plain PyTorch version.
Importing this package builds nothing and needs no card.
"""

from mdx_torch.core import qa
from mdx_torch.core.enhance import (
    DETERMINISTIC_DEFAULTS,
    OP_ORDER,
    PlanDynamic,
    PlanStatic,
    plan_from_numpy,
)
from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS, THRESHOLDS
from mdx_torch.ops.tv import TV_MODES

__all__ = [
    "qa", "PlanStatic", "PlanDynamic", "plan_from_numpy",
    "THRESHOLDS", "ISSUE_ORDER", "METRIC_KEYS", "OP_ORDER",
    "DETERMINISTIC_DEFAULTS", "TV_MODES",
]
