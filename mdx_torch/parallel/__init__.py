"""The sharded QA paths of mdx_torch over ``torch.distributed``.

Counterpart of ``mdx/parallel/``: the data axis (``batch``, ``stream``: a
stack of slices split on N, no collective) and the spatial layers
(``mesh``, ``spatial``, ``spatial2d``, ``_spmd_stats``, ``wavelet_sp``,
``clahe_sp``, ``tv_sp``, ``plan_sp``): row blocks, or a 2-D grid of tiles.
JAX runs those
as one ``shard_map`` program over a ``(data, space)`` or ``(data, sy, sx)``
mesh; PyTorch has no single-controller SPMD, so here every shard is a
process (a rank) and each ``shard_map`` body is a per-rank function that
takes ``(x_block, ..., mesh=SpatialMesh)``:

* :mod:`.mesh` — :class:`~.mesh.SpatialMesh` (this rank's place in the
  ``n_data × sy × sx`` grid, its device, its process groups), the backend
  rule, ``choose_layout``, the data axis's size (``data_axis``: every
  visible card by default) and padding target (``divisible_batch``);
* :mod:`.batch` — ``pad_batch`` and the data-parallel entry points
  ``qa_deterministic_sharded``, ``qa_plan_sharded`` and ``detect_sharded``
  (numpy ``[N, H, W]`` in, one launch of ``n_data`` ranks, or none for one
  rank); :mod:`.stream` — ``DecodeStream`` and ``stream_batches``, host
  decode ahead of the card with uploads on a copy stream;
* :mod:`.comm` — the only module that calls ``torch.distributed``: row and
  column halos, sums, maxima, gathers, and ``agree`` (rank 0's host
  decision on every rank);
* :mod:`.launch` — :func:`~.launch.run` spawns the ranks, hands each its
  block or tile and returns their numpy results;
* :mod:`.spatial`, :mod:`.spatial2d`, :mod:`.wavelet_sp`, :mod:`.clahe_sp`,
  :mod:`.tv_sp`, :mod:`.plan_sp` — the sharded metric pass, enhancement
  chain and QA steps, which take their layout from the mesh.  The host
  entry points (``image_stats_spatial``, ``enhance_spatial``,
  ``qa_spatial``, ``qa_plan_spatial``) take an ``[N, H, W]`` numpy array
  (``plan_sp.autotune_spatial`` one ``[H, W]`` slice) and ``n_space`` (row
  blocks, or ``(sy, sx)`` tiles) and run on the card unless the caller
  passes ``device="cpu"``; ``mdx_torch.pipeline.spatial_runner`` runs the
  CLI's ``--spatial`` on them.

Importing this package starts no process and builds nothing.
"""

from mdx_torch.parallel.batch import (
    detect_sharded, pad_batch, qa_deterministic_sharded, qa_plan_sharded,
)
from mdx_torch.parallel.mesh import data_axis, divisible_batch, make_mesh

__all__ = [
    "make_mesh", "data_axis", "divisible_batch", "pad_batch",
    "qa_deterministic_sharded", "qa_plan_sharded", "detect_sharded",
]
