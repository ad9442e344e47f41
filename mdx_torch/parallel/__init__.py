"""The spatially-sharded QA path of mdx_torch over ``torch.distributed``.

Counterpart of the spatial layers of ``mdx/parallel/`` (``mesh``,
``spatial``, ``spatial2d``, ``_spmd_stats``, ``wavelet_sp``, ``clahe_sp``,
``tv_sp``, ``plan_sp``): row blocks, or a 2-D grid of tiles.  JAX runs those
as one ``shard_map`` program over a ``(data, space)`` or ``(data, sy, sx)``
mesh; PyTorch has no single-controller SPMD, so here every shard is a
process (a rank) and each ``shard_map`` body is a per-rank function that
takes ``(x_block, ..., mesh=SpatialMesh)``:

* :mod:`.mesh` — :class:`~.mesh.SpatialMesh` (this rank's place in the
  ``n_data × sy × sx`` grid, its device, its process groups), the backend
  rule and ``choose_layout``;
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
