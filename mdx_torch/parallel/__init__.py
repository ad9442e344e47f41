"""The spatially-sharded QA path of mdx_torch over ``torch.distributed``.

Counterpart of the 1-D row-block layer of ``mdx/parallel/`` (``mesh``,
``spatial``, ``_spmd_stats``, ``wavelet_sp``, ``clahe_sp``, ``tv_sp``,
``plan_sp``).  JAX runs those as one ``shard_map`` program over a
``(data, space)`` mesh; PyTorch has no single-controller SPMD, so here every
shard is a process (a rank) and each ``shard_map`` body is a per-rank
function that takes ``(x_block, ..., mesh=SpatialMesh)``:

* :mod:`.mesh` — :class:`~.mesh.SpatialMesh` (this rank's place in the
  ``n_data × n_space`` grid, its device, its process groups) and the
  backend rule;
* :mod:`.comm` — the only module that calls ``torch.distributed``: row
  halos, sums, maxima, gathers;
* :mod:`.launch` — :func:`~.launch.run` spawns the ranks, hands each its
  row block and returns their numpy results;
* :mod:`.spatial`, :mod:`.wavelet_sp`, :mod:`.clahe_sp`, :mod:`.tv_sp`,
  :mod:`.plan_sp` — the sharded metric pass, enhancement chain and QA
  steps.  The host entry points (``image_stats_spatial``,
  ``enhance_spatial``, ``qa_spatial``, ``qa_plan_spatial``) take an
  ``[N, H, W]`` numpy array and ``n_space`` and run on the card unless the
  caller passes ``device="cpu"``.

Importing this package starts no process and builds nothing.
"""
