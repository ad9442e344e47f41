"""Collectives of the sharded path — the only module that calls
``torch.distributed``.

Counterparts of the JAX layer's ``lax.ppermute`` halos
(``mdx/parallel/spatial.py:61-97``, ``spatial2d.py:98-129``,
``tv_sp.py:32-89``), ``psum``, ``pmax``/``pmin`` and ``all_gather``
(``wavelet_sp.py:61-74``).  Rows are axis 1 and columns axis 2 of every
exchanged tensor; the row neighbours are the tiles above and below in the
same data row (ranks ``r ∓ sx``), the column neighbours the tiles to the
left and right (``r ∓ 1``).  A rank at the global top (bottom, left,
right) edge gets ``None`` from that side and substitutes its own pad, as
the JAX layer does with ``jnp.where(idx == 0, …)``.  Sums, maxima and
gathers run over the tile group (``space``).

With gloo and CUDA tensors (ranks sharing one card) each call copies what
it sends or reduces to host memory and back; ``mesh.host_round_trips``
counts those calls.  The compute stays on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mdx_torch.parallel.mesh import SpatialMesh


def _host(mesh: SpatialMesh, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if mesh.staged else t


def _back(mesh: SpatialMesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def _group(mesh: SpatialMesh, axis: str):
    if axis == "space":
        return mesh.space_group
    if axis == "data":
        return mesh.data_group
    if axis == "all":
        return None
    raise ValueError(f"axis must be 'space', 'data' or 'all', got {axis!r}")


def _exchange(to_next, to_prev, mesh: SpatialMesh, step: int, first: bool,
              last: bool):
    """Send ``to_next`` to rank ``rank + step`` and ``to_prev`` to rank
    ``rank − step`` in one batch of point-to-point ops → ``(from_prev,
    from_next)``; ``first``/``last``: this rank has no previous / next
    neighbour on that axis."""
    ops, recv_prev, recv_next = [], None, None
    prev, nxt = mesh.rank - step, mesh.rank + step
    if to_next is not None and not (first and last):
        to_next = _host(mesh, to_next)
        if not last:
            ops.append(dist.P2POp(dist.isend, to_next, nxt))
        if not first:
            recv_prev = torch.empty_like(to_next)
            ops.append(dist.P2POp(dist.irecv, recv_prev, prev))
    if to_prev is not None and not (first and last):
        to_prev = _host(mesh, to_prev)
        if not first:
            ops.append(dist.P2POp(dist.isend, to_prev, prev))
        if not last:
            recv_next = torch.empty_like(to_prev)
            ops.append(dist.P2POp(dist.irecv, recv_next, nxt))
    if not ops:
        return None, None
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if mesh.staged:
        mesh.host_round_trips += 1
    return (None if recv_prev is None else _back(mesh, recv_prev),
            None if recv_next is None else _back(mesh, recv_next))


def exchange_rows(to_next: torch.Tensor | None, to_prev: torch.Tensor | None,
                  mesh: SpatialMesh):
    """Send ``to_next`` to the next row block (the tile below) and
    ``to_prev`` to the previous one, in one batch of point-to-point ops.
    Returns ``(from_prev, from_next)``: what the previous rank sent down and
    what the next rank sent up, each shaped like this rank's own send, or
    ``None`` at the global edge (or where nothing was sent)."""
    return _exchange(to_next, to_prev, mesh, mesh.n_sx, mesh.is_first,
                     mesh.is_last)


def exchange_cols(to_next: torch.Tensor | None, to_prev: torch.Tensor | None,
                  mesh: SpatialMesh):
    """:func:`exchange_rows` over the column neighbours of a 2-D tile grid
    (the tiles to the right and left); with one tile column both are the
    global edge and nothing moves."""
    return _exchange(to_next, to_prev, mesh, 1, mesh.is_first_col,
                     mesh.is_last_col)


def rows_from_prev(v: torch.Tensor, n: int, mesh: SpatialMesh):
    """The previous space rank's last ``n`` rows of ``v`` (``None`` on the
    first rank)."""
    return exchange_rows(v[:, v.shape[1] - n:], None, mesh)[0]


def rows_from_next(v: torch.Tensor, n: int, mesh: SpatialMesh):
    """The next space rank's first ``n`` rows of ``v`` (``None`` on the last
    rank)."""
    return exchange_rows(None, v[:, :n], mesh)[1]


def cols_from_prev(v: torch.Tensor, n: int, mesh: SpatialMesh):
    """The left tile's last ``n`` columns of ``v`` (``None`` at the global
    left edge)."""
    return exchange_cols(v[:, :, v.shape[2] - n:], None, mesh)[0]


def cols_from_next(v: torch.Tensor, n: int, mesh: SpatialMesh):
    """The right tile's first ``n`` columns of ``v`` (``None`` at the global
    right edge)."""
    return exchange_cols(None, v[:, :, :n], mesh)[1]


def _all_reduce(v: torch.Tensor, op, mesh: SpatialMesh,
                axis: str) -> torch.Tensor:
    t = _host(mesh, v).clone()
    dist.all_reduce(t, op=op, group=_group(mesh, axis))
    if mesh.staged:
        mesh.host_round_trips += 1
    return _back(mesh, t)


def psum(v: torch.Tensor, mesh: SpatialMesh, axis: str = "space"
         ) -> torch.Tensor:
    """Sum of ``v`` over the ranks of ``axis`` ('space', 'data', 'all')."""
    return _all_reduce(v, dist.ReduceOp.SUM, mesh, axis)


def pmax(v: torch.Tensor, mesh: SpatialMesh, axis: str = "space"
         ) -> torch.Tensor:
    return _all_reduce(v, dist.ReduceOp.MAX, mesh, axis)


def pmin(v: torch.Tensor, mesh: SpatialMesh, axis: str = "space"
         ) -> torch.Tensor:
    return _all_reduce(v, dist.ReduceOp.MIN, mesh, axis)


def any_all(flags: torch.Tensor, mesh: SpatialMesh) -> bool:
    """Whether any element of ``flags`` is set on ANY rank (space and data):
    the uniform predicate every rank branches on before a branch or a loop
    trip that holds collectives (the JAX layer's psum'd cond predicates,
    ``plan_sp.py:189,212``; ``tv_sp.py:189-198``).  Reads it on the host."""
    one = flags.reshape(-1).any().to(torch.int32).reshape(1)
    return bool(_all_reduce(one, dist.ReduceOp.MAX, mesh, "all").item())


def agree(value, mesh: SpatialMesh) -> int:
    """Rank 0's ``value`` (an int, a bool or a one-element tensor) on every
    rank: one broadcast of 8 bytes over all ranks.  A host decision that
    chooses the collectives to come (the spatial runner's issue flags, the
    sweep's winner) is taken through it: the values it is made from are
    all-reduced and bit-identical on every rank, but a rank that decided
    otherwise would enter another collective and hang until the process
    group's timeout."""
    t = _host(mesh, torch.tensor([int(value)], dtype=torch.int64,
                                 device=mesh.device))
    dist.broadcast(t, src=0)
    if mesh.staged:
        mesh.host_round_trips += 1
    return int(t.item())


def gather_tiles(v: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The tile group's ``v`` [N, h, w] put together as the whole grid
    [N, sy·h, sx·w] on every rank (``all_gather`` over the tile group; with
    one tile column, the row blocks concatenated in rank order)."""
    t = _host(mesh, v)
    parts = [torch.empty_like(t) for _ in range(mesh.n_space)]
    dist.all_gather(parts, t, group=mesh.space_group)
    if mesh.staged:
        mesh.host_round_trips += 1
    sx = mesh.n_sx
    rows = [torch.cat(parts[r * sx:(r + 1) * sx], dim=2)
            for r in range(mesh.n_sy)]
    return _back(mesh, torch.cat(rows, dim=1))


def barrier(mesh: SpatialMesh) -> None:
    """Wait for every rank (an all-reduce, which NCCL and gloo both take on
    the rank's own device)."""
    _all_reduce(torch.zeros(1, device=mesh.device), dist.ReduceOp.SUM,
                mesh, "all")
