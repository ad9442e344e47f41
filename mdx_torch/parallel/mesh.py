"""A rank's place in the ``(data, space)`` grid — counterpart of
``mdx/parallel/mesh.py`` ``make_mesh`` and ``make_mesh2d``.

The ``space`` ranks of one data row hold the tiles of its images: a
``sy × sx`` grid of tiles (``sx = 1``: row blocks, the 1-D layout).  Rank
``r`` of ``n_data × sy × sx`` ranks holds data row ``r // (sy·sx)``, tile
row ``(r // sx) % sy`` and tile column ``r % sx``.  The ``sy·sx`` ranks of
one data row (the tile group) reduce together; halos go to the row
neighbours (``r ∓ sx``) and the column neighbours (``r ∓ 1``).  The
``data`` axis needs no collective except the uniform stop and guard flags,
which reduce over all ranks.

Backend rule (:func:`choose_backend`), explicit and never a silent
fallback: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU.  NCCL refuses two ranks on one device.  With gloo
and CUDA tensors, :mod:`mdx_torch.parallel.comm` stages each exchanged or
reduced tensor through host memory and counts the round trips.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


def choose_backend(device_type: str, world: int, n_cards: int,
                   backend: str | None = None) -> str:
    """``backend`` if given and allowed, else NCCL for one card per rank
    and gloo otherwise.  NCCL on the CPU or on shared cards raises."""
    shared = device_type != "cuda" or world > n_cards
    if backend is None:
        return "gloo" if shared else "nccl"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and shared:
        raise ValueError(
            f"NCCL needs one CUDA card per rank: {world} ranks on "
            f"{n_cards if device_type == 'cuda' else 0} cards; use gloo")
    return backend


def data_axis(n_data: int | None, device) -> int:
    """The size of the ``data`` axis: ``n_data``, or with None every
    visible card on the card and 1 on the CPU (the counterpart of
    ``make_mesh()``'s default, ``mdx/parallel/mesh.py:35-36``)."""
    if n_data is None:
        n_data = (torch.cuda.device_count()
                  if torch.device(device).type == "cuda" else 1)
    if n_data < 1:
        raise ValueError(f"the data axis needs at least one rank, got "
                         f"{n_data} (device {device!r})")
    return int(n_data)


def divisible_batch(n: int, n_data: int) -> int:
    """Smallest multiple of ``n_data`` ≥ n: the padding target of a batch
    on the data axis (``mdx/parallel/mesh.py:86``)."""
    return -(-n // n_data) * n_data


def grid(n_space) -> tuple[int, int]:
    """``n_space`` as an int (row blocks) or a pair ``(sy, sx)`` → (sy, sx)."""
    if isinstance(n_space, (tuple, list)):
        sy, sx = (int(v) for v in n_space)
    else:
        sy, sx = int(n_space), 1
    if sy < 1 or sx < 1:
        raise ValueError(f"a tile grid needs sy, sx ≥ 1, got {n_space!r}")
    return sy, sx


def choose_layout(h: int, w: int, n_devices: int,
                  min_per_shard: int = 16) -> tuple[int, int]:
    """The (sy, sx) tile grid for an H×W slice on ``n_devices`` ranks — the
    port's copy of ``mdx/pipeline/spatial_runner.py`` ``choose_layout``.

    The most ranks usable first, then the squarest grid (the shortest halo
    perimeter per tile).  Per axis the extent divides evenly, the per-tile
    extent is even (the stride-2 wavelet phase) and ≥ ``min_per_shard``
    (the widest stencil halo).  (1, 1) always works."""
    best, best_key = (1, 1), (1, 0)
    for used in range(n_devices, 0, -1):
        for sy in range(1, used + 1):
            if used % sy:
                continue
            sx = used // sy
            if any(extent % k or (extent // k) % 2
                   or extent // k < min_per_shard
                   for extent, k in ((h, sy), (w, sx))):
                continue
            key = (used, -abs(sy - sx))
            if key > best_key:
                best_key, best = key, (sy, sx)
        if best_key[0] == used:
            break
    return best


@dataclass
class SpatialMesh:
    """This rank in an ``n_data × n_space`` grid of ranks, the ``n_space``
    ranks of a data row being a grid of ``n_sy × n_sx`` tiles.

    ``space_group`` / ``data_group`` are the process groups of this rank's
    data row (the tile group) / space position (``None`` = all ranks);
    ``host_round_trips`` counts the collectives that went through host
    memory (gloo with CUDA tensors)."""

    rank: int
    n_data: int
    n_space: int
    device: torch.device
    backend: str
    space_group: object = None
    data_group: object = None
    host_round_trips: int = 0
    n_sx: int = 1

    @property
    def world(self) -> int:
        return self.n_data * self.n_space

    @property
    def n_sy(self) -> int:
        return self.n_space // self.n_sx

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        """This rank's place in its tile group (row-major over the tiles)."""
        return self.rank % self.n_space

    @property
    def row_index(self) -> int:
        return self.space_index // self.n_sx

    @property
    def col_index(self) -> int:
        return self.space_index % self.n_sx

    @property
    def is_first(self) -> bool:
        """This rank holds the global top rows."""
        return self.row_index == 0

    @property
    def is_last(self) -> bool:
        """This rank holds the global bottom rows."""
        return self.row_index == self.n_sy - 1

    @property
    def is_first_col(self) -> bool:
        """This rank holds the global left columns."""
        return self.col_index == 0

    @property
    def is_last_col(self) -> bool:
        """This rank holds the global right columns."""
        return self.col_index == self.n_sx - 1

    @property
    def staged(self) -> bool:
        """Collectives copy CUDA tensors through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(rank: int, n_data: int, n_space: int, device,
              backend: str) -> SpatialMesh:
    """The 1-D mesh of ``rank`` (``n_space`` row blocks) once the default
    process group is up.  Every rank must call it (creating a process group
    is itself collective)."""
    return make_mesh2d(rank, n_data, n_space, 1, device, backend)


def make_mesh2d(rank: int, n_data: int, n_sy: int, n_sx: int, device,
                backend: str) -> SpatialMesh:
    """The mesh of ``rank`` in an ``n_data × n_sy × n_sx`` grid (the
    counterpart of ``mdx/parallel/mesh.py:48-68``): the tile group of its
    data row and the data group of its tile.  ``n_sx = 1`` is
    :func:`make_mesh`'s grid, groups and all."""
    n_space = n_sy * n_sx
    if n_data * n_space != dist.get_world_size():
        raise ValueError(f"mesh {n_data}×{n_sy}×{n_sx} needs "
                         f"{n_data * n_space} ranks, have "
                         f"{dist.get_world_size()}")
    space_group = data_group = None
    if n_data > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_space, (d + 1) * n_space)))
            if rank // n_space == d:
                space_group = g
    if n_space > 1 and n_data > 1:
        for s in range(n_space):
            g = dist.new_group(list(range(s, n_data * n_space, n_space)))
            if rank % n_space == s:
                data_group = g
    return SpatialMesh(rank, n_data, n_space, torch.device(device), backend,
                       space_group, data_group, n_sx=n_sx)


def mesh_from_env(n_space=None, device: str = "cuda") -> SpatialMesh:
    """Join the ranks of a ``torchrun`` launch (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and return this rank's
    mesh: ``n_space`` row blocks or ``(sy, sx)`` tiles (default: all ranks
    in row blocks), the rest on ``data``; on the card each rank takes
    ``cuda:LOCAL_RANK``."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    sy, sx = grid(world if n_space is None else n_space)
    n_space = sy * sx
    if world % n_space:
        raise ValueError(f"{world} ranks do not split into rows of "
                         f"{n_space} space ranks")
    if device == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        n_cards = torch.cuda.device_count()
    else:
        dev, n_cards = torch.device("cpu"), 0
    # ranks per host share that host's cards
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(dev.type, local, n_cards)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return make_mesh2d(rank, world // n_space, sy, sx, dev, backend)
