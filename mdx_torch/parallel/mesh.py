"""A rank's place in the ``(data, space)`` grid — counterpart of
``mdx/parallel/mesh.py`` ``make_mesh``.

Rank ``r`` of ``n_data × n_space`` ranks holds data row ``r // n_space``
(a slice of the images) and space column ``r % n_space`` (a block of their
rows).  The ``space`` ranks of one data row exchange halos and reduce
together; the ``data`` axis needs no collective except the uniform stop and
guard flags, which reduce over all ranks.

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


@dataclass
class SpatialMesh:
    """This rank in an ``n_data × n_space`` grid of ranks.

    ``space_group`` / ``data_group`` are the process groups of this rank's
    data row / space column (``None`` = all ranks); ``host_round_trips``
    counts the collectives that went through host memory (gloo with CUDA
    tensors)."""

    rank: int
    n_data: int
    n_space: int
    device: torch.device
    backend: str
    space_group: object = None
    data_group: object = None
    host_round_trips: int = 0

    @property
    def world(self) -> int:
        return self.n_data * self.n_space

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    @property
    def is_first(self) -> bool:
        """This rank holds the global top rows."""
        return self.space_index == 0

    @property
    def is_last(self) -> bool:
        """This rank holds the global bottom rows."""
        return self.space_index == self.n_space - 1

    @property
    def staged(self) -> bool:
        """Collectives copy CUDA tensors through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(rank: int, n_data: int, n_space: int, device,
              backend: str) -> SpatialMesh:
    """The mesh of ``rank`` once the default process group is up.  Every
    rank must call it (creating a process group is itself collective)."""
    if n_data * n_space != dist.get_world_size():
        raise ValueError(f"mesh {n_data}×{n_space} needs "
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
                       space_group, data_group)


def mesh_from_env(n_space: int | None = None,
                  device: str = "cuda") -> SpatialMesh:
    """Join the ranks of a ``torchrun`` launch (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and return this rank's
    mesh: ``n_space`` row blocks (default: all ranks), the rest on ``data``;
    on the card each rank takes ``cuda:LOCAL_RANK``."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    n_space = world if n_space is None else int(n_space)
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
    return make_mesh(rank, world // n_space, n_space, dev, backend)
