"""Spawn the ranks of a sharded call and collect their results.

:func:`run` splits each input ``[N, H, W]`` array into ``n_data`` slices of
images and ``n_space`` tiles (an int: blocks of rows; a pair ``(sy, sx)``:
a grid of tiles), starts one process per rank
(``torch.multiprocessing``, start method ``spawn``), joins them into a
process group through a ``FileStore`` in a fresh temporary directory (no
ports, so parallel launches cannot clash), calls
``fn(*blocks, *args, mesh=mesh, **kwargs)`` on every rank and returns the
ranks' results as numpy.  Tensors among ``args`` travel as host copies and
reach each rank on its own device.

``fn`` must be importable by the spawned ranks (a module-level function of
the package): a spawned rank re-imports it by name, so a function of a test
module would drag that module's imports (JAX, the conftest) into every rank.

On the card the kernel library is built here, once, before any rank starts:
ranks that each found it missing would each run nvcc.  A rank that raises,
dies or outlives ``timeout_s`` makes :func:`run` raise; the other ranks are
stopped.  Nothing is printed.
"""

from __future__ import annotations

import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from mdx_torch.parallel.mesh import choose_backend, grid


@dataclass
class Launched:
    """What :func:`run` returns: per-rank results (rank order) and how the
    ranks ran."""

    results: list
    backend: str
    devices: list[str]
    host_round_trips: list[int]
    n_space: int | tuple[int, int]
    n_data: int

    def info(self) -> dict:
        """What an entry point reports under ``"launch"``: the backend, the
        grid (``n_space`` an int for row blocks, ``(sy, sx)`` for tiles),
        and the most host round trips any rank made."""
        return {"backend": self.backend, "n_space": self.n_space,
                "n_data": self.n_data,
                "host_round_trips": max(self.host_round_trips)}


def _map(tree, fn):
    """Apply ``fn`` to the tensor and array leaves of nested dicts, lists,
    tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def to_numpy(tree):
    """Tensors → numpy arrays (host copies), everything else as it is."""
    return _map(tree, lambda t: t.detach().cpu().numpy()
                if torch.is_tensor(t) else t)


def _to_host(tree):
    return _map(tree, lambda t: t.detach().cpu() if torch.is_tensor(t) else t)


def _to_device(tree, device):
    return _map(tree, lambda t: t.to(device) if torch.is_tensor(t) else t)


def _normal(n_space):
    """``n_space`` as :func:`run` reports it: an int for row blocks, the
    pair (sy, sx) for a 2-D grid."""
    sy, sx = grid(n_space)
    return sy if sx == 1 else (sy, sx)


def split(x: np.ndarray, rank: int, n_data: int, n_space) -> np.ndarray:
    """Rank ``rank``'s block of ``x`` [N, H, W]: images of its data row,
    rows and columns of its tile (``n_space``: row blocks or ``(sy, sx)``)."""
    sy, sx = grid(n_space)
    n, h, w = x.shape
    d, s = rank // (sy * sx), rank % (sy * sx)
    r, c = s // sx, s % sx
    nd, hs, ws = n // n_data, h // sy, w // sx
    return np.ascontiguousarray(
        x[d * nd:(d + 1) * nd, r * hs:(r + 1) * hs, c * ws:(c + 1) * ws])


def assemble(results: list, n_data: int, n_space,
             block_keys=("enhanced",)) -> dict:
    """The per-rank result dicts of a sharded QA call → one dict for the
    whole ``[N, H, W]`` input: ``block_keys`` (tiles) put back in place
    within a data row, every other leaf (per-image [N_local] vectors,
    replicated over ``space``) taken from the data row's first space rank;
    data rows concatenated along images."""
    sy, sx = grid(n_space)
    k = sy * sx
    rows = []
    for d in range(n_data):
        first = results[d * k]
        row = dict(first)
        for key in block_keys:
            row[key] = np.concatenate([
                np.concatenate([results[d * k + r * sx + c][key]
                                for c in range(sx)], axis=2)
                for r in range(sy)], axis=1)
        rows.append(row)

    def cat(*leaves):
        if isinstance(leaves[0], dict):
            return {key: cat(*(lf[key] for lf in leaves)) for key in leaves[0]}
        return np.concatenate(leaves, axis=0)

    return cat(*rows)


@dataclass(frozen=True)
class Block:
    """In the arguments of :func:`call_each`: this rank's block of input
    ``index``."""

    index: int


def call_each(*blocks, calls, mesh) -> list:
    """A rank function that runs several calls in one launch: each
    ``(function, args, kwargs)`` runs as ``function(*args, mesh=mesh,
    **kwargs)`` with every :class:`Block` among the arguments replaced by
    this rank's block; returns the results in order."""
    def resolve(tree):
        if isinstance(tree, Block):
            return blocks[tree.index]
        if isinstance(tree, dict):
            return {k: resolve(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
            return type(tree)(resolve(v) for v in tree)
        return tree

    return [fn(*resolve(args), mesh=mesh, **resolve(kwargs))
            for fn, args, kwargs in calls]


def _rank_main(rank, world, n_data, n_space, device, backend, store_path,
               timeout_s, fn, blocks, args, kwargs, out_queue):
    import torch.distributed as dist

    from mdx_torch.parallel.mesh import make_mesh2d

    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        mesh = make_mesh2d(rank, n_data, *grid(n_space), dev, backend)
        xs = [torch.from_numpy(b).to(dev) for b in blocks]
        out = fn(*xs, *_to_device(args, dev), mesh=mesh,
                 **_to_device(kwargs, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out_queue.put((rank, True, to_numpy(out), mesh.host_round_trips))
    except BaseException:
        out_queue.put((rank, False, traceback.format_exc(), 0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, inputs, *args, n_space, n_data: int = 1,
        device: str = "cuda", backend: str | None = None,
        timeout_s: float = 600.0, **kwargs) -> Launched:
    """Run ``fn`` on ``n_data × n_space`` ranks (see the module doc).

    ``n_space``: an int (row blocks) or a pair ``(sy, sx)`` (a grid of
    tiles).  ``inputs``: one ``[N, H, W]`` numpy array or a tuple of them,
    each split by :func:`split`.  ``device``: "cuda" (rank r on card
    ``r % device_count``) or "cpu".  ``backend``: None for the rule of
    :func:`~mdx_torch.parallel.mesh.choose_backend`, or "gloo"/"nccl"."""
    import torch.multiprocessing as mp

    inputs = (inputs,) if isinstance(inputs, np.ndarray) else tuple(inputs)
    n_space = _normal(n_space)
    sy, sx = grid(n_space)
    world = n_data * sy * sx
    for x in inputs:
        if x.ndim != 3 or x.shape[0] % n_data or x.shape[1] % sy \
                or x.shape[2] % sx:
            raise ValueError(
                f"input {x.shape} does not split into {n_data} image slices "
                + (f"and {sy} row blocks" if sx == 1
                   else f"and {sy}×{sx} tiles"))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{r % n_cards}" for r in range(world)]
        from mdx_torch.kernels import _build

        _build.build()
    elif device == "cpu":
        n_cards = 0
        devices = ["cpu"] * world
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = choose_backend(device, world, n_cards, backend)

    ctx = mp.get_context("spawn")
    out_queue = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(prefix="mdx_torch_launch_"))
    args, kwargs = _to_host(args), _to_host(kwargs)
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world, n_data, n_space, devices[r], backend,
              str(tmp / "store"), timeout_s, fn,
              [split(x, r, n_data, n_space) for x in inputs], args, kwargs,
              out_queue)) for r in range(world)]
    got: dict[int, tuple] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} did not finish within {timeout_s} s")
            try:
                rank, ok, payload, trips = out_queue.get(timeout=min(left, 1))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} exited with code {p.exitcode} "
                            f"without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} raised:\n{payload}")
            got[rank] = (payload, trips)
    finally:
        for p in procs:
            if got.keys() == set(range(world)):
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out_queue.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return Launched([got[r][0] for r in range(world)], backend, devices,
                    [got[r][1] for r in range(world)], n_space, n_data)
