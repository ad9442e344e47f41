"""The ranks of a data axis, kept alive across calls.

:func:`mdx_torch.parallel.launch.run` starts its ranks for one call and
stops them after it: each call pays the processes' start, the torch
import, a CUDA context, the kernel library and a process group (7–25 s).
A :class:`RankPool` of ``d`` ranks pays that once.  Rank 0 is the calling
process, on its own device; ranks 1 … d − 1 are processes it starts
(start method ``spawn``, daemon processes; rank r on the card r places
after the caller's, modulo the cards, or the CPU).  Those join one process
group by launch's backend rule for the whole axis (NCCL when each of the
``d`` ranks has a card of its own, gloo otherwise;
:func:`~.mesh.choose_backend`), which one all-reduce proves.  Then the
pool serves calls: :meth:`RankPool.call` sends ranks 1 … d − 1 their own
arguments, runs rank 0's part here meanwhile, and returns every rank's
result in rank order.  Each rank runs ``fn(*args_r, mesh=mesh,
**kwargs)``; rank 0's mesh has no process group.  Between calls a rank
keeps its CUDA context, the kernel library, the process group and
whatever its bodies leave cached (the caching host allocator's pinned
blocks).

Only what a call names travels, pickled by its sender (so that what cannot
be pickled raises there): the function (by name, so it must be a
module-level function of the package, as for ``launch.run``), the
arguments and the results, through one queue a rank and one back.  A rank
that raises makes the call raise with the rank's traceback once the other
ranks have replied; the pool serves the next call.  A rank that dies, or a
call that outlives ``timeout_s``, makes the call raise and stops the pool.

:func:`get` keeps one pool a process: it starts one on first use, and
again when ``d`` or the device changes or a rank has died.
:func:`close` stops it; it runs at interpreter exit (``atexit``), joins
each rank for at most a few seconds and kills what is left, so exit never
waits on a rank and no rank outlives the caller.  Importing this module
starts nothing.
"""

from __future__ import annotations

import atexit
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch

from mdx_torch import telemetry
from mdx_torch.parallel.mesh import SpatialMesh, choose_backend

_READY = -1          # the call id of a rank's start-up reply


def _dumps(obj) -> bytes:
    """``obj`` pickled here, so that what cannot be pickled raises in the
    sender: a queue pickles on a feeder thread, which drops such an item
    with a printed error and leaves the receiver waiting."""
    from multiprocessing.reduction import ForkingPickler

    return bytes(ForkingPickler.dumps(obj))


def _rank_main(rank: int, d: int, device: str, backend: str,
               store_path: str, timeout_s: float, tasks, out) -> None:
    """Spawned rank ``rank`` of ``d``: start up, join the group of ranks
    1 … d − 1, reply ready, then serve tasks until None."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            from mdx_torch import kernels

            kernels.library()
        world = d - 1
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              world),
                                rank=rank - 1, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        if int(probe.item()) != world:
            raise RuntimeError(f"the group's all-reduce gave {probe.item()}"
                               f", not {world}")
        mesh = SpatialMesh(rank, d, 1, dev, backend)
        out.put((rank, _READY, True, os.getpid()))
    except BaseException:
        out.put((rank, _READY, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            call_id, fn, args, kwargs = pickle.loads(task)
            try:
                res = fn(*args, mesh=mesh, **kwargs)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                out.put((rank, call_id, True, _dumps(res)))
            except Exception:
                out.put((rank, call_id, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """A data axis of ``d`` ranks on ``device`` (a ``torch.device``; the
    calling process is rank 0 there) that serves calls (see the module
    doc).  :meth:`start` before the first :meth:`call`."""

    def __init__(self, d: int, device, timeout_s: float = 600.0):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device='cuda' but torch.cuda.is_available() is False; "
                    "pass device='cpu' to run on the CPU")
            n_cards = torch.cuda.device_count()
            first = (device.index if device.index is not None
                     else torch.cuda.current_device())
            self.devices = [f"cuda:{(first + r) % n_cards}"
                            for r in range(d)]
        elif device.type == "cpu":
            n_cards = 0
            self.devices = ["cpu"] * d
        else:
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.d, self.device, self.timeout_s = d, device, timeout_s
        self.backend = choose_backend(device.type, d, n_cards)
        self.key = (d, self.devices[0], self.backend)
        self.local = SpatialMesh(0, d, 1, torch.device(self.devices[0]),
                                 self.backend)
        self.pids: list[int] = []
        self._procs: list = []
        self._tasks: list = []
        self._out = None
        self._tmp: Path | None = None
        self._calls = 0
        self.last_ms: dict[str, float] = {}

    def start(self) -> None:
        """Start ranks 1 … d − 1 and wait until each is up."""
        import torch.multiprocessing as mp

        with telemetry.span("ranks.start", d=self.d, backend=self.backend):
            if self.device.type == "cuda":
                from mdx_torch.kernels import _build

                _build.build()
            ctx = mp.get_context("spawn")
            self._tmp = Path(tempfile.mkdtemp(prefix="mdx_torch_pool_"))
            self._out = ctx.Queue()
            self._tasks = [ctx.Queue() for _ in range(1, self.d)]
            self._procs = [ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, self.d, self.devices[r], self.backend,
                      str(self._tmp / "store"), self.timeout_s,
                      self._tasks[r - 1], self._out))
                for r in range(1, self.d)]
            telemetry.count_ranks("starts", len(self._procs))
            try:
                for p in self._procs:
                    p.start()
                pids = self._gather(_READY)
            except BaseException:
                self.close()
                raise
            self.pids = [os.getpid()] + [pids[r] for r in range(1, self.d)]

    def alive(self) -> bool:
        return len(self._procs) == self.d - 1 and all(
            p.is_alive() for p in self._procs)

    def call(self, fn, args: list, **kwargs) -> list:
        """``fn(*args[r], mesh=mesh, **kwargs)`` on every rank r, rank 0
        here while the others run → the results in rank order;
        ``last_ms`` then holds the call's ``dispatch_ms``, ``local_ms``
        (rank 0's part) and ``wait_ms`` (for the other ranks after it).
        Raises as the module doc says."""
        if len(args) != self.d:
            raise ValueError(f"{len(args)} argument tuples for {self.d} "
                             f"ranks")
        if not self.alive():
            raise RuntimeError("the rank pool is not running")
        self._calls += 1
        telemetry.count_ranks("calls")
        t0 = time.perf_counter()
        with telemetry.span("ranks.dispatch", d=self.d):
            tasks = [_dumps((self._calls, fn, tuple(a), kwargs))
                     for a in args[1:]]
            for q, task in zip(self._tasks, tasks):
                q.put(task)
        t1 = time.perf_counter()
        try:
            mine, err = fn(*args[0], mesh=self.local, **kwargs), None
        except Exception as exc:
            mine, err = None, exc
        t2 = time.perf_counter()
        with telemetry.span("ranks.wait", d=self.d):
            try:
                got = self._gather(self._calls)
            except (TimeoutError, ChildProcessError):
                self.close()
                raise
        self.last_ms = {"dispatch_ms": (t1 - t0) * 1e3,
                        "local_ms": (t2 - t1) * 1e3,
                        "wait_ms": (time.perf_counter() - t2) * 1e3}
        if err is not None:
            raise err
        return [mine] + [pickle.loads(got[r]) for r in range(1, self.d)]

    def _gather(self, call_id: int) -> dict:
        """Every spawned rank's reply to ``call_id`` → {rank: result}; the
        first rank that raised raises here once all have replied."""
        got, failed = {}, {}
        n = self.d - 1
        deadline = time.monotonic() + self.timeout_s
        while len(got) + len(failed) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(1, self.d)) - set(got)
                                 - set(failed))
                raise TimeoutError(f"ranks {missing} of {self.d} did not "
                                   f"reply within {self.timeout_s} s")
            try:
                rank, cid, ok, payload = self._out.get(timeout=min(left, 1))
            except queue_mod.Empty:
                for r, p in enumerate(self._procs, 1):
                    if r not in got and r not in failed \
                            and p.exitcode is not None:
                        raise ChildProcessError(
                            f"rank {r} of {self.d} exited with code "
                            f"{p.exitcode} without a reply") from None
                continue
            if cid != call_id:
                continue
            (got if ok else failed)[rank] = payload
        if failed:
            rank = min(failed)
            if call_id == _READY:
                raise RuntimeError(f"rank {rank} of {self.d} failed to start"
                                   f":\n{failed[rank]}")
            raise RuntimeError(f"rank {rank} of {self.d} raised:\n"
                               f"{failed[rank]}")
        return got

    def close(self) -> None:
        """Stop the ranks: each is asked to leave, joined for at most 5 s,
        then killed."""
        for q in self._tasks:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            if p.pid is None:
                continue
            p.join(timeout=max(deadline - time.monotonic(), 0.01))
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for q in self._tasks + ([self._out] if self._out else []):
            q.cancel_join_thread()
            q.close()
        self._procs, self._tasks, self._out, self.pids = [], [], None, []
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None


_POOL: RankPool | None = None


def get(d: int, device) -> RankPool:
    """This process's pool of ``d`` ranks, rank 0 on ``device``, started if
    there is none with that key or a rank of it has died."""
    global _POOL
    want = RankPool(d, device)
    if _POOL is not None:
        if _POOL.key == want.key and _POOL.alive():
            return _POOL
        close()
    want.start()
    _POOL = want
    return want


def close() -> None:
    """Stop this process's pool, if any."""
    global _POOL
    pool, _POOL = _POOL, None
    if pool is not None:
        pool.close()


atexit.register(close)
