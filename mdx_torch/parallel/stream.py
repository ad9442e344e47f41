"""Host→device streaming: decode ahead of the card for batch QA — the
port's copy of ``mdx/parallel/stream.py``.

Host decode and normalisation run on a pool of threads that stays up to
``prefetch`` batches ahead of the consumer (:class:`DecodeStream`, JAX's
semantics: batches in submission order, a decode error raised at the batch
boundary, decoded frames bounded by ``(prefetch + 1)·batch_size``, every
worker retired at the end, on an error or on ``close()``).

:func:`stream_batches` puts each batch on the card from a ring of pinned
host buffers on a copy stream of its own: the producer thread fills a
buffer (once that buffer's last copy has completed), queues the copy and
records an event behind it; the consumer's stream waits on the event
before the batch is handed out.  So batch t + 1 decodes and uploads while
the card computes batch t.  A batch is allocated on the copy stream and
used on the consumer's, so it is recorded on the consumer's stream
(``record_stream``) before the caching allocator may reuse it.

With ``mesh`` (a rank's ``SpatialMesh`` on the data axis) each batch is
padded to a multiple of ``n_data`` as JAX pads it (``stream.py:193-203``,
padding lanes copies of the batch's last frame), and the rank decodes and
yields only its own block of it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from mdx_torch.parallel.mesh import divisible_batch


class DecodeStream:
    """Iterator of ``(start_index, [B, H, W] batch)``, decoded ahead of use.

    ``items`` are opaque work units; ``decode_fn(item) -> np.ndarray [H,W]``
    runs on host threads.  Batches are formed in submission order so
    results stay aligned with ``items``; ``device_put`` (if given) maps each
    stacked batch on the producer thread.
    """

    def __init__(
        self,
        items: Sequence,
        decode_fn: Callable[[object], np.ndarray],
        batch_size: int,
        *,
        prefetch: int = 2,
        workers: int = 4,
        device_put: Callable[[np.ndarray], object] | None = None,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self._items = list(items)
        self._decode = decode_fn
        self._bs = batch_size
        self._prefetch = max(prefetch, 1)
        self._workers = max(workers, 1)
        self._device_put = device_put
        self._out: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._ready = threading.Condition(threading.Lock())
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- producer side ----------------------------------------------------

    def _producer(self) -> None:
        ready = self._ready
        try:
            slots: dict[int, np.ndarray | Exception] = {}
            next_idx = 0
            # decode-ahead window: frames beyond `watermark` wait, so host
            # memory holds at most (prefetch + 1) batches of decoded frames
            window = (self._prefetch + 1) * self._bs
            state = {"watermark": window}
            work: "queue.Queue" = queue.Queue()
            for i, item in enumerate(self._items):
                work.put((i, item))

            def worker():
                while not self._stop.is_set():
                    try:
                        i, item = work.get_nowait()
                    except queue.Empty:
                        return
                    with ready:
                        ready.wait_for(
                            lambda: i < state["watermark"]
                            or self._stop.is_set())
                    if self._stop.is_set():
                        return
                    try:
                        arr = np.asarray(self._decode(item), np.float32)
                    except Exception as exc:  # surfaced at batch boundary
                        arr = exc
                    with ready:
                        slots[i] = arr
                        ready.notify_all()

            for _ in range(self._workers):
                threading.Thread(target=worker, daemon=True).start()

            n = len(self._items)
            while next_idx < n and not self._stop.is_set():
                hi = min(next_idx + self._bs, n)
                with ready:
                    ready.wait_for(lambda: all(
                        i in slots for i in range(next_idx, hi))
                        or self._stop.is_set())
                    if self._stop.is_set():
                        return
                    chunk = [slots.pop(i) for i in range(next_idx, hi)]
                    state["watermark"] = hi + window
                    ready.notify_all()
                errs = [c for c in chunk if isinstance(c, Exception)]
                if errs:
                    self._emit(errs[0])
                    return
                batch = np.stack(chunk)
                if self._device_put is not None:
                    batch = self._device_put(batch)
                if not self._emit((next_idx, batch)):
                    return
                next_idx = hi
            self._emit(None)
        except Exception as exc:  # a failed put: raised to the consumer
            self._emit(exc)
        finally:
            # retire the worker pool whatever happened (decode error,
            # consumer close, normal completion)
            self._stop.set()
            with ready:
                ready.notify_all()

    def _emit(self, obj) -> bool:
        """Bounded put that gives up instead of blocking forever once the
        consumer closed the stream."""
        while not self._stop.is_set():
            try:
                self._out.put(obj, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side ----------------------------------------------------

    def __iter__(self) -> Iterator:
        while True:
            got = self._out.get()
            if got is None:
                return
            if isinstance(got, Exception):
                raise got
            yield got

    def join(self, timeout: float = 5.0) -> None:
        """Wait for the producer thread to retire (mainly for tests)."""
        self._thread.join(timeout)

    def close(self) -> None:
        self._stop.set()
        with self._ready:
            self._ready.notify_all()


class _Uploader:
    """Stacked float32 batches → the card through a ring of pinned host
    buffers on a copy stream of its own (module doc).  :meth:`put` runs on
    the producer thread, :meth:`take` on the consumer's."""

    SLOTS = 2

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.copy = torch.cuda.Stream(dev)
        # per slot: (pinned buffer, event behind its last copy)
        self.ring: list[tuple[torch.Tensor, torch.cuda.Event] | None] = [
            None] * self.SLOTS
        self.turn = 0

    def put(self, batch: np.ndarray):
        slot = self.ring[self.turn]
        if slot is not None:
            slot[1].synchronize()  # the copy that read the buffer is done
        buf = slot[0] if slot is not None else None
        if (buf is None or buf.shape[0] < batch.shape[0]
                or tuple(buf.shape[1:]) != batch.shape[1:]):
            buf = torch.empty(batch.shape, dtype=torch.float32,
                              pin_memory=True)
        host = buf[:batch.shape[0]]
        host.numpy()[...] = batch
        with torch.cuda.stream(self.copy):
            out = torch.empty(host.shape, dtype=host.dtype, device=self.dev)
            out.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy)
        self.ring[self.turn] = (buf, done)
        self.turn = (self.turn + 1) % self.SLOTS
        return out, done

    def take(self, item) -> torch.Tensor:
        out, done = item
        stream = torch.cuda.current_stream(self.dev)
        stream.wait_event(done)
        out.record_stream(stream)
        return out


class _BatchStream(DecodeStream):
    """A :class:`DecodeStream` over one rank's lanes (``per`` a full
    batch) whose batches ``take`` hands to the consumer, with the start
    index of the whole batch they belong to."""

    def __init__(self, items, decode_fn, per: int, batch_size: int, take,
                 **kw):
        super().__init__(items, decode_fn, per, **kw)
        self._whole, self._take = batch_size, take

    def __iter__(self) -> Iterator:
        for start, batch in super().__iter__():
            yield start // self._bs * self._whole, self._take(batch)


def stream_batches(
    paths: Iterable[str],
    batch_size: int = 8,
    *,
    mesh=None,
    device="cuda",
    prefetch: int = 2,
    workers: int = 4,
) -> DecodeStream:
    """Decode DICOM files ahead of the card: yields ``(start_index, [B, H,
    W] float32 tensor)`` on ``device`` (with ``mesh``: the rank's device,
    and only the rank's block of each padded batch; module doc).  Shapes
    must be homogeneous — bucket first (``pipeline/batch_runner.py``).  The
    consumer recovers a batch's valid count as ``min(batch_size,
    len(paths) - start)``."""
    from mdx_torch.io import load_dicom, normalize_image
    from mdx_torch.pipeline.runner import resolve_device

    def decode(path: str) -> np.ndarray:
        img, _meta = load_dicom(path)
        return normalize_image(img)

    paths = list(paths)
    if mesh is None:
        dev, items, per = resolve_device(device), paths, batch_size
    else:
        if mesh.n_space != 1:
            raise ValueError(f"stream_batches splits batches on the data "
                             f"axis only; this mesh has {mesh.n_space} "
                             f"space ranks")
        d, r = mesh.n_data, mesh.data_index
        dev, items = mesh.device, []
        for s in range(0, len(paths), batch_size):
            n = min(batch_size, len(paths) - s)
            nd = divisible_batch(n, d) // d
            # the padded batch's lanes r·nd … (r + 1)·nd − 1, each past the
            # batch's last frame a copy of it
            items += [paths[s + min(r * nd + j, n - 1)] for j in range(nd)]
        per = divisible_batch(batch_size, d) // d
    if dev.type == "cuda":
        up = _Uploader(dev)
        put, take = up.put, up.take
    else:
        put, take = torch.from_numpy, (lambda t: t)
    return _BatchStream(items, decode, per, batch_size, take,
                        prefetch=prefetch, workers=workers, device_put=put)
