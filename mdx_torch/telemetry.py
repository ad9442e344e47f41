"""The port's own spans and counters, on the device trace's clock.

Nothing here imports another module of the port at import time, so
``core``, ``ops``, ``kernels`` and ``pipeline`` all may use it.

* :func:`span` — ``with span("stage", frames=64): ...``.  Tracing is off
  by default: then ``span`` tests one module flag and returns one shared
  no-op context manager (no allocation, no clock read).  While it is on,
  each span appends ``(name, t0_ns, t1_ns, thread id, attrs)`` to one
  in-memory buffer, stamped with ``time.perf_counter_ns``.
* :func:`count_sync` — ``with count_sync("enhance.halo_guard"): ...``
  around a read that blocks the host on the device.  The count per site is
  always kept, under a lock, as ``kernels.LAUNCHES`` is, so it stays exact
  when the server's threads run passes; while tracing is on the read is
  also a ``sync`` span with the site as its attribute.
* :func:`count_staged` — frames the batch runner put in their chunk's
  upload buffer: ``"in_place"`` read there straight from the file,
  ``"copied"`` decoded first and copied there.  Always kept, as the syncs.
* :func:`count_ranks` — the rank pool's ``"starts"`` (rank processes
  started) and ``"calls"`` (calls served).  Always kept, as the syncs.
* :func:`merge` — spans another process of this host recorded (a rank of
  the pool), tagged with its rank, into this buffer while tracing is on:
  ``perf_counter_ns`` is ``CLOCK_MONOTONIC`` on Linux, one clock for every
  process, so this process's anchor places them too.
* :func:`enable` / :func:`disable` nest: tracing is on while more
  enables than disables were made.  The first enable clears the buffer and
  takes the anchor, ``(perf_counter_ns, time_ns)`` read back to back;
  ``epoch_ns = t - anchor[0] + anchor[1]`` puts a span on the Unix-epoch
  timeline on which ``torch.profiler`` stamps its events.
* :func:`reset` clears the buffer, the sync, staging and rank counts and
  rebases the launch counts; :func:`mark` and :func:`snapshot` read what was
  recorded (since a mark): the spans, the anchor, a second anchor taken at
  the snapshot (the two clocks' drift), the sync, staging and rank counts and
  the kernel launches (``kernels.LAUNCHES``, which stays where it is).
* :func:`chrome_trace` — a snapshot as a Chrome-trace object: ``"X"``
  events whose ``ts`` are microseconds of the Unix epoch
  (``baseTimeNanoseconds`` 0), so they lay over a ``torch.profiler`` trace
  shifted by that trace's ``baseTimeNanoseconds``.
"""

from __future__ import annotations

import os
import threading
import time

SYNCS: dict[str, int] = {}
STAGED: dict[str, int] = {}
RANKS: dict[str, int] = {}

_on = False
_depth = 0
_anchor = (0, 0)
_spans: list[tuple] = []
_launch_base: dict[str, int] = {}
_lock = threading.Lock()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # list.append is atomic under the interpreter lock
        _spans.append((self.name, self.t0, time.perf_counter_ns(),
                       threading.get_ident(), self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` while tracing is on."""
    if not _on:
        return _NO_SPAN
    return _Span(name, attrs)


def count_sync(site: str, n: int = 1):
    """Count ``n`` host-blocking device reads at ``site``; while tracing
    is on, the returned context manager records them as a ``sync`` span."""
    with _lock:
        SYNCS[site] = SYNCS.get(site, 0) + n
    if not _on:
        return _NO_SPAN
    return _Span("sync", {"site": site})


def count_staged(how: str, n: int = 1) -> None:
    """Count ``n`` frames staged for upload ``how``: ``"in_place"`` or
    ``"copied"``."""
    with _lock:
        STAGED[how] = STAGED.get(how, 0) + n


def count_ranks(what: str, n: int = 1) -> None:
    """Count ``n`` rank-pool events ``what``: ``"starts"`` or ``"calls"``."""
    with _lock:
        RANKS[what] = RANKS.get(what, 0) + n


def merge(spans: list, **attrs) -> None:
    """Append ``spans`` (another process's :func:`snapshot` ``"spans"`` on
    this host) with ``attrs`` added to each span's own, while tracing is
    on."""
    if _on:
        _spans.extend((name, t0, t1, tid, {**a, **attrs})
                      for name, t0, t1, tid, a in spans)


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on, _depth, _anchor
    with _lock:
        if _depth == 0:
            _spans.clear()
            _anchor = _clocks()
            _on = True
        _depth += 1


def disable() -> None:
    global _on, _depth
    with _lock:
        _depth = max(_depth - 1, 0)
        _on = _depth > 0


def reset() -> None:
    """Clear the buffer, the sync, staging and rank counts; launches count
    from here."""
    global _launch_base
    with _lock:
        _spans.clear()
        SYNCS.clear()
        STAGED.clear()
        RANKS.clear()
        _launch_base = _launches()


def _clocks() -> tuple[int, int]:
    return time.perf_counter_ns(), time.time_ns()


def _launches() -> dict[str, int]:
    from mdx_torch import kernels

    return dict(kernels.LAUNCHES)


def mark() -> tuple:
    """Where the buffer and the counters stand, for :func:`snapshot`."""
    with _lock:
        return (len(_spans), dict(SYNCS), dict(STAGED), _launches(),
                dict(RANKS))


def snapshot(since: tuple | None = None) -> dict:
    """The spans, anchors and counts recorded since ``since`` (a
    :func:`mark`; None: since the last :func:`reset`)."""
    with _lock:
        n0, syncs0, staged0, launches0, ranks0 = since or (
            0, {}, {}, _launch_base, {})
        spans = _spans[n0:]

        def diff(now, then):
            return {k: v - then.get(k, 0) for k, v in now.items()
                    if v != then.get(k, 0)}

        syncs, staged, ranks = (diff(SYNCS, syncs0), diff(STAGED, staged0),
                                diff(RANKS, ranks0))
        launches = {k: v - launches0.get(k, 0)
                    for k, v in _launches().items()}
        return {"anchor": _anchor, "end": _clocks(),
                "main_thread": threading.main_thread().ident,
                "spans": spans, "syncs": syncs, "staged": staged,
                "ranks": ranks, "launches": launches}


def to_epoch_ns(snap: dict, t_ns: int) -> int:
    """A ``perf_counter_ns`` stamp of ``snap`` on the Unix-epoch clock."""
    return t_ns - snap["anchor"][0] + snap["anchor"][1]


def chrome_trace(snap: dict) -> dict:
    """``snap`` as a Chrome-trace object (``"X"`` events on the epoch
    clock; the counts under ``otherData``)."""
    pid = os.getpid()
    events = [{"name": name, "ph": "X", "cat": "mdx",
               "pid": attrs.get("pid", pid), "tid": tid,
               "ts": to_epoch_ns(snap, t0) / 1e3, "dur": (t1 - t0) / 1e3,
               "args": attrs}
              for name, t0, t1, tid, attrs in snap["spans"]]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": 0,
            "otherData": {"syncs": snap["syncs"],
                          "staged": snap["staged"],
                          "ranks": snap["ranks"],
                          "launches": snap["launches"],
                          "anchor_ns": list(snap["anchor"]),
                          "end_ns": list(snap["end"])}}
