"""Spans, kernel bounds and the profiler trace of a ``--trace 1`` run.

Only a traced run wraps anything: :class:`Recorder` replaces module
attributes of the program (entry points and their stages, and the
``mdx_torch.kernels`` wrappers) with wrappers that open a
``torch.profiler.record_function`` span named ``bench.<name>``, time the
call on the host clock, and for the kernel wrappers add the call's bound
(:mod:`mdxbench.roofline`).  :func:`reduce` turns the profiler's events
into the trace's part of a :class:`Reading`.

The idle-share arithmetic is a frozen copy of
``mdx_torch/tools/profile_pass.py`` ``traced_pass`` at commit 3b08b1a (busy
time = the union of the device intervals), and hand kernels are named as
its ``_our_kernels`` finds them: the ``__global__`` functions of the
program's ``csrc/*.cu``.
"""

from __future__ import annotations

import importlib
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from mdxbench import roofline

PREFIX = "bench."


class Recorder:
    """Wrappers installed for one traced window, and what they saw."""

    def __init__(self):
        self.span_ms: dict[str, list[float]] = {}
        self.bound_ms = 0.0
        self.kernel_calls: dict[str, int] = {}
        self._undo: list = []

    def span(self, module: str, attr: str, name: str, sync: bool = False):
        """Wrap ``module.attr`` (a function or a class's method, as
        ``Class.method``) in the span ``name``; ``sync``: close it after a
        device synchronise."""
        mod = importlib.import_module(module)
        owner, key = mod, attr
        if "." in attr:
            cls, key = attr.split(".")
            owner = getattr(mod, cls)
        orig = getattr(owner, key)
        times = self.span_ms.setdefault(name, [])

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + name):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(owner, key, wrapped)
        self._undo.append((owner, key, orig))

    def kernels(self):
        """Add each hand-kernel call's bound to ``bound_ms``."""
        mod = importlib.import_module("mdx_torch.kernels")
        for name in roofline.KERNELS:
            orig = getattr(mod, name)

            def wrapped(*args, _orig=orig, _name=name, **kwargs):
                out = _orig(*args, **kwargs)
                self.bound_ms += roofline.bound_ms(torch, _name, args, out)
                self.kernel_calls[_name] = self.kernel_calls.get(_name, 0) + 1
                return out

            setattr(mod, name, wrapped)
            self._undo.append((mod, name, orig))

    def restore(self):
        for owner, key, orig in reversed(self._undo):
            setattr(owner, key, orig)
        self._undo.clear()


def hand_kernel_names(csrc: Path) -> set[str]:
    """Names of the ``__global__`` functions in ``csrc/*.cu``."""
    pattern = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
               r"(\w+)\s*\(")
    names = set()
    for src in Path(csrc).glob("*.cu"):
        names |= set(re.findall(pattern, src.read_text()))
    return names


@dataclass
class Reading:
    """What the metric readers read: the window on the host clock, and in
    a traced run the trace.  Times in seconds unless named."""
    setup_s: float = 0.0
    host_window_s: float = 0.0
    peak_bytes: int = 0
    frames: int = 0
    runs: list = field(default_factory=list)        # per entry call
    window_s: float = 0.0                           # the traced window
    busy_s: float = 0.0
    span_ms: dict = field(default_factory=dict)     # host ms per span
    kernel_s: dict = field(default_factory=dict)    # name -> device s
    hand: set = field(default_factory=set)          # hand kernel names
    bound_ms: float = 0.0
    kernel_calls: dict = field(default_factory=dict)
    idle_by_span: dict = field(default_factory=dict)
    kinds: dict = field(default_factory=dict)       # device events by kind

    def is_hand(self, name: str) -> bool:
        return any(f"{k}(" in name or f"{k}<" in name for k in self.hand)


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                               * 1000)


def _kind(e, name: str) -> str:
    """The device event's kind: the profiler's where it says, else from
    the name (copies and memsets are named so; the rest are kernels)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _union(intervals):
    """Merged [start, end] intervals of a sorted list."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof, rec: Recorder, hand: set, t: Reading) -> None:
    """The profiler's events of the traced window, into ``t``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, spans, win = [], [], None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            kind = _kind(e, name)
            # the spans' own ranges on the device are no device work
            if "annotation" in kind or name.startswith(PREFIX):
                continue
            t.kinds[kind] = t.kinds.get(kind, 0) + 1
            s = _ns(e, "start")
            dev.append((s, s + _ns(e, "duration"), name, kind))
        else:
            name = e.name()
            if name.startswith(PREFIX):
                s = _ns(e, "start")
                item = (s, s + _ns(e, "duration"), name[len(PREFIX):])
                if item[2] == "window":
                    win = item
                else:
                    spans.append(item)
    if win is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0], win[1]
    t.window_s = (w1 - w0) / 1e9
    t.span_ms, t.hand, t.bound_ms = rec.span_ms, hand, rec.bound_ms
    t.kernel_calls = dict(rec.kernel_calls)
    inside = sorted((max(s, w0), min(e, w1), n, k) for s, e, n, k in dev
                    if e > w0 and s < w1)
    for s, e, n, k in inside:
        if k == "kernel":
            t.kernel_s[n] = t.kernel_s.get(n, 0.0) + (e - s) / 1e9
    busy = _union([(s, e) for s, e, _, _ in inside])
    t.busy_s = sum(e - s for s, e in busy) / 1e9
    t.idle_by_span = _idle_by_span(busy, spans, w0, w1)


def _idle_by_span(busy, spans, w0: int, w1: int) -> dict[str, float]:
    """Idle seconds of the window, each gap given to the innermost span
    open at its middle ("outside" where none is)."""
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    # the spans nest (one thread opens them all), so a stack in start
    # order holds the open ones, the innermost on top
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: dict[str, float] = {}
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "outside"
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out


def breakdown(t: Reading) -> dict:
    top = sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(t.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
