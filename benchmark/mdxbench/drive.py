"""A cell's pool of files, its entry calls, the measured window and the
sample that is checked.

What a call is comes from the cell's entry kind, ``entries/<entry>.py``
(:func:`mdxbench.spec.entry`): the pool it writes, the targets it calls in
turn, the call itself and what it answers.  Every call writes its
artifacts and DB rows, as a user's run does.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext

import numpy as np
import torch

from mdxbench import spec


class Client:
    """The cell's calls on one device, and what each returned."""

    def __init__(self, cell, root: str, seed: int, dev):
        self.cell, self.dev, self.seed = cell, dev, seed
        self.entry = spec.entry(cell)
        self.out_dir = os.path.join(root, "out")
        self.groups = self.entry.pool(cell, os.path.join(root, "in"), seed,
                                      dev)
        self.items = [it for g in self.groups for it in g]
        self.latest: dict[str, object] = {}
        self.runs: list[dict] = []
        self.marks: list[tuple[float, float]] = []
        self.failed = 0
        self.errors: list[str] = []
        self.frames = 0

    def call(self, target: str, record: bool = True) -> None:
        """One entry call on ``target`` (a directory or a file)."""
        t0 = time.perf_counter()
        try:
            raw, frames, phase_ms = self.entry.call(self.cell, target,
                                                    self.out_dir, self.dev)
            self.latest.update(raw)
        except Exception as exc:       # counted as failed; the run goes on
            self.failed += 1
            self.errors.append(f"{target}: {type(exc).__name__}: {exc}")
            frames, phase_ms = 0, None
        t1 = time.perf_counter()
        if record:
            self.frames += frames
            self.runs.append({"target": target, "ms": (t1 - t0) * 1e3,
                              "end": t1, "frames": frames,
                              "phase_ms": phase_ms})

    def warmup(self) -> None:
        """The entry's warm-up calls, recorded nowhere."""
        for target in self.entry.warmup(self.groups):
            self.call(target, record=False)
        self.latest.clear()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, span=None) -> float:
        """Calls in turn until ``seconds`` have passed; the call in flight
        then completes.  Returns the window's length in seconds.  Marks
        (time, the process's CPU seconds) are taken at the start and as
        the first call to end in each quarter ends."""
        units = self.entry.targets(self.groups)
        t0 = time.perf_counter()
        self.marks = [(t0, time.process_time())]
        k = 0
        while True:
            with span("call") if span else nullcontext():
                self.call(units[k % len(units)])
            k += 1
            now = time.perf_counter()
            if now - t0 >= seconds * len(self.marks) / 4:
                self.marks.append((now, time.process_time()))
            if now - t0 >= seconds:
                break
        return time.perf_counter() - t0

    def sample(self) -> list[str]:
        """The files whose answers are checked, drawn from the seed among
        those the window ran, and the entry's extra files."""
        done = sorted(self.latest)
        rng = np.random.default_rng([self.seed, 1])
        n = min(int(self.cell.traffic["sample"]), len(done))
        picked = [done[i] for i in sorted(rng.choice(len(done), n,
                                                     replace=False))]
        picked += [p for p in self.entry.extra(self.runs)
                   if p not in picked and p in self.latest]
        return picked

    def answers(self, sample: list[str]) -> list[dict]:
        """The program's answers for ``sample``; forgets the rest."""
        out = [self.entry.answer(self.latest[p]) for p in sample]
        self.latest.clear()
        return out
