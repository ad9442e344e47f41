"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  It needs as
many CUDA cards as the cell asks for, and the program (``mdx_torch``); it
exits with another code than 0 and prints no result without them, or if
JAX or the JAX package is loaded.  Set-up (imports, CUDA context, the
kernel library, the inputs from the seed, one warm-up call) is timed as
``setup_s``; then the window runs for ``--seconds``.  ``--trace 1`` runs
the window under ``torch.profiler`` and reports the per-layer metrics
instead of the end-to-end ones.  Afterwards a sample of the window's
answers is checked against the plain reference (``mdxbench.check``).  The
last line of standard output is the result, a JSON object.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the harness's own packages, then the program at the checkout's root
sys.path[:0] = [str(HERE), str(Path.cwd())]


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from mdxbench import guard, spec

    spec_path = Path.cwd() / "BENCHMARK.json"
    if not spec_path.is_file():
        _fail(f"no BENCHMARK.json in {Path.cwd()}")
    cell = spec.load(spec_path, args.workload)
    found = guard.loaded()
    if found:
        _fail(f"forbidden modules loaded at start: {found}")

    import torch

    marks = [("torch", time.perf_counter())]
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the benchmark needs a "
              "CUDA card")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    marks.append(("CUDA", time.perf_counter()))

    # the run's inputs, outputs and DB: under TMPDIR, else in the checkout
    base = os.environ.get("TMPDIR") or str(Path.cwd() / "build")
    root = os.path.join(base, "mdxbench", args.workload)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["MDX_DB_PATH"] = os.path.join(root, "runs.db")
    try:
        from mdxbench.cell import run

        result, notes = run(cell, args.seed, args.seconds, bool(args.trace),
                            dev, root, _T0, marks)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if result is None:
        _fail(notes[-1])
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
