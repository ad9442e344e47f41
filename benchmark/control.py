"""Readings that the limits of ``mdxbench.check`` are set from, on the card.

    python benchmark/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out FILE] [--gaps FILE]

from the root of a checkout.  For each of ``--seeds`` it writes the cell's
pool from that seed, makes one pass of the cell's own entry calls over the
pool (the load of a run, without a timed window), draws the sample as a run
does and compares the program's answers with the float32 reference: the
lower readings.  For each of ``--control-seeds`` it compares the reference
computed in bfloat16, the precision below the configuration's float32, put
in the program's place: the upper readings.  One JSON line per seed, then
the widest program reading and the narrowest control reading of each
number; ``--gaps`` keeps every compared frame's gap by field, from which
the fields' own limits are set.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the harness's own packages, then the program at the checkout's root
sys.path[:0] = [str(HERE), str(Path.cwd())]


def readings(cell, seed: int, root: str, dev, control: bool,
             rows: list | None = None) -> dict:
    """The check's readings on one seed; each compared frame's gaps by
    field are appended to ``rows`` if given."""
    import torch

    from mdxbench import check, drive

    client = drive.Client(cell, root, seed, dev)
    if control:
        client.latest = {it.path: None for it in client.items}
    else:
        for unit in client.entry.targets(client.groups):
            client.call(unit)
    sample = client.sample()
    ref = client.entry.reference(cell, sample, dev)
    if control:
        low = client.entry.reference(cell, sample, dev, torch.bfloat16)
        prog = [check.as_program(a) for a in low]
    else:
        prog = client.answers(sample)
    out, left_out, worst = check.compare(prog, ref, rows)
    out.update(left_out=left_out, failed=client.failed, n=len(sample),
               worst=worst)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--gaps", type=Path,
                    help="append each compared frame's gaps by field")
    args = ap.parse_args(argv)

    import torch

    from mdxbench import spec

    if not torch.cuda.is_available():
        raise SystemExit("control.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    cell = spec.load(Path.cwd() / "BENCHMARK.json", args.workload)
    base = os.environ.get("TMPDIR") or str(Path.cwd() / "build")
    root = os.path.join(base, "mdxbench_control", args.workload)
    os.environ["MDX_DB_PATH"] = os.path.join(root, "runs.db")
    rows = []
    for kind, seeds in (("program", args.seeds), ("control",
                                                   args.control_seeds)):
        for s in [int(v) for v in seeds.split(",") if v]:
            shutil.rmtree(root, ignore_errors=True)
            os.makedirs(root)
            t0 = time.perf_counter()
            gaps = []
            r = readings(cell, s, root, dev, kind == "control", gaps)
            r.update(kind=kind, seed=s, s=time.perf_counter() - t0)
            rows.append(r)
            print(json.dumps(r), flush=True)
            if args.gaps:
                with open(args.gaps, "a") as f:
                    f.write(json.dumps({"workload": args.workload,
                                        "kind": kind, "seed": s,
                                        "gaps": gaps}) + "\n")
    shutil.rmtree(root, ignore_errors=True)
    summary = {}
    for key in ("gap", "frames_off", "pixel", "plan", "mismatch"):
        p = [r[key] for r in rows if r["kind"] == "program" and key in r]
        c = [r[key] for r in rows if r["kind"] == "control" and key in r]
        summary[key] = {"program_max": max(p) if p else None,
                        "control_min": min(c) if c else None}
    line = json.dumps({"workload": args.workload, "summary": summary,
                       "card": torch.cuda.get_device_name(dev)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n" + line
                    + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
