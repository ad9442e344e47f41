"""Each op of the bench plan on the card against the same op on the CPU.

    python -m mdx_torch.tools.op_diff

Run from the root of a checkout on a machine with a CUDA card.  On
bench.py's batch at 2x512^2, the size of chip_smoke's slice check, for each
op of the bench plan's chain, in order, it prints the difference of the
card's result from the CPU's:

* ``op <name> (same input)``: both devices run the op on the CPU chain's
  input, so the line shows what the op alone adds;
* ``chain after <name>``: each device runs the chain on its own output so
  far, so the line shows what has built up.

Then TV's per-image iteration counts on both devices, and ``qa_plan``'s
enhanced pixels and guard flags.  Each line gives max|d| and how many
pixels differ by more than 1e-5, 1e-4 and 1e-3.  These readings are the
evidence behind the pixel tolerances of ``mdx_torch.parity``.
"""

from __future__ import annotations

import numpy as np
import torch

N, SIZE = 2, 512


def _diff(a: torch.Tensor, b: torch.Tensor) -> str:
    d = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
    counts = " ".join(f"n>{t:g} {int((d > t).sum())}"
                      for t in (1e-5, 1e-4, 1e-3))
    return f"max {float(d.max()):.3g} {counts}"


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("op_diff needs a CUDA card")

    from bench import _make_batch

    from mdx_torch.core import enhance as E
    from mdx_torch.core import qa
    from mdx_torch.ops import tv as T
    from mdx_torch.tools import all_ops_masks, bench_plan, card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    x_np = _make_batch(N, SIZE)
    x_cpu = torch.from_numpy(np.array(x_np))
    plans = {"cpu": bench_plan("cpu"), "card": bench_plan(dev)}
    masks = {"cpu": all_ops_masks(N, "cpu"), "card": all_ops_masks(N, dev)}
    static = plans["cpu"][0]

    def run(op, x, where):
        s, d = plans[where]
        return E._run_chain(x, (op,), s, d, masks[where], d.unsharp_amount)

    cur_cpu, cur_card = x_cpu, x_cpu.to(dev)
    for op in (o for o in E.OP_ORDER if o in static.ops):
        want = run(op, cur_cpu, "cpu")
        same = run(op, cur_cpu.to(dev), "card")
        print(f"op {op} (same input): {_diff(same, want)}")
        if op == "tv_denoise":
            w = plans["cpu"][1].tv_denoise_weight
            _, it_cpu = T.tv_chambolle(cur_cpu, w)
            _, it_card = T.tv_chambolle(cur_cpu.to(dev), w)
            print(f"  tv iterations card {it_card.tolist()} "
                  f"cpu {it_cpu.tolist()}")
        cur_card = run(op, cur_card, "card")
        cur_cpu = want
        print(f"chain after {op}: {_diff(cur_card, cur_cpu)}")

    on_card = qa.qa_plan(x_cpu.to(dev), *plans["card"])
    on_cpu = qa.qa_plan(x_cpu, *plans["cpu"])
    print(f"qa_plan enhanced: {_diff(on_card[0], on_cpu[0])}")
    print("guard flags (card, cpu): " + str({
        k: (on_card[1][k].tolist(), on_cpu[1][k].tolist())
        for k in on_cpu[1]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
