"""Exact per-image order statistics and percentiles (PyTorch).

Counterpart of ``mdx/ops/quantile.py``.  The TPU package finds order
statistics by a bitwise binary search because a sort is slow there.  On the
card the select kernel (``kernels.select_ranks``, ``csrc/select.cu``) finds
the few ranks a percentile needs by radix selection, three reads of each
row; on the CPU ``torch.sort`` and a gather (:func:`select_ranks_plain`)
give the same exact order statistics.  The interpolation plan
(:func:`_plan`) and the NumPy 'linear' blend (:func:`_interpolate`) are
ported as they are, so the results are bit-equal to the JAX package's.
For an array split over ranks (:func:`percentiles_multi_sharded`) the
binary search is the algorithm, not a workaround: it needs one small count
sum per sweep and never gathers the data.  Inputs must be NaN-free.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels, telemetry


def _plan(qs, m: int):
    """Interpolation plan for NumPy's 'linear' rule over m elements:
    deduped 1-indexed LOWER ranks + per-q (rank_idx, frac)."""
    need: dict[int, int] = {}
    plan = []
    for q in qs:
        pos = float(q) / 100.0 * (m - 1)
        k = min(int(pos), m - 1)
        frac = pos - k
        lo = k + 1
        if lo not in need:
            need[lo] = len(need)
        plan.append((need[lo], frac))
    return tuple(need), plan


def _interpolate(os_: torch.Tensor, succ: torch.Tensor, plan) -> torch.Tensor:
    out = [os_[:, i] * (1.0 - f) + succ[:, i] * f if f else os_[:, i]
           for i, f in plan]
    return torch.stack(out, 0)


def select_ranks_plain(flat: torch.Tensor, ranks) -> torch.Tensor:
    """The ``ranks``-th smallest elements (1-indexed) of each row of
    [N, M] → [N, len(ranks)]: a sort and a gather, the plain version of
    ``kernels.select_ranks``."""
    srt = torch.sort(flat, dim=-1).values
    # from pageable memory the upload waits for the device's queue
    with telemetry.count_sync("quantile.ranks"):
        idx = torch.tensor(ranks, device=flat.device) - 1      # 0-indexed
    return srt[:, idx]


def select_targets(ranks, m: int) -> tuple:
    """The order statistics the blend of ``_plan``'s lower ``ranks`` reads:
    those ranks, then each one's successor (clamped to ``m``)."""
    return ranks + tuple(min(k + 1, m) for k in ranks)


def percentiles_exact(x: torch.Tensor, qs) -> torch.Tensor:
    """Per-image percentiles (NumPy 'linear' rule) of [N, ...] → [len(qs),
    N]; on the card at most 8 distinct ranks (the select kernel's 16
    targets with their successors)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    m = flat.shape[1]
    ranks, plan = _plan(qs, m)
    targets = select_targets(ranks, m)
    if kernels.use_kernel(flat):
        stats = kernels.select_ranks(flat.contiguous(), targets)
    else:
        stats = select_ranks_plain(flat, targets)
    r = len(ranks)
    return _interpolate(stats[:, :r], stats[:, r:], plan)


def median_rows(flat: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of [N, M] → [N]."""
    return percentiles_exact(flat, [50.0])[0]


# ---------------------------------------------------------------------------
# Distributed exact order statistics (mdx/ops/quantile.py:160,210)
# ---------------------------------------------------------------------------
#
# A sort of data that lies on several ranks would have to gather it first.
# Instead, as the JAX package does, the k-th smallest element is found by a
# binary search over the float32 bit pattern: float32 → an order-preserving
# unsigned 32-bit key (held in int64), and 32 sweeps that each decide one
# bit by counting the elements below a candidate key.  The count is local
# plus one sum over the space ranks per sweep, for all sources at once.
# The greedy search returns the largest key v with count(u < v) < rank,
# which is the key of the rank-th smallest element, so the result equals
# ``percentiles_exact`` of the gathered array bit for bit.

_SIGN = 0x80000000
_MASK = 0xFFFFFFFF


def _to_ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 → int64 key in [0, 2^32), monotone in the float's order
    (non-negative: bits | sign; negative: ~bits).  NaN-free inputs."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & _MASK
    return torch.where(b & _SIGN == 0, b | _SIGN, (~b) & _MASK)


def _from_ordered(u: torch.Tensor) -> torch.Tensor:
    bits = torch.where(u & _SIGN != 0, u & (_MASK ^ _SIGN), (~u) & _MASK)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def percentiles_multi_sharded(sources, mesh) -> list[torch.Tensor]:
    """Exact global per-image percentiles of several row-sharded arrays in
    ONE search.

    ``sources``: list of ``(v, qs, total, weights)``: ``v`` this rank's
    block with leading N; ``qs`` the percentiles; ``total`` the global
    element count (of the weighted elements when ``weights`` is given);
    ``weights`` None or 0/1 broadcastable to ``v``, excluding elements from
    both the counts and the rank space.  Returns one ``[len(qs), N]`` per
    source.  One int64 ``[N, ΣR]`` count sum over ``space`` per sweep
    (32), then one sum and one min for the successors."""
    from mdx_torch.parallel import comm

    n = sources[0][0].shape[0]
    us, ws, plans, spans, all_ranks = [], [], [], [], []
    for v, qs, total, weights in sources:
        us.append(_to_ordered(v.reshape(n, -1)))
        ws.append(None if weights is None else
                  (torch.broadcast_to(weights, v.shape).reshape(n, -1) > 0))
        ranks, plan = _plan(qs, int(total))
        plans.append(plan)
        spans.append((len(all_ranks), len(ranks)))
        all_ranks.extend(ranks)
    dev = us[0].device
    r_all = torch.tensor(all_ranks, dtype=torch.int64, device=dev)[None, :]

    def per_rank(cand, op):
        """op(u, w, key [N,1]) → [N] for each source and each of its ranks
        → [N, ΣR]."""
        cols = []
        for u, w, (off, cnt) in zip(us, ws, spans):
            for j in range(off, off + cnt):
                cols.append(op(u, w, cand[:, j:j + 1]))
        return torch.stack(cols, dim=1)

    def below(u, w, key):
        m = u < key
        return (m if w is None else m & w).sum(dim=-1)

    ans = torch.zeros((n, len(all_ranks)), dtype=torch.int64, device=dev)
    for i in range(32):
        cand = ans | (1 << (31 - i))
        cnt = comm.psum(per_rank(cand, below), mesh)
        ans = torch.where(cnt < r_all, cand, ans)

    if any(f for plan in plans for _, f in plan):
        def at_most(u, w, key):
            m = u <= key
            return (m if w is None else m & w).sum(dim=-1)

        def min_above(u, w, key):
            m = u > key
            if w is not None:
                m = m & w
            return torch.where(m, u, _MASK).amin(dim=-1)

        cnt_le = comm.psum(per_rank(ans, at_most), mesh)
        above = comm.pmin(per_rank(ans, min_above), mesh)
        succ = _from_ordered(torch.where(cnt_le >= r_all + 1, ans, above))
    else:
        succ = torch.zeros(ans.shape, dtype=torch.float32, device=dev)
    af = _from_ordered(ans)
    return [_interpolate(af[:, off:off + cnt], succ[:, off:off + cnt], plan)
            for (off, cnt), plan in zip(spans, plans)]


def percentiles_exact_sharded(v: torch.Tensor, qs, mesh, total: int,
                              weights: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Exact global per-image percentiles of one row-sharded array →
    ``[len(qs), N]`` (same contract as one source of
    :func:`percentiles_multi_sharded`)."""
    return percentiles_multi_sharded([(v, qs, total, weights)], mesh)[0]
