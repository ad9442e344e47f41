"""The schedule of the select kernel (``csrc/select.cu``), modelled in
PyTorch on the CPU and held bit for bit to the sort route of
``percentiles_exact``.

The CUDA kernel runs only on the card.  This file holds its design: each
element's order-preserving key (−0.0 takes +0.0's), three passes that
decide its digits of 11, 11 and 10 bits, each pass's per-block histograms
of the digit over the elements whose key above the digit equals one of the
row's slots, added into the row's histogram, and the row's last block's
scan: a target of rank r within its prefix takes the digit where the count
up to it first reaches r, and r less the count below as its rank within
the longer prefix; targets of equal prefixes share one slot of the next
pass, in target order.  After the third pass the key is whole and its
float is the order statistic.  The model's order statistics equal
``torch.sort``'s, and ``percentiles_exact`` through the model equals its
sort route, bit for bit, on ties, all-equal rows, rows of one and two
elements, ranks at 1 and M, targets that share their first two digits,
denormals, negatives, ±0.0 (compared with ==), clipped rows and the
metric pass's own percentiles.  The wrapper's host side (launches,
arguments, workspace, no sync) is checked against a recording library;
the card tests (tests/test_torch_cuda.py) hold the kernel to
``torch.sort``.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mdx_torch import kernels, telemetry
from mdx_torch.ops import quantile as Q

torch.set_num_threads(1)

SRC = Path(kernels.__file__).resolve().parent.parent / "csrc" / "select.cu"
DIGITS = ((11, 21), (11, 10), (10, 0))      # (bits, shift) of passes 0-2
SIGN, MINUS_ZERO_KEY = 0x80000000, 0x7FFFFFFF
METRIC_QS = ([5.0, 25.0, 75.0, 95.0], [90.0], [50.0])
MAX_T = 16                                  # targets a call
STATE_INTS = 65                             # int32 words of a RowState


def workspace_ints(n, t):
    """The workspace of ``mdx_select_workspace_ints``: the passes' row
    histograms [n, 2048], [n, t, 2048], [n, t, 1024] and the tickets
    [3, n], then the row states [n, 65]; -1 outside the kernel's shapes."""
    if not (1 <= t <= MAX_T and 1 <= n <= 65535):
        return -1
    return n * (2048 + 2048 * t + 1024 * t + 3) + STATE_INTS * n


def key_of(flat):
    """``key_of``: the order-preserving key (int64), −0.0 as +0.0."""
    k = Q._to_ordered(flat)
    return torch.where(k == MINUS_ZERO_KEY, SIGN, k)


def chunks(m, bpr):
    """The blocks' ranges of a row of m elements at ``bpr`` blocks a row
    (``launch_pass``: the chunk rounded up to a multiple of 4)."""
    chunk = -(-m // bpr)
    chunk = -(-chunk // 4) * 4
    return [(lo, min(m, lo + chunk)) for lo in range(0, m, chunk)]


def schedule(flat, targets, bpr=3):
    """The kernel's three passes over [N, M] for 1-indexed ``targets`` →
    ([N, T] float32, the slots of passes 1 and 2 per row)."""
    n, m = flat.shape
    t = len(targets)
    keys = key_of(flat)
    out = torch.empty((n, t), dtype=torch.float32)
    slot_counts = []
    for row in range(n):
        k = keys[row]
        prefix, rem, slot, sp = [0] * t, list(targets), [0] * t, [None]
        counts = []
        for p, (bits, shift) in enumerate(DIGITS):
            nb = 1 << bits
            digit = (k >> shift) & (nb - 1)
            if p == 0:
                bins = digit
            else:
                pre = k >> (shift + bits)
                bins = torch.full_like(k, -1)
                for s, q in enumerate(sp):
                    bins = torch.where(pre == q, s * nb + digit, bins)
            # each block's histogram, added into the row's
            hist = torch.zeros(len(sp) * nb, dtype=torch.int64)
            for lo, hi in chunks(m, bpr):
                b = bins[lo:hi]
                hist += torch.bincount(b[b >= 0], minlength=len(sp) * nb)
            # the row's last block: each target's digit in its slot
            for i in range(t):
                h = hist[slot[i] * nb:(slot[i] + 1) * nb]
                cum = torch.cumsum(h, 0)
                d = int(torch.searchsorted(cum, rem[i]))
                prefix[i] = (prefix[i] << bits) | d
                rem[i] -= int(cum[d] - h[d])
            sp = list(dict.fromkeys(prefix))
            slot = [sp.index(q) for q in prefix]
            counts.append(len(sp))
        out[row] = Q._from_ordered(torch.tensor(prefix, dtype=torch.int64))
        slot_counts.append(counts[:2])
    return out, slot_counts


def sort_stats(flat, targets):
    return torch.sort(flat, dim=-1).values[:, [k - 1 for k in targets]]


def targets_of(qs, m):
    ranks, _ = Q._plan(qs, m)
    return ranks + tuple(min(k + 1, m) for k in ranks)


def _image_rows(seed, n, m):
    """Rows of a smooth scene plus noise, clipped to [0, 1] (a share of
    the pixels at 0 and at 1) and quantised to 12 bits, as the metric pass
    sees a normalised radiograph."""
    rng = np.random.default_rng(seed)
    base = 0.5 + 0.45 * np.sin(np.arange(m) / 97.0)[None]
    x = np.clip(base + rng.normal(0, 0.15, (n, m)), 0.0, 1.0)
    return torch.from_numpy((np.round(x * 4095) / 4095).astype(np.float32))


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "ties":
        return torch.from_numpy(rng.integers(0, 5, (3, 1001))
                                .astype(np.float32) / 4)
    if name == "all_equal":
        return torch.full((2, 777), 0.3125)
    if name == "one":
        return torch.tensor([[0.7], [-2.0]])
    if name == "two":
        return torch.tensor([[0.9, 0.1], [3.0, 3.0], [-1.0, 1e-30]])
    if name == "shared_prefix":
        # keys within one 1024-aligned run: the first two digits equal, the
        # third decides every target
        bits = 0x3F800000 + rng.integers(0, 1024, (2, 4099))
        return torch.from_numpy(bits.astype(np.int32)).view(torch.float32)
    if name == "denormal":
        bits = rng.integers(1, 0x007FFFFF, (2, 2048)).astype(np.int32)
        sign = rng.random((2, 2048)) < 0.5
        bits = np.where(sign, bits | np.int32(-2 ** 31), bits)
        return torch.from_numpy(bits.astype(np.int32)).view(torch.float32)
    if name == "negative":
        return torch.from_numpy(rng.normal(-3, 10, (3, 5003))
                                .astype(np.float32))
    if name == "clipped":
        x = _image_rows(3, 2, 65536)
        x[0, :40000] = 0.0
        x[1, 1000:60000] = 1.0
        return x
    raise KeyError(name)


CASES = ("ties", "all_equal", "one", "two", "shared_prefix", "denormal",
         "negative", "clipped")


def _all_ranks(m):
    ranks = sorted({1, m, (m + 1) // 2, max(1, m // 10), max(1, m - m // 7)})
    return tuple(ranks)


@pytest.mark.parametrize("bpr", [1, 3, 7])
@pytest.mark.parametrize("name", CASES)
def test_schedule_equals_sort(name, bpr):
    x = _case(name)
    targets = _all_ranks(x.shape[1])
    got, _ = schedule(x, targets, bpr)
    assert torch.equal(got, sort_stats(x, targets))


def test_signed_zeros_compare_equal():
    """Rows mixing ±0.0: the kernel's key gives −0.0 +0.0's, so a zero may
    come back as the other zero; equal as numbers."""
    x = torch.tensor([[-0.0, 0.0, -0.0, 1.0, -1.0, 0.0, -0.0],
                      [0.0, -0.0, 0.0, 0.0, -0.0, -0.0, 2.0]])
    targets = tuple(range(1, 8))
    got, _ = schedule(x, targets)
    want = sort_stats(x, targets)
    assert bool((got == want).all())
    assert not bool(torch.signbit(got[got == 0]).any())


def test_shared_prefix_decided_by_third_pass():
    """Targets whose keys share the first two digits keep one slot through
    passes 1 and 2, and only the third digit tells them apart."""
    x = _case("shared_prefix")
    targets = (1, 2, 2049, 4099)
    got, slots = schedule(x, targets)
    assert slots == [[1, 1], [1, 1]]
    assert torch.equal(got, sort_stats(x, targets))
    assert len(set(got[0].tolist())) > 1


@pytest.mark.parametrize("qs", METRIC_QS)
@pytest.mark.parametrize("m", [262144 // 8, 16385, 4099])
def test_metric_percentiles_through_the_schedule(qs, m, monkeypatch):
    """``percentiles_exact`` with the kernel route taken (the model in the
    wrapper's place) equals its sort route bit for bit, on the metric
    pass's percentiles, g90 and the median, and the kernel route makes no
    host sync."""
    x = _image_rows(m, 2, m)
    want = Q.percentiles_exact(x, qs)
    calls = []

    def model(flat, targets):
        calls.append(tuple(targets))
        return schedule(flat, targets, bpr=5)[0]

    monkeypatch.setattr(kernels, "use_kernel", lambda t: True)
    monkeypatch.setattr(kernels, "select_ranks", model)
    before = dict(telemetry.SYNCS)
    got = Q.percentiles_exact(x, qs)
    assert dict(telemetry.SYNCS) == before
    assert calls == [targets_of(qs, m)]
    assert torch.equal(got, want)
    if qs == [50.0]:
        assert torch.equal(Q.median_rows(x), want[0])


def test_successor_clamped_at_the_last_rank():
    """q = 100 asks for rank M, whose successor is clamped to M."""
    assert targets_of([100.0], 5) == (5, 5)
    x = torch.tensor([[0.5, 0.25, 1.0, 0.75, 0.0]])
    got, _ = schedule(x, (5, 5))
    assert got.tolist() == [[1.0, 1.0]]


def test_model_follows_the_source():
    """The digits, the largest target count and the workspace the model and
    the recording library assume are the source's."""
    src = SRC.read_text()
    digits = re.findall(r"Digit<(\d)> \{ static constexpr int BITS = (\d+), "
                        r"SHIFT = (\d+); \}", src)
    assert [(int(b), int(s)) for _, b, s in digits] == list(DIGITS)
    assert sum(b for b, _ in DIGITS) == 32
    assert f"MAX_T = {MAX_T};" in src
    fields = re.search(r"struct RowState \{(.*?)\};", src, re.S).group(1)
    assert [ln.split()[-1] for ln in re.findall(r"^\s*(\w+ \w+(?:\[MAX_T\])?);",
                                                fields, re.M)] == [
        "prefix[MAX_T]", "rem[MAX_T]", "slot[MAX_T]", "slot_prefix[MAX_T]",
        "nslot"]
    assert STATE_INTS == 4 * MAX_T + 1


# ------------------------------------------------- the wrapper's host side

class _Recorder:
    """A library whose launching entries record their arguments and return
    0; its size entries answer as the source does."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def mdx_select_max_targets():
        return MAX_T

    @staticmethod
    def mdx_select_workspace_ints(n, t):
        return workspace_ints(n, t)

    def __getattr__(self, name):
        if not name.startswith("mdx_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture()
def recorded(monkeypatch):
    """The wrapper on CPU tensors with a recording library."""
    lib = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("n,m,targets", [
    (16, 4194304, targets_of([5.0, 25.0, 75.0, 95.0], 4194304)),
    (16, 1050625, targets_of([50.0], 1050625)),
    (64, 262144, targets_of([90.0], 262144)),
    (1, 3, (1, 3, 3)),
    (2, 100, tuple(range(1, 17))),
])
def test_wrapper_launches_and_workspace(recorded, n, m, targets):
    """One entry call (four launches: the memset, three passes), the ranks
    as launch arguments, a workspace of the histograms, tickets and row
    states, an [N, T] output; one count a call and no host sync."""
    flat = torch.empty((n, 1), dtype=torch.float32).expand(n, m)
    kernels.reset_launches()
    before = dict(telemetry.SYNCS)
    out = kernels.select_ranks(flat, targets)
    assert dict(telemetry.SYNCS) == before
    assert kernels.LAUNCHES["select"] == 1
    assert out.shape == (n, len(targets)) and out.dtype == torch.float32
    [(name, args)] = recorded.calls
    x_ptr, ranks, t, ws, ws_ints, out_ptr, an, am, stream = args
    assert name == "mdx_select" and stream == 7
    assert x_ptr == flat.data_ptr() and out_ptr == out.data_ptr()
    assert list(ranks) == list(targets) and t == len(targets)
    assert (an, am) == (n, m)
    assert ws_ints == workspace_ints(n, t) > 0


@pytest.mark.parametrize("shape,ranks,match", [
    ((2, 5), (0,), "ranks"), ((2, 5), (6,), "ranks"), ((2, 5), (), "ranks"),
    ((2, 100), tuple(range(1, 18)), "ranks"),
    ((2, 0), (1,), "rows"), ((5,), (1,), r"\[N, M\]"),
])
def test_wrapper_refuses(recorded, shape, ranks, match):
    with pytest.raises(ValueError, match=match):
        kernels.select_ranks(torch.empty(shape), ranks)
    assert recorded.calls == []
