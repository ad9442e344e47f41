"""Each metric reader on a synthetic reading, and the trace arithmetic on
synthetic profiler events."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from mdxbench import roofline, spec, tracing


def _event(name, start, dur, device=DeviceType.CUDA, kind="kernel"):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                           duration_ns=lambda: dur,
                           device_type=lambda: device,
                           activity_type=lambda: kind)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


CPU = DeviceType.CPU
# a 100 ms window: a hand kernel 10 ms, a PyTorch kernel 20 ms overlapping
# it by 5 ms, a copy 5 ms; idle 100 - 30 = 70 ms: the gap from 0 to 10 ms
# in the call's span, the gap from 40 to 100 ms in the db span (its middle
# lies there)
EVENTS = [
    _event("bench.window", 0, 100_000_000, CPU, "user_annotation"),
    _event("bench.call", 1_000_000, 98_000_000, CPU, "user_annotation"),
    _event("bench.db", 40_000_000, 50_000_000, CPU, "user_annotation"),
    _event("box_stats_pass_kernel(float const*)", 10_000_000, 10_000_000),
    _event("at::native::reduce_kernel<512>", 15_000_000, 20_000_000),
    _event("Memcpy DtoH", 35_000_000, 5_000_000, kind="gpu_memcpy"),
    _event("bench.window", 0, 100_000_000, DeviceType.CUDA,
           "gpu_user_annotation"),
    _event("aten::add", 12_000_000, 1_000, CPU, "cpu_op"),
]


@pytest.fixture
def reading():
    rec = tracing.Recorder()
    rec.span_ms = {"decode": [4.0, 6.0], "db": [1.0, 3.0],
                   "sweep": [30.0, 10.0, 20.0]}
    rec.bound_ms = 2.5
    r = tracing.Reading(setup_s=7.5, host_window_s=2.0, peak_bytes=3 << 30,
                        frames=4, runs=[
                            {"ms": 10.0, "frames": 1, "phase_ms": {
                                "decode": 1.0, "normalize": 2.0,
                                "device_qa": 5.0, "png": 1.0, "db": 1.0}},
                            {"ms": 30.0, "frames": 1, "phase_ms": {
                                "decode": 3.0, "device_qa": 7.0,
                                "report": 1.0}},
                            {"ms": 20.0, "frames": 2, "phase_ms": None},
                            {"ms": 99.0, "frames": 0, "phase_ms": None}])
    tracing.reduce(_prof(EVENTS), rec, {"box_stats_pass_kernel"}, r)
    return r


def test_reduce(reading):
    assert reading.window_s == pytest.approx(0.1)
    assert reading.busy_s == pytest.approx(0.030)
    assert reading.kernel_s == pytest.approx({
        "box_stats_pass_kernel(float const*)": 0.010,
        "at::native::reduce_kernel<512>": 0.020})
    assert reading.idle_by_span == pytest.approx({"call": 0.010,
                                                  "db": 0.060})
    b = tracing.breakdown(reading)
    assert b["device_ops"][0] == ["at::native::reduce_kernel<512>",
                                  pytest.approx(0.020)]
    assert b["idle_gaps"][0] == ["db", pytest.approx(0.060)]


EXPECTED = {
    "frames_per_s": 2.0,
    "run_ms_p50": 20.0,
    "run_ms_p95": 29.0,
    "peak_gib": 3.0,
    "setup_s": 7.5,
    "runner.host_ms": 4.5,
    "runner.device_qa_ms": 6.0,
    "tuning.sweep_ms": 20.0,
    "io.decode_ms_per_frame": 2.5,
    "storage.db_ms_per_frame": 1.0,
    "ops.device_ms_per_frame": 5.0,
    "hand_kernels_roofline": 25.0,
    "device.idle_share.series": 70.0,
    "device.idle_share.single": 70.0,
    "runner.frames_per_s": 2.0,
    "runner.run_ms_p50": 20.0,
    "runner.run_ms_p95": 29.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(reading, name):
    assert spec.reader(name)(reading) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"setup_s"}))
def test_reader_finds_nothing(name):
    """A reader with nothing to read returns nothing, never 0."""
    assert spec.reader(name)(tracing.Reading()) is None


def test_roofline_bound():
    x = torch.zeros(2, 64, 64)
    # unsharp: 4 B in + radius and amount + 4 B out a pixel, vs 103 ops
    by_bytes = (2 * 64 * 64 * 8 + 16) / roofline.HBM_BYTES_PER_S
    by_ops = 2 * 64 * 64 * 103 / roofline.F32_OPS_PER_S
    got = roofline.bound_ms(torch, "unsharp", (x, torch.zeros(2),
                                               torch.zeros(2)), None)
    assert got == pytest.approx(max(by_bytes, by_ops) * 1e3)


def test_hand_kernel_names():
    from conftest import REPO

    names = tracing.hand_kernel_names(REPO / "mdx_torch" / "csrc")
    assert names and all(n.isidentifier() for n in names)
