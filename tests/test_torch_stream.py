"""The port's decode-ahead stream (``mdx_torch.parallel.stream``) against
the JAX package's (``mdx.parallel.stream``), on the CPU.

The cases of ``tests/test_stream.py`` run on both packages: batch order and
content, a decode error at the batch boundary, decoding ahead of a stalled
consumer (and no further than the watermark), the put hook, DICOM files,
worker retirement on an error and on ``close()``, and a ragged final batch
on a data axis.  There the port's ranks (``SpatialMesh`` objects of
``n_data`` ranks; the stream makes no collective) each yield their block,
and the blocks concatenated equal JAX's padded batch on
``make_mesh(n_data=d)``.  Values are compared bit for bit.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from mdx.parallel import make_mesh
from mdx.parallel import stream as JS

from mdx_torch.io import write_synthetic_dicom
from mdx_torch.parallel import stream as PS
from mdx_torch.parallel.mesh import SpatialMesh

PACKAGES = {"jax": JS, "port": PS}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_order_and_content(pkg):
    stream = PACKAGES[pkg].DecodeStream(
        list(range(10)), lambda i: np.full((4, 4), float(i)), batch_size=3)
    got = list(stream)
    assert [s for s, _ in got] == [0, 3, 6, 9]
    assert [b.shape for _, b in got] == [(3, 4, 4)] * 3 + [(1, 4, 4)]
    for s, b in got:
        assert b.dtype == np.float32
        np.testing.assert_array_equal(
            b, np.arange(s, s + len(b), dtype=np.float32)[:, None, None]
            * np.ones((1, 4, 4), np.float32))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_decode_error_surfaces_at_the_batch(pkg):
    def bad(i):
        if i == 2:
            raise ValueError("corrupt file")
        return np.zeros((2, 2))

    it = iter(PACKAGES[pkg].DecodeStream(list(range(6)), bad, batch_size=2))
    assert next(it)[0] == 0
    with pytest.raises(ValueError, match="corrupt file"):
        next(it)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_decode_runs_ahead_up_to_the_watermark(pkg):
    decoded = []
    lock = threading.Lock()

    def decode(i):
        with lock:
            decoded.append(i)
        return np.zeros((2, 2))

    bs, prefetch = 2, 2
    stream = PACKAGES[pkg].DecodeStream(list(range(40)), decode,
                                        batch_size=bs, prefetch=prefetch,
                                        workers=4)
    it = iter(stream)
    next(it)
    time.sleep(0.3)  # the consumer stalls; the producer runs ahead
    # (prefetch + 1) batches of frames past the last batch formed: the
    # consumed one, `prefetch` queued and one waiting to be queued
    assert 6 <= len(decoded) <= (prefetch + 1) * bs + (prefetch + 2) * bs
    rest = list(it)
    assert len(rest) == 19 and sorted(decoded) == list(range(40))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_device_put_hook(pkg):
    tagged = []

    def put(batch):
        tagged.append(batch.shape)
        return batch * 2

    stream = PACKAGES[pkg].DecodeStream([1, 2], lambda i: np.ones((2, 2)),
                                        batch_size=2, device_put=put)
    (_, batch), = list(stream)
    assert tagged == [(2, 2, 2)]
    np.testing.assert_array_equal(batch, np.full((2, 2, 2), 2.0))


def _files(root, n: int, size: int = 32) -> list[str]:
    return [write_synthetic_dicom(str(root / f"{i}.dcm"), kind="noisy",
                                  size=size, seed=i) for i in range(n)]


def test_dicom_stream_equals_jax(tmp_path):
    paths = _files(tmp_path, 3)
    want = list(JS.stream_batches(paths, batch_size=2))
    got = list(PS.stream_batches(paths, batch_size=2, device="cpu"))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2]
    for (_, g), (_, w) in zip(got, want):
        assert torch.is_tensor(g) and g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 0.0 <= float(got[0][1].min()) and float(got[0][1].max()) <= 1.0


def test_stream_batches_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PS.stream_batches(_files(tmp_path, 1), 1)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_error_retires_workers(pkg):
    def bad(i):
        if i == 2:
            raise ValueError("corrupt")
        return np.zeros((2, 2))

    before = threading.active_count()
    stream = PACKAGES[pkg].DecodeStream(list(range(50)), bad, batch_size=2,
                                        workers=4)
    with pytest.raises(ValueError):
        list(stream)
    stream.join()
    assert not stream._thread.is_alive()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_close_retires_producer(pkg):
    stream = PACKAGES[pkg].DecodeStream(list(range(50)),
                                        lambda i: np.zeros((2, 2)),
                                        batch_size=2, prefetch=1)
    it = iter(stream)
    next(it)
    stream.close()
    stream.join()
    assert not stream._thread.is_alive()


@pytest.mark.parametrize("n,batch,d", [(5, 4, 4), (7, 3, 2), (8, 4, 2)])
def test_ranks_blocks_equal_jax_padded_batches(tmp_path, n, batch, d):
    """Each rank decodes and yields its block of each padded batch; the
    blocks concatenated in rank order equal JAX's padded batch (a ragged
    final batch, a batch size that is not a multiple of d, none)."""
    paths = _files(tmp_path, n)
    want = list(JS.stream_batches(paths, batch_size=batch,
                                  mesh=make_mesh(n_data=d, n_space=1)))
    ranks = [list(PS.stream_batches(paths, batch, mesh=SpatialMesh(
        r, d, 1, torch.device("cpu"), "gloo"))) for r in range(d)]
    assert [s for s, _ in want] == list(range(0, n, batch))
    for r in ranks:
        assert [s for s, _ in r] == [s for s, _ in want]
    for i, (_, w) in enumerate(want):
        got = torch.cat([r[i][1] for r in ranks]).numpy()
        assert got.shape[0] % d == 0 and np.array_equal(got, np.asarray(w))


def test_stream_refuses_space_ranks(tmp_path):
    with pytest.raises(ValueError, match="data axis only"):
        PS.stream_batches(_files(tmp_path, 1), 1, mesh=SpatialMesh(
            0, 1, 2, torch.device("cpu"), "gloo"))
