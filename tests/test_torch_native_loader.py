"""The port's native threaded dataloader (flexflow_tpu_torch/runtime/
native_loader.py over its own copy of runtime/csrc/dataloader.cc) against
the JAX package's ``NativeBatchLoader``: for the same arrays and seed the
two batch streams are bitwise equal, shuffled or not, across ``reset``
and across epochs; the tail is dropped; many threads keep the order; a
slot copied into the caller's buffers equals the numpy copy; the library
is built under ``build/``, never into the JAX package; and a library that
will not load makes ``group_loader_for`` fall back loudly."""

from pathlib import Path

import numpy as np
import pytest
import torch

from flexflow_tpu.runtime import native_loader as j_native
from flexflow_tpu_torch.runtime import native_loader

pytestmark = pytest.mark.skipif(
    native_loader.load_lib() is None or j_native.load_lib() is None,
    reason="native dataloader unavailable (no g++)")


def _arrays(n=64, feat=5):
    rs = np.random.RandomState(11)
    return (rs.randn(n, feat).astype(np.float32),
            np.arange(n, dtype=np.int32).reshape(n, 1))


def _stream(cls, x, y, batch, epochs, **kw):
    dl = cls([("input", x), ("label", y)], batch, **kw)
    out = []
    try:
        for e in range(epochs):
            if e:
                dl.reset()
            out.append(list(iter(dl.next_batch, None)))
    finally:
        dl.close()
    return out


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 7)])
def test_stream_bitwise_jax(shuffle, seed):
    x, y = _arrays()
    kw = dict(shuffle=shuffle, seed=seed, prefetch_slots=3, num_threads=2)
    got = _stream(native_loader.NativeBatchLoader, x, y, 8, 3, **kw)
    want = _stream(j_native.NativeBatchLoader, x, y, 8, 3, **kw)
    assert len(got) == len(want) == 3
    for ge, we in zip(got, want):
        assert len(ge) == len(we) == 8
        for g, w in zip(ge, we):
            for k in ("input", "label"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    labels = [int(v) for b in got[0] for v in b["label"][:, 0]]
    assert sorted(labels) == list(range(64))
    if shuffle:
        assert labels != list(range(64))
        # a new permutation an epoch
        assert [int(v) for b in got[1] for v in b["label"][:, 0]] != labels


def test_mid_epoch_reset_matches_jax():
    x, y = _arrays()
    res = []
    for cls in (native_loader.NativeBatchLoader, j_native.NativeBatchLoader):
        dl = cls([("input", x), ("label", y)], 8, shuffle=True, seed=5)
        try:
            dl.next_batch(), dl.next_batch()
            dl.reset()
            res.append([b["label"][:, 0].tolist()
                        for b in iter(dl.next_batch, None)])
        finally:
            dl.close()
    assert res[0] == res[1]


def test_tail_dropped():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    dl = native_loader.NativeBatchLoader([("input", x)], 4)
    try:
        assert dl.num_batches == 2
        assert len(list(iter(dl.next_batch, None))) == 2
    finally:
        dl.close()


def test_many_threads_in_order():
    x, y = _arrays(n=256)
    dl = native_loader.NativeBatchLoader([("input", x), ("label", y)], 4,
                                         num_threads=4, prefetch_slots=6)
    try:
        for b in range(dl.num_batches):
            np.testing.assert_array_equal(dl.next_batch()["input"],
                                          x[b * 4:(b + 1) * 4])
    finally:
        dl.close()


def test_copy_into_buffers_equals_numpy_copy():
    x, y = _arrays()
    kw = dict(shuffle=True, seed=3)
    a = native_loader.NativeBatchLoader([("input", x), ("label", y)], 8,
                                        **kw)
    b = native_loader.NativeBatchLoader([("input", x), ("label", y)], 8,
                                        **kw)
    try:
        shapes = a.batch_shapes()
        assert shapes == {"input": ((8, 5), np.dtype(np.float32)),
                          "label": ((8, 1), np.dtype(np.int32))}
        bufs = {"input": torch.empty(8, 5), "label": torch.empty(
            8, 1, dtype=torch.int32)}
        for _ in range(a.num_batches):
            got = a.next_batch(out=bufs)
            want = b.next_batch()
            assert got["input"] is bufs["input"]
            for k in ("input", "label"):
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert a.next_batch(out=bufs) is None
    finally:
        a.close()
        b.close()


def test_library_built_under_build_not_the_jax_package():
    path = native_loader.lib_path()
    root = Path(native_loader.__file__).resolve().parents[2]
    assert path.is_file()
    assert path.parent == root / "build" / "flexflow_tpu_torch_dataloader"
    assert native_loader.load_lib()._name == str(path)


def test_fallback_is_loud(monkeypatch, caplog):
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer,
                                    SingleDataLoader)

    ff = FFModel(FFConfig(batch_size=8), device="cpu")
    x = ff.create_tensor([8, 5], name="input")
    ff.dense(x, 4, name="out")
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    xs, ys = _arrays(n=32)
    SingleDataLoader(ff, x, xs)
    SingleDataLoader(ff, ff.label_tensor, ys % 4)
    monkeypatch.setattr(native_loader, "_lib", False)
    before = native_loader.COUNTERS["fallbacks"]
    with caplog.at_level("WARNING"):
        assert native_loader.group_loader_for(ff) is None
    assert native_loader.COUNTERS["fallbacks"] == before + 1
    assert "slices the data in Python" in caplog.text
