"""The port's ``io`` against the reference's: the same seed gives the
same sample order from every sampler and ``random_split``, ``DataLoader``
yields the same batches with ``num_workers`` 0 and 2 as the reference's
in-process loader (the port's as CPU torch tensors), ``CheckpointableLoader`` walks the same epochs and
states, and the token-file reader gives the same blocks, natively (each
package builds its own ``dataio.cpp``) and on the python path.

Batches are compared exactly (integers and float32 copies).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.io as ref_io
from paddle_tpu.core import load_native as ref_load_native

import paddle_tpu_torch.io as io
from paddle_tpu_torch.core import load_native
from torch_io_data import ArrDataset


class Stream(ref_io.IterableDataset):
    def __iter__(self):
        return iter(np.arange(11, dtype=np.float32).reshape(11, 1))


class PortStream(io.IterableDataset):
    def __iter__(self):
        return iter(np.arange(11, dtype=np.float32).reshape(11, 1))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.value) if hasattr(x, "value") else np.asarray(x)


def _batches(loader):
    return [[_np(t) for t in b] if isinstance(b, (list, tuple)) else
            [_np(b)] for b in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


SAMPLERS = {
    "random": lambda m, ds: list(m.RandomSampler(ds)),
    "random_replacement": lambda m, ds: list(m.RandomSampler(
        ds, replacement=True, num_samples=50)),
    "random_num_samples": lambda m, ds: list(m.RandomSampler(
        ds, num_samples=20)),
    "weighted": lambda m, ds: list(m.WeightedRandomSampler(
        np.linspace(0.1, 2.0, len(ds)), 30)),
    "weighted_no_replacement": lambda m, ds: list(m.WeightedRandomSampler(
        np.linspace(0.1, 2.0, len(ds)), 12, replacement=False)),
    "subset_random": lambda m, ds: list(m.SubsetRandomSampler(
        range(3, 30, 2))),
    "sequence": lambda m, ds: list(m.SequenceSampler(ds)),
    "batch_shuffle": lambda m, ds: list(m.BatchSampler(
        ds, shuffle=True, batch_size=5)),
    "batch_drop_last": lambda m, ds: list(m.BatchSampler(
        ds, shuffle=False, batch_size=5, drop_last=True)),
    "distributed": lambda m, ds: [list(m.DistributedBatchSampler(
        ds, 4, num_replicas=3, rank=r, shuffle=True)) for r in range(3)],
    "random_split": lambda m, ds: [s.indices for s in m.random_split(
        ds, [20, 10, 7])],
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_sampler_orders_match_reference(kind):
    from paddle_tpu.io import dataloader as ref_dl
    from paddle_tpu_torch.io import dataloader as dl
    ds = ArrDataset()
    np.random.seed(11)
    want = SAMPLERS[kind](ref_dl, ds)
    np.random.seed(11)
    got = SAMPLERS[kind](dl, ds)
    assert got == want
    np.random.seed(11)
    assert SAMPLERS[kind](dl, ds) == got          # the seed decides


def test_distributed_sampler_needs_its_ranks(monkeypatch):
    """Without ``num_replicas`` / ``rank`` the sampler takes the
    distributed environment's, as the reference's does."""
    for k in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
        monkeypatch.delenv(k, raising=False)
    s = io.DistributedBatchSampler(ArrDataset(), 4)
    assert (s.nranks, s.local_rank) == (1, 0)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    s = io.DistributedBatchSampler(ArrDataset(), 4)
    assert (s.nranks, s.local_rank) == (2, 1)
    s = io.DistributedBatchSampler(ArrDataset(), 4, num_replicas=2)
    assert (s.nranks, s.local_rank) == (2, 1)
    s = io.DistributedBatchSampler(ArrDataset(), 4, num_replicas=2, rank=1,
                                   shuffle=True)
    s.set_epoch(3)
    assert s.epoch == 3 and len(s) == len(list(s))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match_reference(workers, shuffle):
    ds = ArrDataset()
    kw = dict(batch_size=8, shuffle=shuffle)
    np.random.seed(5)
    # the reference's in-process batches: its worker processes import
    # JAX anew (15 s an epoch here), and its own tests hold them equal
    want = _batches(ref_io.DataLoader(ds, **kw))
    np.random.seed(5)
    loader = io.DataLoader(ds, num_workers=workers, **kw)
    got = list(loader)
    assert len(loader) == len(got) == 5
    for b in got:
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in b)
    assert got[0][0].dtype == torch.float32
    assert got[0][1].dtype == torch.int64
    _assert_same_batches(_batches(got), want)


def test_tensor_dataset_and_collation():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6, dtype=np.int32)
    ds = io.TensorDataset([torch.from_numpy(x), y])
    assert len(ds) == 6
    row = ds[2]
    assert all(isinstance(t, torch.Tensor) for t in row)
    np.testing.assert_array_equal(row[0].numpy(), x[2])
    # workers return numpy rows: the same batches either way
    for workers in (0, 2):
        got = list(io.DataLoader(ds, batch_size=4, num_workers=workers))
        np.testing.assert_array_equal(got[0][0].numpy(), x[:4])
        np.testing.assert_array_equal(got[1][1].numpy(), y[4:])
        assert got[1][1].dtype == torch.int32
    with pytest.raises(Exception):
        io.TensorDataset([x, y[:5]])


def test_collate_nested_and_scalars():
    items = [({"a": np.ones(2, np.float32) * i, "b": i}, float(i))
             for i in range(3)]
    want = ref_io.dataloader.default_collate_fn(items)
    got = io.dataloader.default_collate_fn(items)
    assert isinstance(got[0]["a"], torch.Tensor)
    np.testing.assert_array_equal(got[0]["a"].numpy(), _np(want[0]["a"]))
    np.testing.assert_array_equal(got[0]["b"].numpy(), _np(want[0]["b"]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


def test_dataset_family_matches_reference():
    a, b = ArrDataset(10, 1), ArrDataset(7, 2)
    for mod in (ref_io, io):
        cat = mod.ConcatDataset([a, b])
        assert len(cat) == 17
    pairs = [(ref_io.ConcatDataset([a, b]), io.ConcatDataset([a, b])),
             (ref_io.ComposeDataset([a, b]), io.ComposeDataset([a, b])),
             (ref_io.Subset(a, [4, 1, 7]), io.Subset(a, [4, 1, 7]))]
    for want, got in pairs:
        assert len(got) == len(want)
        for i in range(len(want)):
            for u, v in zip(got[i], want[i]):
                np.testing.assert_array_equal(u, v)
    with pytest.raises(IndexError):
        io.ConcatDataset([a, b])[17]
    np.testing.assert_array_equal(
        np.stack(list(iter(io.ChainDataset([PortStream(), PortStream()])))),
        np.stack(list(iter(ref_io.ChainDataset([Stream(), Stream()])))))


@pytest.mark.parametrize("workers", [0, 1])
def test_iterable_loader_matches_reference(workers):
    want = _batches(ref_io.DataLoader(Stream(), batch_size=4,
                                      num_workers=workers))
    got = _batches(io.DataLoader(PortStream(), batch_size=4,
                                 num_workers=workers))
    _assert_same_batches(got, want)
    with pytest.raises(RuntimeError):
        len(io.DataLoader(PortStream(), batch_size=4))


def _ckpt_loaders(**kw):
    return (ref_io.CheckpointableLoader(ArrDataset(30), batch_size=4, **kw),
            io.CheckpointableLoader(ArrDataset(30), batch_size=4, **kw))


@pytest.mark.parametrize("shuffle", [False, True])
def test_checkpointable_loader_matches_reference(shuffle):
    ref, port = _ckpt_loaders(shuffle=shuffle, seed=7)
    assert len(port) == len(ref) == 8
    for _ in range(2):                       # two epochs, two orders
        _assert_same_batches(_batches(port), _batches(ref))
        assert port.state_dict() == ref.state_dict()
    # mid-epoch state: a fresh loader set to it yields the same rest
    it_ref, it_port = iter(ref), iter(port)
    for _ in range(3):
        next(it_ref), next(it_port)
    state = port.state_dict()
    assert state == ref.state_dict() == {
        "epoch": 2, "next_batch": 3, "seed": 7, "shuffle": shuffle,
        "batch_size": 4}
    ref2, port2 = _ckpt_loaders(shuffle=shuffle, seed=7)
    ref2.set_state_dict(state)
    port2.set_state_dict(state)
    rest = _batches(port2)
    assert len(rest) == 5
    _assert_same_batches(rest, _batches(ref2))
    _assert_same_batches(rest, _batches(it_port))
    with pytest.raises(Exception):
        port2.set_state_dict(dict(state, seed=8))


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    arr = np.random.default_rng(3).integers(0, 50304, 64 * 37).astype(
        np.int32)
    p = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    arr.tofile(p)
    return str(p), arr


def test_native_library_builds():
    lib = load_native()
    assert lib is not None and hasattr(lib, "dataio_open")
    assert load_native() is lib                  # built once


def test_token_dataset_matches_reference(token_file):
    p, arr = token_file
    want, got = ref_io.TokenFileDataset(p, 64), io.TokenFileDataset(p, 64)
    assert len(got) == len(want) == 37
    for i in (0, 5, 36):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], arr[i * 64:(i + 1) * 64])


@pytest.mark.parametrize("seed", [None, 7])
def test_native_token_loader_matches_reference(token_file, seed):
    p, _ = token_file
    assert ref_load_native() is not None
    want = ref_io.TokenFileLoader(p, seq_len=64, batch_size=4,
                                  shuffle_seed=seed)
    got = io.TokenFileLoader(p, seq_len=64, batch_size=4, shuffle_seed=seed)
    assert got.is_native and want.is_native
    assert len(got) == len(want) == 9
    for _ in range(len(got) + 3):                # past an epoch's end
        np.testing.assert_array_equal(got.next(), want.next())
    got.close()
    want.close()


def _python_path(mod, p, seed):
    """A loader forced onto the python path (no native library)."""
    real = mod.load_native
    mod.load_native = lambda: None
    try:
        return mod.TokenFileLoader(p, seq_len=64, batch_size=4,
                                   shuffle_seed=seed)
    finally:
        mod.load_native = real


@pytest.mark.parametrize("seed", [None, 7])
def test_python_token_loader_matches_reference(token_file, seed):
    from paddle_tpu.io import token_dataset as ref_td
    from paddle_tpu_torch.io import token_dataset as td
    p, arr = token_file
    want, got = _python_path(ref_td, p, seed), _python_path(td, p, seed)
    assert not got.is_native and not want.is_native
    blocks = [got.next() for _ in range(len(got) + 2)]
    for b in blocks:
        np.testing.assert_array_equal(b, want.next())
    if seed is None:
        np.testing.assert_array_equal(blocks[0].ravel(), arr[:256])
    seen = np.sort(np.concatenate([b.ravel() for b in blocks[:len(got)]]))
    assert len(seen) == 9 * 256
    assert os.path.exists(p)
