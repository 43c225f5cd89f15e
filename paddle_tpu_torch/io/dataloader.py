"""Dataset / Sampler / DataLoader (counterpart of
``paddle_tpu/io/dataloader.py``).

The reference's Dataset family, samplers, ``BatchSampler``,
``DistributedBatchSampler``, ``DataLoader`` and ``CheckpointableLoader``,
with its numpy randomness kept exactly: ``RandomSampler``,
``WeightedRandomSampler``, ``SubsetRandomSampler`` and ``random_split``
draw from the global ``np.random``, ``CheckpointableLoader`` from its own
``(seed, epoch)`` generator, so one seed gives the reference's order.

Batches are CPU ``torch.Tensor``s (``default_collate_fn``: numpy items
stacked, then ``torch.from_numpy``); ``hapi.Model`` moves them to the
network's device.  ``num_workers > 0`` runs that many worker processes
that evaluate ``dataset[i]`` and ship numpy back (torch items are turned
into numpy arrays in the worker); they never touch CUDA, and collation
stays in the parent, as in the reference.  ``forkserver`` is preferred
(the parent may have CUDA initialised), ``fork`` taken for a dataset
defined in ``__main__``.
"""
from __future__ import annotations

import itertools
import time
import queue
import threading
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..common.errors import enforce

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "CheckpointableLoader", "get_worker_info",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of CPU tensors (a CUDA tensor is copied to the host: worker
    processes must not touch the card)."""

    def __init__(self, tensors: Sequence):
        self.tensors = [t.detach().cpu() if isinstance(t, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(t))
                        for t in tensors]
        n = self.tensors[0].shape[0]
        enforce(all(t.shape[0] == n for t in self.tensors),
                "all tensors must share dim 0")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    """Map-style concatenation (paddle/torch ConcatDataset)."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        enforce(len(self.datasets) > 0,
                "ConcatDataset needs at least one dataset")
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __getitem__(self, idx):
        if idx < 0:
            if idx < -len(self):
                raise ValueError(
                    "absolute value of index should not exceed dataset "
                    f"length ({len(self)})")
            idx += len(self)
        if idx >= len(self):
            # IndexError, not ValueError: plain for-loops over
            # map-style datasets terminate via the sequence protocol
            raise IndexError(
                f"index {idx} out of range for ConcatDataset of "
                f"length {len(self)}")
        ds = int(np.searchsorted(self.cumulative_sizes, idx,
                                 side="right"))
        prev = self.cumulative_sizes[ds - 1] if ds else 0
        return self.datasets[ds][idx - prev]

    def __len__(self):
        return self.cumulative_sizes[-1]


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    enforce(sum(lengths) == len(dataset), "lengths must sum to dataset size")
    perm = np.random.permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self._num_samples = int(num_samples)
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(
            len(self.weights), self._num_samples,
            replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self._num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        else:
            self.sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks (one process a
    rank feeds its slice).  ``num_replicas`` and ``rank`` must be given:
    the distributed environment is not ported."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            # the reference reads them from distributed.env
            raise NotImplementedError(
                "DistributedBatchSampler without num_replicas and rank "
                "(the ranks of the distributed environment) is not "
                "ported yet (ROADMAP 'Multi-device')")
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to make divisible
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch


def default_collate_fn(batch: List[Any]):
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.cpu() for b in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    return batch


def _host_item(item):
    """A worker's item with its CPU tensors as numpy arrays (the dtypes
    numpy holds): plain pickles through the queue, no shared-memory
    handles; the parent's collation gives the same batch."""
    if isinstance(item, torch.Tensor):
        try:
            return item.numpy()
        except (TypeError, RuntimeError):  # bfloat16, a tensor in a graph
            return item
    if isinstance(item, (tuple, list)):
        return type(item)(_host_item(x) for x in item)
    if isinstance(item, dict):
        return {k: _host_item(v) for k, v in item.items()}
    return item


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_WORKER_INFO: "WorkerInfo | None" = None


def get_worker_info():
    """Inside a DataLoader worker process: its (id, num_workers,
    dataset); None in the main process (paddle/torch contract)."""
    return _WORKER_INFO


def _mp_worker_loop(dataset, task_q, res_q, init_fn, wid,
                    num_workers=0):
    """Subprocess worker: evaluates dataset[i] (numpy-level: workers
    must not touch CUDA; collation and device placement stay in the
    parent) and ships the items back."""
    global _WORKER_INFO
    _WORKER_INFO = WorkerInfo(wid, num_workers, dataset)
    if init_fn is not None:
        init_fn(wid)
    while True:
        task = task_q.get()
        if task is None:
            return
        bid, idxs = task
        try:
            res_q.put((bid, [_host_item(dataset[i]) for i in idxs],
                       None))
        except Exception as e:                     # surfaced in parent
            res_q.put((bid, None, repr(e)))
            return


class DataLoader:
    """paddle.io.DataLoader-shaped loader.

    ``num_workers=0``: synchronous in-process iteration.
    ``num_workers>0``: that many worker processes evaluate
    ``dataset[i]`` in parallel (the reference's multiprocess DataLoader
    contract); items return via queues and the parent collates (the
    batches stay on the CPU).  IterableDataset streams use a thread
    prefetcher (a python iterator cannot be sharded across processes
    safely).
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = max(2, prefetch_factor)
        self.num_workers = num_workers
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _gen_batches(self):
        if self._iterable:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idx_batch in self.batch_sampler:
                items = [self.dataset[i] for i in idx_batch]
                yield self.collate_fn(items)

    def _mp_iter(self):
        import multiprocessing as mp
        # prefer forkserver: forking a CUDA-initialised (multi-threaded)
        # parent is deprecated on 3.12+ and can deadlock the child.
        # forkserver needs a picklable dataset — probe once per loader
        # (cached across epochs, null-sink pickler so no bytes are
        # materialized) and fall back to fork for closures/local
        # classes (documented constraint: fork-path datasets must be
        # fork-safe instead).
        method = getattr(self, "_mp_method", None)
        if method is None:
            import pickle

            class _NullSink:
                def write(self, _):
                    return None

            class _Probe(pickle.Pickler):
                # anything pickled BY REFERENCE to __main__ (classes,
                # functions, partial targets, nested transforms) would
                # fail to re-import in a forkserver child — reject it
                # wherever it appears in the object graph
                def reducer_override(self, obj):
                    if getattr(obj, "__module__", None) == "__main__" \
                            or getattr(type(obj), "__module__",
                                       None) == "__main__":
                        raise pickle.PicklingError(
                            "__main__-defined: use fork")
                    return NotImplemented
            try:
                _Probe(_NullSink(),
                       protocol=pickle.HIGHEST_PROTOCOL).dump(
                    (self.dataset, self.worker_init_fn))
                method = "forkserver"
            except Exception:
                method = "fork"
            self._mp_method = method
        ctx = mp.get_context(method)
        if method == "forkserver":
            # the server imports this module (and so torch) once; each
            # worker it forks then starts in milliseconds instead of
            # importing torch anew (seconds an epoch).  No effect once
            # the server runs.
            ctx.set_forkserver_preload(["__main__", __name__])
        batches = list(self.batch_sampler)
        task_q = ctx.Queue()
        res_q = ctx.Queue()
        n_workers = min(self.num_workers, max(1, len(batches)))
        procs = [ctx.Process(target=_mp_worker_loop,
                             args=(self.dataset, task_q, res_q,
                                   self.worker_init_fn, w, n_workers),
                             daemon=True)
                 for w in range(n_workers)]
        for p in procs:
            p.start()
        try:
            # backpressure: keep only ~prefetch_factor batches in flight
            # per worker; refill as the consumer drains (an up-front full
            # enqueue lets workers materialize the whole epoch in RAM)
            inflight_cap = max(n_workers * self.prefetch_factor,
                               n_workers)
            issued = 0
            done_markers = 0

            def _issue():
                nonlocal issued, done_markers
                if issued < len(batches):
                    task_q.put((issued, list(batches[issued])))
                    issued += 1
                elif done_markers < n_workers:
                    task_q.put(None)
                    done_markers += 1

            for _ in range(min(inflight_cap, len(batches)) + n_workers):
                _issue()
            pending = {}
            expect = 0
            deadline = (time.monotonic() + self.timeout) \
                if self.timeout else None
            while expect < len(batches):
                if expect in pending:
                    items = pending.pop(expect)
                else:
                    try:
                        bid, items, err = res_q.get(timeout=1.0)
                    except queue.Empty:
                        # liveness: a silently-dead worker (OOM kill,
                        # unpicklable item) must not hang the loop
                        if not any(p.is_alive() for p in procs):
                            raise RuntimeError(
                                "DataLoader workers died without "
                                "reporting a result (killed? "
                                "unpicklable sample?)")
                        if deadline and time.monotonic() > deadline:
                            raise RuntimeError(
                                f"DataLoader timed out after "
                                f"{self.timeout}s waiting for batch "
                                f"{expect}")
                        continue
                    if err is not None:
                        raise RuntimeError(f"DataLoader worker failed: "
                                           f"{err}")
                    if bid != expect:
                        pending[bid] = items
                        continue
                yield self.collate_fn(items)
                expect += 1
                _issue()
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._gen_batches()
            return
        if not self._iterable and self.num_workers > 0:
            yield from self._mp_iter()
            return
        # iterable streams: thread prefetcher
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()

        def worker():
            try:
                for b in self._gen_batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b

    def __len__(self):
        if self._iterable:
            raise RuntimeError("IterableDataset loader has no len()")
        return len(self.batch_sampler)


class CheckpointableLoader:
    """Deterministic, position-checkpointable batch loader — the data
    half of exact training resume (SURVEY.md §5 checkpoint/resume).

    Wraps a map-style dataset with its OWN seeded per-epoch shuffle
    (derived from ``(seed, epoch)`` via a private Generator — the global
    ``np.random`` stream is untouched), so the batch order of any epoch
    is reproducible in a fresh process.  The loader tracks its cursor as
    it yields: between two batches, ``state_dict()`` fully describes the
    stream position and ``set_state_dict`` fast-forwards to it WITHOUT
    materializing skipped items (skipped indices never hit
    ``dataset[i]``).  hapi ``fit(checkpoint_dir=..., auto_resume=True)``
    saves/restores this state alongside the model, so a resumed run
    consumes exactly the batches the interrupted run did not — the
    prerequisite for a bit-identical loss trajectory.

    Iterating resumes the CURRENT epoch at the cursor (mid-epoch after
    ``set_state_dict``, else batch 0) and auto-advances the epoch at
    exhaustion, so ``for epoch in ...: for batch in loader:`` walks
    distinct shuffles with no ``set_epoch`` bookkeeping.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, collate_fn=None):
        enforce(not isinstance(dataset, IterableDataset),
                "CheckpointableLoader needs a map-style dataset (an "
                "iterable stream has no random-accessible position to "
                "checkpoint)")
        enforce(batch_size >= 1, "batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate_fn
        self._epoch = 0
        self._next_batch = 0

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self.seed, int(epoch)])))
        return rng.permutation(n)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = self._order(self._epoch)
        n_batches = len(self)
        for bi in range(self._next_batch, n_batches):
            idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in idxs]
            # cursor advances BEFORE the yield: a state_dict() taken
            # after consuming this batch points at the next one
            self._next_batch = bi + 1
            yield self.collate_fn(items)
        self._epoch += 1
        self._next_batch = 0

    # -- position checkpointing ----------------------------------------------
    def state_dict(self):
        return {"epoch": self._epoch, "next_batch": self._next_batch,
                "seed": self.seed, "shuffle": self.shuffle,
                "batch_size": self.batch_size}

    def set_state_dict(self, state):
        # a position is only meaningful under the SAME ordering config —
        # resuming a seed-5 run with a seed-9 loader would silently
        # replay/skip the wrong samples
        for k in ("seed", "shuffle", "batch_size"):
            if k in state:
                enforce(state[k] == getattr(self, k),
                        f"loader {k} mismatch on resume: checkpoint has "
                        f"{state[k]!r}, this loader has "
                        f"{getattr(self, k)!r}")
        self._epoch = int(state["epoch"])
        self._next_batch = int(state["next_batch"])
