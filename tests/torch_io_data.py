"""Datasets the port's ``io`` and ``hapi`` tests hand to worker
processes.  This module imports numpy alone, so a worker that unpickles
one imports no JAX (which would cost seconds a worker)."""
import numpy as np


class ArrDataset:
    """Map-style numpy rows ``(x [3] float32, y int64)`` (no base class:
    the reference's and the port's loaders both take it)."""

    def __init__(self, n=37, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.y = rng.integers(0, 5, n).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.y)


class TokenClsDataset:
    """Rows ``(ids [S] int32, attention mask [S] int32, label int64)``:
    the last quarter of each row padded (id 0, mask 0), the label made
    from the first id."""

    def __init__(self, n=32, s=16, vocab=256, classes=4, seed=0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(1, vocab, (n, s)).astype(np.int32)
        self.mask = np.ones((n, s), np.int32)
        self.mask[:, s - s // 4:] = 0
        self.ids[self.mask == 0] = 0
        self.y = (self.ids[:, 0] % classes).astype(np.int64)

    def __getitem__(self, i):
        return self.ids[i], self.mask[i], self.y[i]

    def __len__(self):
        return len(self.y)
