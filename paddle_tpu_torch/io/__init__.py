"""``paddle.io`` (counterpart of ``paddle_tpu/io/__init__.py``, the same
names): datasets, samplers, ``DataLoader``, ``CheckpointableLoader``
and the token-file reader."""
from .dataloader import (
    BatchSampler,
    ChainDataset,
    CheckpointableLoader,
    ComposeDataset,
    ConcatDataset,
    DataLoader,
    Dataset,
    DistributedBatchSampler,
    IterableDataset,
    RandomSampler,
    Sampler,
    SequenceSampler,
    Subset,
    SubsetRandomSampler,
    TensorDataset,
    WeightedRandomSampler,
    get_worker_info,
    random_split,
)
from .token_dataset import TokenFileDataset, TokenFileLoader
