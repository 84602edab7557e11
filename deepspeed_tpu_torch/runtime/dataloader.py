"""Data loading: ``DeepSpeedDataLoader`` and ``RepeatingLoader``.

Port of ``deepspeed_tpu/runtime/dataloader.py``. Batches are numpy (the
engine moves them to its device); the epoch order comes from an explicit
``numpy.random.RandomState(seed + epoch)``, the same order the JAX loader
draws, so the two packages see the same batches.
"""

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def _to_numpy(x):
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):      # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def default_collate(samples):
    """Stack a list of samples (each a tuple/dict/array) into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([_to_numpy(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([_to_numpy(s[i]) for s in samples])
                           for i in range(len(first)))
    return np.stack([_to_numpy(s) for s in samples])


class DeepSpeedDataLoader:
    """Each data-parallel rank sees a disjoint strided shard; the order
    reshuffles every epoch with a seeded permutation."""

    def __init__(self, dataset, batch_size, data_parallel_world_size=1,
                 data_parallel_rank=0, collate_fn=None, shuffle=True,
                 seed=1234, drop_last=True):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.dp_world_size = int(data_parallel_world_size)
        self.dp_rank = int(data_parallel_rank)
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        try:
            self._n = len(dataset)
        except TypeError:
            raise ValueError("DeepSpeedDataLoader requires a sized dataset")
        shard = self._n // self.dp_world_size
        self.len = shard // self.batch_size
        if not drop_last and shard % self.batch_size:
            self.len += 1

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.len

    def __iter__(self):
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch) \
                .permutation(self._n)
        else:
            order = np.arange(self._n)
        my_idx = order[self.dp_rank::self.dp_world_size]
        if self.drop_last:
            my_idx = my_idx[:(len(my_idx) // self.batch_size)
                            * self.batch_size]
        for i in range(0, len(my_idx), self.batch_size):
            batch_idx = my_idx[i:i + self.batch_size]
            samples = [self.dataset[int(j)] for j in batch_idx]
            yield self.collate_fn(samples)
        self.epoch += 1
