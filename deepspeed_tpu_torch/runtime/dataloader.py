"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

The same numpy ``default_rng`` draws as the JAX package, so one seed gives
the same samples and the same shuffles in both; batches are dicts of
numpy arrays that the engine moves to its device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class RepeatingLoader:
    """Wraps an iterable to restart it when exhausted."""

    def __init__(self, loader):
        self.loader = loader
        self._iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self.loader)
            return next(self._iter)


class DataLoader:
    """Per-process batches of ``local_batch_size`` samples; shuffling is
    keyed by (seed, epoch), each process takes a contiguous slice."""

    def __init__(self, dataset: Sequence[dict] | Any, local_batch_size: int,
                 *, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.local_batch_size = local_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or self._default_collate
        self.epoch = 0
        self.rank, self.world = _rank_world()

    @staticmethod
    def _default_collate(samples: list[dict]) -> dict:
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in samples[0]}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.world
        if self.drop_last:
            return n // self.local_batch_size
        return -(-n // self.local_batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        per = n // self.world
        idx = idx[self.rank * per:(self.rank + 1) * per]
        bs = self.local_batch_size
        stop = (len(idx) // bs) * bs if self.drop_last else len(idx)
        for i in range(0, stop, bs):
            yield self.collate_fn([self.dataset[int(j)]
                                   for j in idx[i:i + bs]])


def random_token_dataset(n_samples: int, seq_len: int, vocab_size: int,
                         seed: int = 0, learnable: bool = False) -> list[dict]:
    """Synthetic LM samples; ``learnable=True`` gives constant-token
    sequences, a bigram task a model learns in a few steps."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        if learnable:
            ids = np.full((seq_len,), rng.integers(0, vocab_size),
                          dtype=np.int32)
        else:
            ids = rng.integers(0, vocab_size, (seq_len,), dtype=np.int32)
        out.append({"input_ids": ids})
    return out
