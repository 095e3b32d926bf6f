"""Federated data partitioning (counterpart of ``repro/data/partition.py``).

IID partitioning follows McMahan et al.: shuffle the training set (images,
or (seq_len + 1)-token windows of a corpus) and deal equal-size shards to
the M clients, returned STACKED with leading (num_clients, num_batches,
batch, ...) axes.  Numpy only; byte-identical to
the reference for the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["iid_partition_images", "partition_text"]


def _batch_clients(x: np.ndarray, y: np.ndarray, num_clients: int,
                   batch_size: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    per_client = (x.shape[0] // num_clients // batch_size) * batch_size
    if per_client == 0:
        raise ValueError("not enough samples per client for one batch")
    nb = per_client // batch_size
    xs = x[: per_client * num_clients].reshape(
        (num_clients, nb, batch_size) + x.shape[1:])
    ys = y[: per_client * num_clients].reshape((num_clients, nb, batch_size))
    n_samples = np.full((num_clients,), per_client, np.float32)
    return xs, ys, n_samples


def iid_partition_images(x: np.ndarray, y: np.ndarray, num_clients: int,
                         batch_size: int, seed: int = 0):
    """Shuffle and deal equal IID shards: ``(xs, ys, n_samples)``."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(x.shape[0])
    return _batch_clients(x[order], y[order], num_clients, batch_size)


def partition_text(tokens: np.ndarray, num_clients: int, batch_size: int,
                   seq_len: int, seed: int = 0):
    """Chop the corpus into (seq_len + 1)-token windows and deal them IID:
    ``(inputs, targets, n_samples)``, inputs and targets int32 of shape
    (num_clients, num_batches, batch, seq_len)."""
    rng = np.random.default_rng(seed)
    num_win = (tokens.shape[0] - 1) // seq_len
    wins = np.stack([tokens[i * seq_len:(i + 1) * seq_len + 1]
                     for i in range(num_win)])
    wins = wins[rng.permutation(num_win)]
    per_client = (num_win // num_clients // batch_size) * batch_size
    if per_client == 0:
        raise ValueError("not enough windows per client")
    nb = per_client // batch_size
    wins = wins[: per_client * num_clients].reshape(
        num_clients, nb, batch_size, seq_len + 1)
    inputs, targets = wins[..., :-1], wins[..., 1:]
    n_samples = np.full((num_clients,), per_client, np.float32)
    return inputs.astype(np.int32), targets.astype(np.int32), n_samples
