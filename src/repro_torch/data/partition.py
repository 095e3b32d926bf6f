"""Federated data partitioning (counterpart of ``repro/data/partition.py``).

IID partitioning follows McMahan et al.: shuffle the training set and deal
equal-size shards to the M clients, returned STACKED with leading
(num_clients, num_batches, batch, ...) axes.  Numpy only; byte-identical to
the reference for the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["iid_partition_images"]


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
