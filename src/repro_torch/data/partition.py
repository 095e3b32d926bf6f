"""Federated data partitioning (counterpart of ``repro/data/partition.py``).

IID partitioning follows McMahan et al.: shuffle the training set (images,
or (seq_len + 1)-token windows of a corpus) and deal equal-size shards to
the M clients.  Two non-IID image partitioners skew the labels: McMahan's
label shards (``noniid_partition_images``) and a per-client Dirichlet label
mix (``dirichlet_partition_images``).  Shards are returned STACKED with
leading (num_clients, num_batches, batch, ...) axes.  Numpy only;
byte-identical to the reference for the same seed (the same draws in the
same order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["iid_partition_images", "noniid_partition_images",
           "dirichlet_partition_images", "partition_text"]


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


def noniid_partition_images(x: np.ndarray, y: np.ndarray, num_clients: int,
                            batch_size: int, shards_per_client: int = 2,
                            seed: int = 0):
    """McMahan-style pathological non-IID: sort by label, deal
    ``shards_per_client`` label shards to each client, shuffle each
    client's samples: ``(xs, ys, n_samples)``."""
    rng = np.random.default_rng(seed)
    order = np.argsort(y, kind="stable")
    x, y = x[order], y[order]
    num_shards = num_clients * shards_per_client
    shard_size = x.shape[0] // num_shards
    shard_ids = rng.permutation(num_shards)
    xs, ys = [], []
    for c in range(num_clients):
        ids = shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        cx = np.concatenate([x[i * shard_size:(i + 1) * shard_size]
                             for i in ids])
        cy = np.concatenate([y[i * shard_size:(i + 1) * shard_size]
                             for i in ids])
        perm = rng.permutation(cx.shape[0])
        xs.append(cx[perm])
        ys.append(cy[perm])
    x = np.stack(xs).reshape((-1,) + x.shape[1:])
    y = np.stack(ys).reshape(-1)
    return _batch_clients(x, y, num_clients, batch_size)


def dirichlet_partition_images(x: np.ndarray, y: np.ndarray, num_clients: int,
                               batch_size: int, alpha: float = 0.5,
                               seed: int = 0):
    """Dirichlet label-skew non-IID (Hsu et al. 2019): each client draws a
    label mix p_c ~ Dir(alpha) and fills its shard with class counts ~
    Multinomial(per_client, p_c) from class-sorted pools, which cycle when
    they run out so every client gets exactly ``per_client`` samples.
    alpha -> inf approaches IID, alpha -> 0 one class a client."""
    if alpha <= 0.0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    pools = {c: rng.permutation(np.flatnonzero(y == c)) for c in classes}
    cursor = {c: 0 for c in classes}
    per_client = (x.shape[0] // num_clients // batch_size) * batch_size
    if per_client == 0:
        raise ValueError("not enough samples per client for one batch")

    def take(c, n):
        pool = pools[c]
        out = np.empty((n,), np.int64)
        filled = 0
        while filled < n:
            start = cursor[c]
            grab = min(n - filled, pool.shape[0] - start)
            out[filled:filled + grab] = pool[start:start + grab]
            cursor[c] = (start + grab) % pool.shape[0]
            filled += grab
        return out

    xs, ys = [], []
    for _ in range(num_clients):
        p = rng.dirichlet(np.full(classes.shape[0], alpha))
        counts = rng.multinomial(per_client, p)
        idx = np.concatenate([take(c, n)
                              for c, n in zip(classes, counts) if n > 0])
        idx = idx[rng.permutation(idx.shape[0])]
        xs.append(x[idx])
        ys.append(y[idx])
    x = np.stack(xs).reshape((-1,) + x.shape[1:])
    y = np.stack(ys).reshape(-1)
    return _batch_clients(x, y, num_clients, batch_size)


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
