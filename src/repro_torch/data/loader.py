"""Batching helpers for the training driver (counterpart of
``repro/data/loader.py``), in numpy: the same seed gives the same arrays
byte for byte."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

__all__ = ["tokens_for_training", "batched_stream"]


def tokens_for_training(tokens: np.ndarray, batch: int, seq_len: int,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Every (seq_len + 1)-token window of ``tokens`` as one shuffled
    epoch: (steps, batch, seq_len) int32 inputs and targets."""
    rng = np.random.default_rng(seed)
    num_win = (tokens.shape[0] - 1) // seq_len
    wins = np.stack([tokens[i * seq_len:(i + 1) * seq_len + 1]
                     for i in range(num_win)])
    wins = wins[rng.permutation(num_win)]
    steps = num_win // batch
    wins = wins[: steps * batch].reshape(steps, batch, seq_len + 1)
    return wins[..., :-1].astype(np.int32), wins[..., 1:].astype(np.int32)


def batched_stream(x: np.ndarray, y: np.ndarray, batch: int,
                   seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless batches of ``batch`` rows of (x, y), reshuffled every
    epoch."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(x.shape[0])
        for i in range(x.shape[0] // batch):
            sl = order[i * batch:(i + 1) * batch]
            yield x[sl], y[sl]
