"""Synthetic stand-ins for MNIST / CIFAR-10 / WikiText-2 (counterpart of
``repro/data/synthetic.py``).

* ``class_gaussian_images`` — a K-class dataset where each class is a
  Gaussian blob around a class-specific low-frequency template image.
* ``markov_text`` — an order-2 Markov-chain token stream over a Zipf-weighted
  vocabulary, an LM task with a non-uniform optimal perplexity.

Both are numpy only and give byte-identical arrays to the reference for the
same arguments and seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ImageDataset", "TextDataset", "class_gaussian_images",
           "markov_text"]


@dataclasses.dataclass
class ImageDataset:
    """Train/test images (N, H, W, C) float32 and labels (N,) int32."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int


@dataclasses.dataclass
class TextDataset:
    """Train/test token streams (N,) int32 over ``vocab_size`` tokens."""

    train_tokens: np.ndarray
    test_tokens: np.ndarray
    vocab_size: int


def _class_templates(rng: np.random.Generator, num_classes: int, h: int,
                     w: int, c: int) -> np.ndarray:
    """Low-frequency class templates: random 2D Fourier modes."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    out = np.zeros((num_classes, h, w, c), np.float32)
    for k in range(num_classes):
        img = np.zeros((h, w), np.float32)
        for _ in range(4):
            fy, fx = rng.integers(1, 4, size=2)
            phase = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.5, 1.0)
            img += amp * np.sin(2 * np.pi * fy * yy + phase[0]) * \
                np.sin(2 * np.pi * fx * xx + phase[1])
        img /= max(np.abs(img).max(), 1e-6)
        out[k] = img[..., None].repeat(c, axis=-1)
        if c > 1:
            out[k] *= rng.uniform(0.6, 1.0, size=(1, 1, c)).astype(np.float32)
    return out


def class_gaussian_images(num_train: int = 4000, num_test: int = 1000,
                          num_classes: int = 10, image_size: int = 14,
                          channels: int = 1, noise: float = 0.7,
                          seed: int = 0) -> ImageDataset:
    """Deterministic (in ``seed``) K-class Gaussian-blob image dataset."""
    rng = np.random.default_rng(seed)
    h = w = image_size
    templates = _class_templates(rng, num_classes, h, w, channels)

    def gen(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        x = templates[y] + noise * rng.standard_normal(
            (n, h, w, channels)).astype(np.float32)
        return x.astype(np.float32), y

    tx, ty = gen(num_train)
    ex, ey = gen(num_test)
    return ImageDataset(tx, ty, ex, ey, num_classes)


def markov_text(num_train: int = 200_000, num_test: int = 20_000,
                vocab_size: int = 512, branching: int = 8,
                seed: int = 0) -> TextDataset:
    """Order-2 Markov chain: each (prev2, prev1) context admits
    ``branching`` possible next tokens with Zipf-ish weights."""
    rng = np.random.default_rng(seed)
    num_ctx = 4096                       # hashed contexts: a small dense table
    # Quadratic bias toward low token ids gives a Zipf-like marginal.
    nexts = (vocab_size * rng.random((num_ctx, branching)) ** 2.5
             ).astype(np.int32).clip(0, vocab_size - 1)
    probs = 1.0 / np.arange(1, branching + 1)
    probs /= probs.sum()

    def gen(n):
        toks = np.empty(n, np.int32)
        toks[0], toks[1] = rng.integers(0, vocab_size, size=2)
        _ = rng.integers(0, num_ctx)     # the reference's RNG warm start draw
        choices = rng.choice(branching, size=n, p=probs)
        for i in range(2, n):
            ctx = (toks[i - 2] * 31 + toks[i - 1] * 7) % num_ctx
            toks[i] = nexts[ctx, choices[i]]
        return toks

    return TextDataset(gen(num_train), gen(num_test), vocab_size)
