"""Optimizers and learning-rate schedules (counterpart of
``repro/optim``), as pure functions on the port's flat parameter dict."""

from repro_torch.optim.optimizers import (Optimizer, adafactor, adam, adamw,
                                          apply_updates, clip_by_global_norm,
                                          sgd)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "sgd", "adam", "adamw", "adafactor", "apply_updates",
           "clip_by_global_norm", "constant", "cosine_decay", "warmup_cosine"]
