"""Byzantine adversary simulator: who attacks, and what they upload
(counterpart of ``repro/core/attacks.py``).

A fixed fraction ``f`` of the registered fleet is controlled by an
attacker and perturbs its uploads before they reach the server.

* :class:`AttackModel` — a named attack kind plus knobs and a seed; the
  adversary assignment is deterministic in ``(seed, num_clients)`` (a
  numpy permutation, byte-identical to the reference's), so every engine
  and every rerun agree on who is Byzantine.
* The transform applies at the **upload boundary** — post-mask,
  post-codec round trip: the attacker controls the payload the server
  decodes, not the client's local training (a Gaussian attack ships dense
  noise even under a sparse codec).

Attack kinds: ``sign_flip`` (upload ``-strength · u``), ``scale``
(``strength · u``), ``gauss`` (replace the upload with ``N(0, sigma²)``
noise), ``zero`` (upload nothing, claim participation) and ``nan``
(poison the payload; the quarantine gate must absorb it).

The reference draws gauss noise with ``jax.random`` from the round's mask
key.  The port draws its own with :func:`client_attack_noise`, a
counter-based stream keyed by (seed, round, client, leaf) under its own
tag, so a client's noise is the same in every engine and form and whoever
else is drawn; the server also takes a caller's ``attack_noise(t, ids)``,
which is how the parity tests hand in the reference's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.masking import _srl, _stream_key, _stream_words
from repro_torch.device import resolve_device

Tree = Dict[str, torch.Tensor]

__all__ = ["ATTACK_KINDS", "AttackModel", "attack_kinds",
           "client_attack_noise"]

ATTACK_KINDS = ("sign_flip", "scale", "gauss", "zero", "nan")

# The attack stream's tag (the reference folds it into its mask key), so
# the noise is independent of the random-mask scores.
_ATTACK_FOLD = 0xA77AC


def attack_kinds() -> tuple:
    """Attack kind names accepted by :class:`AttackModel`."""
    return ATTACK_KINDS


def client_attack_noise(seed: int, t: int, ids,
                        leaves: Dict[str, Sequence[int]],
                        device=None) -> Tree:
    """Round ``t``'s standard-normal gauss-attack rows for the clients
    ``ids``: ``{leaf: (len(ids), *shape)}`` fp32 on ``device`` (``cuda``
    unless named).

    Leaf ``l`` (its position among ``leaves``' names, sorted) and client
    ``i`` key one splitmix64 stream under ``(_ATTACK_FOLD, seed, t, l)``
    (``masking._stream_words``); entry j's word gives two 24-bit uniforms,
    ``u1`` in (0, 1] from its top bits and ``u2`` in [0, 1) from the next,
    and Box–Muller ``sqrt(-2 ln u1) cos(2π u2)`` in float64, rounded once
    to fp32.  The words are the same bits on every device; ``log`` and
    ``cos`` may differ in the last float64 place, which moves an fp32
    result by at most one ulp."""
    idx = torch.as_tensor(np.asarray(ids, dtype=np.int64)).to(
        resolve_device(device))
    out = {}
    for ell, name in enumerate(sorted(leaves)):
        shape = tuple(int(d) for d in leaves[name])
        z = _stream_words(_stream_key(_ATTACK_FOLD, seed, t, ell), idx,
                          int(np.prod(shape)))
        u1 = (_srl(z, 40) + 1).to(torch.float64) * 2.0 ** -24
        u2 = (_srl(z, 16) & 0xFFFFFF).to(torch.float64) * 2.0 ** -24
        normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            (2.0 * math.pi) * u2)
        out[name] = normal.to(torch.float32).reshape((len(idx),) + shape)
    return out


@dataclasses.dataclass(frozen=True)
class AttackModel:
    """Which clients are Byzantine and what they upload.

    ``fraction`` of the registered fleet is adversarial (a deterministic
    draw in ``(seed, num_clients)``); ``strength`` scales ``sign_flip`` /
    ``scale``; ``sigma`` is the ``gauss`` noise scale.  ``fraction=0``
    disables the attack: the round builders then build the attack-free
    round."""

    kind: str = "sign_flip"
    fraction: float = 0.0
    strength: float = 1.0
    sigma: float = 1.0
    seed: int = 0

    def __post_init__(self):
        """Validate the attack kind and knob ranges."""
        if self.kind not in ATTACK_KINDS:
            raise ValueError(
                f"unknown attack kind {self.kind!r}; known: "
                f"{', '.join(ATTACK_KINDS)}")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"fraction must be in [0, 1], got {self.fraction}")
        if self.strength <= 0.0:
            raise ValueError(f"strength must be > 0, got {self.strength}")
        if self.sigma < 0.0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")

    @property
    def active(self) -> bool:
        """Whether this model perturbs any upload at all."""
        return self.fraction > 0.0

    @property
    def needs_keys(self) -> bool:
        """Whether the transform consumes per-client random draws (the
        reference's name: its draws come from keys)."""
        return self.kind == "gauss"

    def num_adversaries(self, num_clients: int) -> int:
        """How many of ``num_clients`` clients are adversarial."""
        return int(round(self.fraction * num_clients))

    def adversary_mask(self, num_clients: int) -> np.ndarray:
        """The static 0/1 fp32 adversary assignment over all registered
        clients: the first ``num_adversaries`` of
        ``default_rng((seed, num_clients, 0xBAD)).permutation``."""
        mask = np.zeros((num_clients,), np.float32)
        k = self.num_adversaries(num_clients)
        if k > 0:
            rng = np.random.default_rng((self.seed, num_clients, 0xBAD))
            mask[rng.permutation(num_clients)[:k]] = 1.0
        return mask

    def apply_stacked(self, uploads: Tree, adv: torch.Tensor,
                      noise: Optional[Tree] = None) -> Tree:
        """Apply the attack to a client-stacked upload tree.

        ``adv`` is the 0/1 adversary mask over the rows; ``noise`` the
        rows' standard-normal draws (:func:`client_attack_noise`),
        required iff :attr:`needs_keys`.  Every transform is a select, so
        honest rows (``adv == 0``) pass bit for bit."""
        if self.kind == "gauss" and noise is None:
            raise ValueError("gauss attack requires per-client noise rows")
        out = {}
        for k, u in uploads.items():
            rows = adv.to(u.device).reshape((-1,) + (1,) * (u.dim() - 1)) > 0
            if self.kind in ("sign_flip", "scale"):
                s = torch.full((), self.strength, dtype=torch.float32,
                               device=u.device)
                bad = ((-s if self.kind == "sign_flip" else s) * u).to(
                    u.dtype)
            elif self.kind == "zero":
                bad = torch.zeros_like(u)
            elif self.kind == "nan":
                bad = torch.full_like(u, float("nan"))
            else:
                sigma = torch.full((), self.sigma, dtype=torch.float32,
                                   device=u.device)
                bad = (sigma * noise[k].to(u.device)).to(u.dtype)
            out[k] = torch.where(rows, bad, u)
        return out
