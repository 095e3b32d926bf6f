"""Sharding hints (counterpart of ``repro/models/hints.py``): optional
layout anchors inside the model, so that sharded execution never falls
back to replicating attention.

Tensor-parallel attention wants the head axis sharded over "model", but
several archs have head counts that 16 does not divide (qwen2-1.5b: 12,
gemma2: 8, hymba: 25, llama4 and qwen2.5: 40).  So each anchor picks, per
tensor, as the reference does:

  1. head-sharded (H % model == 0): Megatron attention;
  2. sequence-sharded (T % model == 0): context parallelism for the rest;
  3. replicated (neither divides): tiny shapes only.

The batch dim goes over the data axes (where they divide it; the
reference's XLA anchor pads an uneven batch, a DTensor shard would be
uneven).  An anchor is ``DTensor.redistribute`` to that layout; where the
reference's ``with_sharding_constraint`` leaves the collectives to XLA,
DTensor issues them here.  ``hints=None`` (the default everywhere) makes
every ``apply_*`` the identity: the single-device paths never touch
``torch.distributed``.

Weights and gradients: ``gathered`` is FSDP's gather of a layer's
weights over the data axes just before use, whose backward
reduce-scatters the gradient to the weight's shards; ``grad_layout``
brings any other leaf's gradient to its parameter's placements, so one
rank only ever holds its share of a step's work and gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["Hints", "apply_qkv", "apply_seq", "apply_batch",
           "apply_feature", "whole", "replicated", "zeros", "gathered",
           "grad_layout", "batch_grad", "grad_bf16", "apply_grad_bf16"]


@dataclasses.dataclass(frozen=True)
class Hints:
    """Anchors on ``mesh``: batch over the ``dp`` axes, heads, sequence or
    features over ``model`` (``model_size`` ranks)."""
    mesh: object = None
    dp: Tuple[str, ...] = ("data",)
    model: str = "model"
    model_size: int = 1

    def _ok(self, dim: int) -> bool:
        return self.model_size > 1 and dim % self.model_size == 0

    def splits_batch(self, batch: int) -> bool:
        """Whether the data axes shard a batch dim of this size."""
        return bool(self.dp) and batch % self._dp_size() == 0

    def layout(self, data=None, model=None) -> list:
        """DTensor placements on ``mesh``: ``data`` on each data axis,
        ``model`` on "model", Replicate for None and on other axes (a
        ``local_map`` layout)."""
        from torch.distributed.tensor import Replicate
        return [(model if n == self.model else
                 data if n in self.dp else None) or Replicate()
                for n in self.mesh.mesh_dim_names]

    def _place(self, x: torch.Tensor, spec: list) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.shardings import to_placements
        if not isinstance(x, DTensor):
            return x
        if self.splits_batch(x.shape[0]):
            spec[0] = self.dp
        placements = to_placements(tuple(spec), self.mesh)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    def _dp_size(self) -> int:
        from repro_torch.launch.mesh import axis_size
        return axis_size(self.mesh, self.dp)

    def qkv(self, x: torch.Tensor, h_axis: int, t_axis: int) -> torch.Tensor:
        """An activation with a head axis and a sequence axis."""
        spec: list = [None] * x.dim()
        if self._ok(x.shape[h_axis]):
            spec[h_axis] = self.model
        elif self._ok(x.shape[t_axis]):
            spec[t_axis] = self.model
        return self._place(x, spec)

    def seq(self, x: torch.Tensor, t_axis: int) -> torch.Tensor:
        spec: list = [None] * x.dim()
        if self._ok(x.shape[t_axis]):
            spec[t_axis] = self.model
        return self._place(x, spec)

    def batch_only(self, x: torch.Tensor) -> torch.Tensor:
        return self._place(x, [None] * x.dim())

    def feature(self, x: torch.Tensor, f_axis: int) -> torch.Tensor:
        """Batch over the data axes, ``f_axis`` over "model" (if it
        divides)."""
        spec: list = [None] * x.dim()
        if self._ok(x.shape[f_axis]):
            spec[f_axis] = self.model
        return self._place(x, spec)


def apply_qkv(hints: Optional[Hints], x: torch.Tensor, h_axis: int,
              t_axis: int) -> torch.Tensor:
    return hints.qkv(x, h_axis, t_axis) if hints is not None else x


def apply_seq(hints: Optional[Hints], x: torch.Tensor,
              t_axis: int) -> torch.Tensor:
    return hints.seq(x, t_axis) if hints is not None else x


def apply_batch(hints: Optional[Hints], x: torch.Tensor) -> torch.Tensor:
    return hints.batch_only(x) if hints is not None else x


def apply_feature(hints: Optional[Hints], x: torch.Tensor,
                  f_axis: int) -> torch.Tensor:
    return hints.feature(x, f_axis) if hints is not None else x


def whole(hints: Optional[Hints], x: torch.Tensor) -> torch.Tensor:
    """Under hints, a DTensor's whole value as a plain tensor on every rank
    (its gradient flows back to the shards); else ``x``."""
    from torch.distributed.tensor import DTensor
    if hints is None or not isinstance(x, DTensor):
        return x
    return x.full_tensor()


def replicated(hints: Optional[Hints], x: torch.Tensor) -> torch.Tensor:
    """Under hints, ``x`` as a replicated DTensor on the hints' mesh: a
    plain tensor is taken as what every rank holds whole, a DTensor is
    gathered; else ``x``."""
    from torch.distributed.tensor import DTensor, Replicate
    if hints is None:
        return x
    whole = [Replicate()] * hints.mesh.ndim
    if isinstance(x, DTensor):
        return x.redistribute(hints.mesh, whole)
    return DTensor.from_local(x, hints.mesh, whole, run_check=False)


def zeros(hints: Optional[Hints], shape: Tuple[int, ...], dtype,
          device=None) -> torch.Tensor:
    """Zeros of ``shape`` whose leading dim is a batch: under hints that
    split it, a DTensor made of each rank's rows alone (batch over the data
    axes, replicated over "model"), so that no rank makes the global
    batch's zeros; else a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if hints is None or not hints.splits_batch(shape[0]):
        return torch.zeros(shape, dtype=dtype, device=device)
    local = torch.zeros((shape[0] // hints._dp_size(),) + tuple(shape[1:]),
                        dtype=dtype, device=device)
    return DTensor.from_local(local, hints.mesh, hints.layout(Shard(0)),
                              run_check=False)


def gathered(hints: Optional[Hints], tree, batch: int):
    """Under hints whose data axes split ``batch`` (the rows the weights
    will meet), each DTensor leaf of ``tree`` (a layer's parameters, or
    the embedding and head) whole over the data axes, its "model"
    placement kept: FSDP's gather just before the products use it, so
    that they run on the rank's rows.  (Left to itself, DTensor may
    instead move the rows onto the weight's FSDP shards, a contraction
    split whose partial sums then run on the whole batch.)  The gradient
    comes back in the leaf's placements, reduce-scattered over the data
    axes where the backward makes it (``Redistribute``'s backward), in
    the leaf's dtype.  Rows that every data rank holds whole (a batch of
    one) keep the split contraction.  Else ``tree``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map
    if hints is None or not hints.splits_batch(batch):
        return tree
    names = hints.mesh.mesh_dim_names

    def gather(x):
        if not isinstance(x, DTensor):
            return x
        want = tuple(Replicate() if names[i] in hints.dp else p
                     for i, p in enumerate(x.placements))
        return x if want == tuple(x.placements) else \
            x.redistribute(x.device_mesh, want)
    return tree_map(gather, tree)


class _GradLayout(torch.autograd.Function):
    """Identity whose gradient takes the given DTensor placements."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.layout = (mesh, placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.layout
        if tuple(g.placements) != tuple(placements):
            g = g.redistribute(mesh, placements)
        return g, None, None


def grad_layout(hints: Optional[Hints], x: torch.Tensor) -> torch.Tensor:
    """Under hints, the DTensor ``x`` whose gradient is brought to ``x``'s
    own placements as the backward leaves it: on a parameter, every rank
    then holds only its shard of the gradient, and a sum partial over
    several mesh dims is reduced in one all-reduce over them flattened
    (``launch/mesh.make_mesh`` registers the flattened dims).  Else
    ``x``."""
    from torch.distributed.tensor import DTensor
    if hints is None or not isinstance(x, DTensor):
        return x
    return _GradLayout.apply(x, x.device_mesh, tuple(x.placements))


def batch_grad(hints: Optional[Hints], x: torch.Tensor) -> torch.Tensor:
    """Under hints, ``x`` whose gradient is gathered to the batch-only
    layout (whole over "model") before it reaches the ops that made ``x``:
    a reshape that splits a dim into heads needs its gradient whole where
    "model" does not divide the heads.  Else ``x``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.shardings import to_placements
    if hints is None or not isinstance(x, DTensor):
        return x
    spec: list = [None] * x.dim()
    if hints.splits_batch(x.shape[0]):
        spec[0] = hints.dp
    return _GradLayout.apply(x, hints.mesh,
                             to_placements(tuple(spec), hints.mesh))


class _GradBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose gradient is rounded to bfloat16.  On a block output
    it makes the backward partial sums of the row-parallel products (and
    the weight-gradient reductions they feed) move in bf16, halving the
    backward's largest collectives (bf16 gradient all-reduce)."""
    return _GradBf16.apply(x)


def apply_grad_bf16(hints: Optional[Hints], x: torch.Tensor) -> torch.Tensor:
    """Active only under sharded execution (hints given), as in the
    reference: the single-device paths keep exact fp32 gradients.  Where
    the block output is bf16 already (a bf16 compute dtype) the rounding
    changes nothing; on an fp32 output (fp32 compute, RWKV's promoted time
    mix) it rounds the gradient."""
    return grad_bf16(x) if hints is not None else x
