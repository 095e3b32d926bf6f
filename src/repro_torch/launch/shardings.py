"""Sharding rules (counterpart of ``repro/launch/shardings.py``): every
parameter, optimizer-state, batch and decode-cache leaf mapped to DTensor
placements on a ``DeviceMesh``.

The rules are the reference's, case for case:

* **Parameters (standard training)** -- 2-D "FSDP x TP": the contraction
  side shards over the data axes (ZeRO style), the output-side features
  over "model" (tensor parallel: heads, ff, experts, vocab).  A dim that
  an axis does not divide stays whole (replicated over that axis).  MoE
  expert stacks (E, a, b) shard E over "model" where it divides (expert
  parallel), else the ff dim (ff TP).
* **Parameters (pod round)** -- each client is a silo of the mesh and
  holds its whole model, sharded only inside the silo
  (``launch/fedtrain.fed_layout``).
* **Batch** -- the leading dim over every data axis.
* **Decode caches** -- the batch over the data axes where it divides, the
  cache sequence (or a wide feature) dim over "model".

Each rule is written as the reference's ``PartitionSpec``: a tuple with
one entry a tensor dim, None or the mesh axes that shard it
(``spec_of``).  :func:`to_placements` turns it into the DTensor
placements, one a mesh dim, and :func:`spec_of` reads placements back, so
a test can hold both packages' rules against each other.  A
:class:`Sharding` is a mesh and its placements; :func:`distribute` puts a
tensor there.
"""

from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tr

__all__ = ["Spec", "Sharding", "to_placements", "spec_of", "param_spec",
           "params_shardings", "batch_shardings", "decode_state_shardings",
           "replicated", "params_shardings_like", "distribute",
           "distribute_tree", "whole"]

Spec = Tuple[Any, ...]      # per tensor dim: None, an axis, or axes


class Sharding(NamedTuple):
    """A leaf's layout: its mesh and one placement a mesh dim."""
    mesh: DeviceMesh
    placements: Tuple[Placement, ...]

    @property
    def spec(self) -> Spec:
        return spec_of(self.placements, self.mesh)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The DTensor placements of a spec: ``Shard(d)`` on each mesh dim
    named in entry d, ``Replicate()`` elsewhere.  Axes that share a tensor
    dim shard it in mesh order, as the reference's tuples list them."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} of dim {d} are not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(placements: Sequence[Placement], mesh: DeviceMesh) -> Spec:
    """The spec of ``placements``, normalised: each sharded dim's axes as a
    tuple in mesh order, None for a whole dim, no trailing Nones."""
    dims: Dict[int, list] = {}
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} has no spec")
    if not dims:
        return ()
    return tuple(tuple(dims[d]) if d in dims else None
                 for d in range(max(dims) + 1))


def _div(n: int, mesh: DeviceMesh, axes) -> bool:
    return n % axis_size(mesh, axes) == 0


def _maybe(mesh: DeviceMesh, shape, *spec) -> Spec:
    """The spec with each entry whose axes do not divide its dim dropped."""
    return tuple(axes if _div(dim, mesh, axes) else None
                 for dim, axes in zip(shape, spec))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
_COL = ("wq", "wk", "wv", "wi", "wg", "w_in", "ww1", "lm_head", "ck",
        "shared_wi", "shared_wg")          # (d_in, features): TP on features
_ROW = ("wo", "w_out", "ww2", "cv", "proj", "shared_wo", "w_dt")
                                           # (features, d_out): TP on features
_SQUARE = ("wr",)                          # rwkv d -> d


def param_spec(path: str, shape, mesh: DeviceMesh, *, fsdp: bool = True,
               fsdp_axes=None) -> Spec:
    """The spec of one parameter leaf (one layer's shape, without the group
    axis), keyed on its name's last part."""
    dp = fsdp_axes if fsdp_axes is not None else data_axes(mesh)
    fs = dp if fsdp else None
    leaf = [s for s in re.split(r"[./\[\]']+", path.strip(".")) if s][-1]
    shape = tuple(shape)

    if len(shape) == 0 or max(shape) < 1024 and len(shape) == 1:
        return ()
    if leaf == "embed":
        return _maybe(mesh, shape, "model", fs)
    if leaf == "router":
        return _maybe(mesh, shape, fs, None)
    if leaf in ("wi", "wg", "wo") and len(shape) == 3:          # MoE (E, a, b)
        if _div(shape[0], mesh, "model"):
            return _maybe(mesh, shape, "model", fs, None)       # expert parallel
        return (_maybe(mesh, shape, None, fs, "model") if leaf != "wo"
                else _maybe(mesh, shape, None, "model", fs))    # ff TP
    if leaf in _COL or leaf in _SQUARE:
        return _maybe(mesh, shape, fs, "model")
    if leaf in _ROW:
        return _maybe(mesh, shape, "model", fs)
    if leaf in ("bq", "bk", "bv") and len(shape) == 1:
        return _maybe(mesh, shape, "model")
    if leaf in ("w_bcdt",):
        return _maybe(mesh, shape, "model", None)
    if leaf in ("log_a", "d_skip", "dt_bias") and shape[0] >= 1024:
        return _maybe(mesh, shape, "model", *([None] * (len(shape) - 1)))
    return ()       # norms, mixes, u, small leaves: replicated


def _with_group_axis(spec: Spec, leaf_ndim: int, stacked_ndim: int) -> Spec:
    """Nones prepended for the leading group axes of a stacked leaf."""
    pad = stacked_ndim - leaf_ndim
    return tuple([None] * pad + list(spec)
                 + [None] * (leaf_ndim - len(spec)))


def params_shardings(params: Dict[str, torch.Tensor], mesh: DeviceMesh, *,
                     fsdp: bool = True, fsdp_axes=None
                     ) -> Dict[str, Sharding]:
    """A :class:`Sharding` a parameter (real or ``meta`` tensors): the
    layer stacks (leading group axis) take the one-layer rule shifted right
    by one dim."""
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        in_stack = "layers" in name
        base = shape[1:] if in_stack and shape else shape
        spec = param_spec(name, base, mesh, fsdp=fsdp, fsdp_axes=fsdp_axes)
        if in_stack:
            spec = _with_group_axis(spec, len(base), len(shape))
        out[name] = Sharding(mesh, to_placements(spec, mesh))
    return out


# ---------------------------------------------------------------------------
# batch, caches, optimizer state
# ---------------------------------------------------------------------------
def _sharding(mesh: DeviceMesh, spec: Spec) -> Sharding:
    return Sharding(mesh, to_placements(spec, mesh))


def batch_shardings(batch: Dict[str, Any], mesh: DeviceMesh
                    ) -> Dict[str, Sharding]:
    """The leading dim over every data axis where they divide it."""
    dp = data_axes(mesh)

    def one(leaf):
        if leaf.dim() == 0 or not _div(leaf.shape[0], mesh, dp):
            return _sharding(mesh, ())
        return _sharding(mesh, (dp,))
    return {k: one(v) for k, v in batch.items()}


def _state_leaf(leaf: torch.Tensor, mesh: DeviceMesh) -> Sharding:
    dp = data_axes(mesh)
    shape = leaf.shape
    if leaf.dim() <= 1:
        return _sharding(mesh, ())
    spec: list = [None] * leaf.dim()
    if _div(shape[1], mesh, dp):            # (G, B, ...): batch at dim 1
        spec[1] = dp
    if leaf.dim() >= 4:
        # KV cache (G, B, S, KV, D), wkv state (G, B, H, D, D), ssm (G, B,
        # d, N): dim 2 over "model" where it divides and is >= 64
        if _div(shape[2], mesh, "model") and shape[2] >= 64:
            spec[2] = "model"
    elif leaf.dim() == 3 and _div(shape[2], mesh, "model") and \
            shape[2] >= 1024:
        spec[2] = "model"
    return _sharding(mesh, tuple(spec))


def decode_state_shardings(state: tr.DecodeState, mesh: DeviceMesh):
    """The state's structure with a :class:`Sharding` for each tensor:
    caches' batch dim over the data axes where they divide it, the cache
    sequence (or wkv heads, ssm channels) over "model"."""
    def walk(node):
        if isinstance(node, attn_lib.KVCache):
            return attn_lib.KVCache(walk(node.k), walk(node.v), node.index)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return _state_leaf(node, mesh)
        return node
    return tr.DecodeState(tuple(walk(c) for c in state.caches),
                          state.position)


def replicated(tree: Dict[str, Any], mesh: DeviceMesh
               ) -> Dict[str, Sharding]:
    """Every leaf whole on every rank."""
    return {k: _sharding(mesh, ()) for k in tree}


def params_shardings_like(opt_state: Dict[str, Any],
                          param_shardings: Dict[str, Sharding],
                          mesh: DeviceMesh) -> Dict[str, Any]:
    """Optimizer-state shardings: moment trees (mu, nu, velocity) mirror
    the parameters'; Adafactor's factored moments (vr, vc) take the
    matching dims of the parameter's spec; the step count is
    replicated."""
    def factored(sh: Sharding, leaf: dict) -> dict:
        if "v" in leaf:
            return {"v": sh}
        nd = leaf["vr"].dim() + 1
        spec = tuple(sh.spec) + (None,) * (nd - len(sh.spec))
        vr = spec[:-1]
        vc = spec[:-2] + spec[-1:] if nd >= 2 else ()
        return {"vr": _sharding(mesh, vr), "vc": _sharding(mesh, vc)}

    out: Dict[str, Any] = {}
    for k, v in opt_state.items():
        if v is None:
            out[k] = None
        elif k in ("mu", "nu", "velocity"):
            out[k] = dict(param_shardings)
        elif k == "v":
            out[k] = {name: factored(param_shardings[name], leaf)
                      for name, leaf in v.items()}
        else:
            out[k] = _sharding(mesh, ())
    return out


def distribute(x: torch.Tensor, sharding: Sharding) -> DTensor:
    """``x`` (the same whole tensor on every rank) as a DTensor laid out
    as ``sharding``: each rank keeps its shard."""
    return distribute_tensor(x, sharding.mesh, list(sharding.placements))


def distribute_tree(tree, shardings):
    """:func:`distribute` over matching structures (dicts, ``KVCache``,
    ``DecodeState``, tuples); non-tensor leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return distribute(tree, shardings)
    if isinstance(tree, attn_lib.KVCache):
        return attn_lib.KVCache(distribute_tree(tree.k, shardings.k),
                                distribute_tree(tree.v, shardings.v),
                                tree.index)
    if isinstance(tree, tr.DecodeState):
        return tr.DecodeState(tuple(distribute_tree(c, s) for c, s in zip(
            tree.caches, shardings.caches)), tree.position)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) if v is not None
                else None for k, v in tree.items()}
    return tree


def whole(x):
    """A DTensor's whole value on every rank (gathered); a plain tensor as
    it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
