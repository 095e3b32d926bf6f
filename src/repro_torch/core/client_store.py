"""Per-client server state (counterpart of ``repro/core/client_store.py``).

Everything the server remembers *per client* — error-feedback residuals,
FedDyn's drift, the adaptive samplers' update-norm EMA and the model
version each client last pulled — lives behind one
:class:`ClientStateStore` contract with two backends:

* :class:`DenseStore` — dense ``(M, …)`` stacked tensors, one per leaf of
  every named state tree; the in-program round bodies read and write it
  whole.
* :class:`ShardedStore` — state rows only for the (at most) ``retention``
  clients that committed most recently: one ``(retention + 1, …)`` pool
  per leaf, whose last row is a permanent zero sentinel that a gather of
  an unknown or evicted client reads, and one host-side slot directory
  shared by every tree.  When the pool is full the least recently
  committed client is evicted to zero (ties broken by slot index; slots
  committing in the same round are never victims), and every tree of a
  freshly assigned slot is zeroed before any tree writes, so eviction
  forgets all of a client's trees at once.  One round committing more
  clients than ``retention`` raises.

The named trees are ``"residuals"`` always plus any ``extra_trees``
(``"drift"``).  The compact ``(M,)`` vectors exist for all M clients on
both backends: the fp32 norm EMA (ones at start, on the template's device)
and the host-side int64 ``versions`` vector (``mark_dispatched``,
``staleness``).

Placement: the pools and dense stacks live on the template's device; the
slot directory stays on the host as numpy.  A sharded gather is one
``index_select`` per leaf at the slot indices, a scatter one in-place
``index_copy_`` per leaf.  ``state()`` / ``load_state()`` use the
reference's keys, and ``memory_bytes()`` counts as the reference counts.

``shard_over(mesh)`` places the norm vector and the backing over the mesh's
data axes as the reference does: the client (or slot) axis as a DTensor
``Shard(0)`` over them where it divides (the sharded pool zero-padded up to
a multiple first, the pad rows never addressed), the rest replicated.
Each rank then holds its rows: a gather reads the ids its rows hold and
sums the (zero elsewhere) result over the data axes, exactly; a scatter
writes the rows it holds.  ``memory_bytes()`` keeps the reference's global
counts and adds ``residual_bytes_per_device``; ``state()`` gives whole
tensors, and ``load_state`` lays them out again.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
Spec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]

__all__ = ["ClientStateStore", "DenseStore", "ShardedStore", "make_store"]


def _ids_array(ids) -> np.ndarray:
    """A gather/scatter id argument as a 1-D int64 numpy array."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    out = np.asarray(ids)
    if out.ndim != 1:
        raise ValueError(f"ids must be 1-D, got shape {out.shape}")
    return out.astype(np.int64)


def _host(x) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host (a copy for an
    array-like, which may be read-only)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _per_client_bytes(spec: Spec) -> int:
    """Bytes ONE client's row of a tree costs."""
    return int(sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in spec.values()))


def _zeros(rows: int, spec: Spec, device) -> Tree:
    return {k: torch.zeros((rows,) + shape, dtype=dtype, device=device)
            for k, (shape, dtype) in spec.items()}


def _load(value, rows: int, spec: Spec, device, what: str) -> Tree:
    """A restored stacked tree as tensors on ``device``, each leaf checked
    against ``(rows, *shape)``."""
    if set(value) != set(spec):
        raise ValueError(f"{what} holds leaves {sorted(value)}, the store "
                         f"{sorted(spec)}")
    out = {}
    for k, (shape, dtype) in spec.items():
        v = value[k]
        v = (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v, copy=True)))
        if tuple(v.shape) != (rows,) + shape:
            raise ValueError(f"{what}[{k!r}] has shape {tuple(v.shape)}, "
                             f"the store {(rows,) + shape}")
        out[k] = v.to(device=device, dtype=dtype)
    return out


def _is_sharded(v) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(v, DTensor)


def _local_range(v) -> Tuple[int, int]:
    """The rows [lo, hi) of a dim-0-sharded DTensor this rank holds."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        tuple(v.shape), v.device_mesh, v.placements)
    return off[0], off[0] + shape[0]


def _rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v.index_select(0, idx)`` as a plain tensor; for a sharded ``v`` each
    rank fills the rows it holds and the zeros elsewhere sum over the mesh
    (exact: one nonzero term a row)."""
    import torch.distributed as dist
    if not _is_sharded(v):
        return v.index_select(0, idx)
    lo, hi = _local_range(v)
    local = v.to_local()
    mine = (idx >= lo) & (idx < hi)
    out = torch.zeros((idx.numel(),) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=local.device)
    out[mine] = local.index_select(0, idx[mine] - lo)
    mesh = v.device_mesh
    for d, p in enumerate(v.placements):
        if not p.is_replicate() and mesh.size(d) > 1:
            dist.all_reduce(out, group=mesh.get_group(d))
    return out


def _write_rows(v: torch.Tensor, idx: torch.Tensor,
                rows: Optional[torch.Tensor]) -> None:
    """``v.index_copy_(0, idx, rows)`` (``index_fill_`` with zeros when
    ``rows`` is None), in place; a sharded ``v`` writes the rows it holds."""
    if _is_sharded(v):
        lo, hi = _local_range(v)
        mine = (idx >= lo) & (idx < hi)
        local, at = v.to_local(), idx[mine] - lo
        if rows is None:
            local.index_fill_(0, at, 0)
        else:
            local.index_copy_(0, at, rows[mine].to(v.dtype))
    elif rows is None:
        v.index_fill_(0, idx, 0)
    else:
        v.index_copy_(0, idx, rows.to(v.dtype))


def _whole(v):
    return v.full_tensor() if _is_sharded(v) else v


def _nbytes(v: torch.Tensor, local: bool) -> int:
    """Bytes of ``v`` (its whole size), or of this rank's shard."""
    if local and _is_sharded(v):
        v = v.to_local()
    return v.numel() * v.element_size()


def _vector(value, num: int, what: str) -> np.ndarray:
    out = np.array(_host(value), dtype=np.int64)
    if out.shape != (num,):
        raise ValueError(f"{what} has shape {out.shape}, the store ({num},)")
    return out


class ClientStateStore:
    """The store contract: named state trees moved by :meth:`gather` /
    :meth:`scatter`, the ``(M,)`` norm EMA and model versions, and
    :meth:`state` / :meth:`load_state` / :meth:`memory_bytes`."""

    kind = "abstract"

    def __init__(self, num_clients: int, template: Tree,
                 track_norms: bool = False,
                 extra_trees: Optional[Dict[str, Tree]] = None):
        """Trees shaped like ``template`` (and each extra tree) for
        ``num_clients`` clients on the template's device; ``track_norms``
        adds the norm EMA."""
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if extra_trees and "residuals" in extra_trees:
            raise ValueError("extra_trees may not shadow the 'residuals' tree")
        self.num_clients = int(num_clients)
        self.device = next(iter(template.values())).device
        self.templates: Dict[str, Spec] = {
            name: {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}
            for name, tree in {"residuals": template,
                               **(extra_trees or {})}.items()}
        self._norms: Optional[torch.Tensor] = (
            torch.ones(num_clients, dtype=torch.float32, device=self.device)
            if track_norms else None)
        # The round each client last pulled Θ in (0 = never dispatched).
        self.versions = np.zeros((num_clients,), np.int64)
        self._mesh = None           # set by shard_over

    @property
    def trees(self) -> Tuple[str, ...]:
        """Names of the per-client state trees this store holds."""
        return tuple(self.templates)

    def _check_tree(self, tree: str) -> str:
        if tree not in self.templates:
            raise KeyError(f"store holds no state tree {tree!r}; trees: "
                           f"{', '.join(self.templates)}")
        return tree

    # ---- state rows --------------------------------------------------------
    def gather(self, ids, tree: str = "residuals") -> Tree:
        """Stacked ``tree`` rows for ``ids`` (zeros where unknown)."""
        raise NotImplementedError

    def scatter(self, ids, rows: Tree, commit, round: int,
                tree: str = "residuals") -> None:
        """Write back ``rows[i]`` for every i with ``commit[i] > 0``; the
        other clients keep their state (the upload was dropped or
        quarantined)."""
        raise NotImplementedError

    def dense_view(self, tree: str = "residuals") -> Tree:
        """The full ``(M, …)`` stacked view of one tree."""
        raise NotImplementedError

    def residuals_dense(self) -> Tree:
        """``dense_view("residuals")``."""
        return self.dense_view("residuals")

    # ---- compact (M,) vectors ----------------------------------------------
    @property
    def norms(self) -> Optional[torch.Tensor]:
        """The per-client update-norm EMA, or None without tracking."""
        return None if self._norms is None else _whole(self._norms)

    def _check_norms(self) -> None:
        if self._norms is None:
            raise ValueError(f"the {self.kind} store was built without norm "
                             "tracking (track_norms=False)")

    def set_norms(self, norms) -> None:
        """Replace the whole norm-EMA vector."""
        self._check_norms()
        self._norms = self._place(torch.as_tensor(
            norms, dtype=torch.float32).to(self.device))

    def update_norms(self, ids, values) -> None:
        """Set the norm rows at ``ids`` to ``values``."""
        self._check_norms()
        idx = torch.from_numpy(_ids_array(ids)).to(self.device)
        self._norms = self._place(self.norms.index_copy(
            0, idx, torch.as_tensor(values, dtype=torch.float32).to(
                self.device)))

    def mark_dispatched(self, ids, round: int) -> None:
        """Record that ``ids`` pulled Θ in ``round``."""
        self.versions[_ids_array(ids)] = int(round)

    def staleness(self, ids, round: int) -> np.ndarray:
        """Round distance ``round - versions[id]`` for each id (>= 0)."""
        return np.maximum(int(round) - self.versions[_ids_array(ids)], 0)

    # ---- checkpointing and accounting --------------------------------------
    def state(self) -> Dict[str, Any]:
        """The store's state as a tree for ``checkpoint.save_checkpoint``
        (the backing tensors themselves, not copies)."""
        raise NotImplementedError

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Restore :meth:`state`'s tree (tensors or numpy arrays)."""
        raise NotImplementedError

    def _load_vectors(self, tree: Dict[str, Any]) -> None:
        versions = _vector(tree["versions"], self.num_clients, "versions")
        norms = None
        if self._norms is not None:
            norms = torch.as_tensor(_host(tree["norms"]), dtype=torch.float32)
            if tuple(norms.shape) != (self.num_clients,):
                raise ValueError(f"norms has shape {tuple(norms.shape)}, the "
                                 f"store ({self.num_clients},)")
            norms = norms.to(self.device)
        self.versions = versions
        if norms is not None:
            self._norms = norms

    def _vector_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"versions": torch.from_numpy(
            self.versions.copy())}
        if self._norms is not None:
            out["norms"] = self.norms
        return out

    # ---- placement over a mesh ---------------------------------------------
    def _data_size(self) -> int:
        from repro_torch.launch.mesh import axis_size, data_axes
        return axis_size(self._mesh, data_axes(self._mesh))

    def _place(self, v: torch.Tensor, pad: bool = False) -> torch.Tensor:
        """``v`` (whole, on every rank) as a DTensor with dim 0 over the
        data axes; left whole where they do not divide it (zero-padded to
        a multiple first with ``pad``)."""
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor

        from repro_torch.launch.mesh import data_axes
        if self._mesh is None or v is None:
            return v
        size = self._data_size()
        if size <= 1:
            return v
        if v.shape[0] % size:
            if not pad:
                return v
            extra = -(-v.shape[0] // size) * size - v.shape[0]
            v = torch.cat([v, v.new_zeros((extra,) + tuple(v.shape[1:]))])
        axes = data_axes(self._mesh)
        placements = [Shard(0) if n in axes else Replicate()
                      for n in self._mesh.mesh_dim_names]
        return distribute_tensor(v, self._mesh, placements)

    def shard_over(self, mesh) -> None:
        """Distribute the norm vector and the backing over ``mesh``'s data
        axes (``launch.mesh.data_axes``), as the module docstring says.
        Every rank of the mesh calls it, holding the same store."""
        self._mesh = mesh
        if self._norms is not None:
            self._norms = self._place(_whole(self._norms))
        self._shard_backing()

    def _shard_backing(self) -> None:
        """Backend hook of :meth:`shard_over`: place the backing."""

    def memory_bytes(self) -> Dict[str, Any]:
        """The client-state footprint: every tree's backing, the O(M)
        vectors, and what a dense ``(M, …)`` store would hold."""
        client = sum(_per_client_bytes(s) for s in self.templates.values())
        vectors = int(self.versions.nbytes)
        if self._norms is not None:
            vectors += 4 * self.num_clients
        out = {"backend": self.kind, "client_bytes": client,
               "vector_bytes": vectors,
               "residual_bytes": self._backing_bytes(),
               "dense_equiv_bytes": client * self.num_clients}
        if self._mesh is not None:      # after shard_over: this rank's part
            out["residual_bytes_per_device"] = self._backing_bytes(local=True)
        return out

    def _backing_bytes(self, local: bool = False) -> int:
        raise NotImplementedError


class DenseStore(ClientStateStore):
    """Dense ``(M, …)`` stacked state trees, zeros at start."""

    kind = "dense"

    def __init__(self, num_clients: int, template: Tree,
                 track_norms: bool = False,
                 extra_trees: Optional[Dict[str, Tree]] = None):
        """See :class:`ClientStateStore`."""
        super().__init__(num_clients, template, track_norms, extra_trees)
        self._data: Dict[str, Tree] = {
            name: _zeros(num_clients, spec, self.device)
            for name, spec in self.templates.items()}

    def gather(self, ids, tree: str = "residuals") -> Tree:
        """Stacked ``tree`` rows for ``ids``."""
        idx = torch.from_numpy(_ids_array(ids)).to(self.device)
        return {k: _rows(v, idx)
                for k, v in self._data[self._check_tree(tree)].items()}

    def scatter(self, ids, rows: Tree, commit, round: int,
                tree: str = "residuals") -> None:
        """Commit-masked row write-back: ``rows[i]`` where ``commit[i] >
        0``, the old row elsewhere, then one ``index_copy`` a leaf."""
        data = self._data[self._check_tree(tree)]
        idx = torch.from_numpy(_ids_array(ids)).to(self.device)
        keep = torch.as_tensor(_host(commit), dtype=torch.float32).to(
            self.device)
        out = {}
        for k, old in data.items():
            mask = keep.reshape((-1,) + (1,) * (old.dim() - 1))
            new = torch.where(mask > 0, rows[k], _rows(old, idx))
            if _is_sharded(old):
                _write_rows(old, idx, new)
                out[k] = old
            else:
                out[k] = old.index_copy(0, idx, new)
        self._data[tree] = out

    def dense_view(self, tree: str = "residuals") -> Tree:
        """The stacked backing of one tree itself (no copy; gathered whole
        after :meth:`shard_over`)."""
        data = self._data[self._check_tree(tree)]
        if self._mesh is None:
            return data
        return {k: _whole(v) for k, v in data.items()}

    def set_dense(self, value: Tree, tree: str = "residuals") -> None:
        """Replace a whole stacked tree (the in-program round bodies gather
        and scatter rows themselves)."""
        self._data[self._check_tree(tree)] = {
            k: self._place(v) for k, v in value.items()}

    def state(self) -> Dict[str, Any]:
        """``residuals`` and every extra tree under its own name, stacked;
        ``versions``; ``norms`` when tracked."""
        return {**{name: {k: _whole(v) for k, v in data.items()}
                   for name, data in self._data.items()},
                **self._vector_state()}

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Restore :meth:`state`'s tree."""
        data = {name: _load(tree[name], self.num_clients, spec, self.device,
                            name)
                for name, spec in self.templates.items()}
        self._load_vectors(tree)
        self._data = data
        if self._mesh is not None:
            self.shard_over(self._mesh)

    def _shard_backing(self) -> None:
        self._data = {name: {k: self._place(_whole(v))
                             for k, v in data.items()}
                      for name, data in self._data.items()}

    def _backing_bytes(self, local: bool = False) -> int:
        return int(sum(_nbytes(v, local) for data in self._data.values()
                       for v in data.values()))


class ShardedStore(ClientStateStore):
    """State rows for the ``retention`` most recently committed clients
    (see the module docstring); peak backing is ``(retention + 1) / M`` of
    the dense footprint."""

    kind = "sharded"

    def __init__(self, num_clients: int, template: Tree, retention: int,
                 track_norms: bool = False,
                 extra_trees: Optional[Dict[str, Tree]] = None):
        """See :class:`ClientStateStore`; ``retention`` is the window in
        client slots, in ``(0, num_clients]``."""
        super().__init__(num_clients, template, track_norms, extra_trees)
        if not 0 < retention <= num_clients:
            raise ValueError(f"retention must be in (0, num_clients="
                             f"{num_clients}], got {retention}")
        self.retention = int(retention)
        self._pools: Dict[str, Tree] = {
            name: _zeros(self.retention + 1, spec, self.device)
            for name, spec in self.templates.items()}
        # The slot directory, shared by every tree: owner id per slot (-1 =
        # free), the round its owner last committed (the LRU key), and the
        # id -> slot map.
        self._slot_ids = np.full((self.retention,), -1, np.int64)
        self._slot_round = np.zeros((self.retention,), np.int64)
        self._slot_of: Dict[int, int] = {}
        self.evictions = 0

    @property
    def slots(self) -> Tree:
        """The residual slot pool."""
        return self._pools["residuals"]

    def _slot_index(self, ids: np.ndarray) -> np.ndarray:
        """Slot per id; the zero sentinel ``retention`` on a miss."""
        return np.asarray([self._slot_of.get(int(i), self.retention)
                           for i in ids], np.int64)

    def _assign_slots(self, cids: np.ndarray, round: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Slots for this round's committing clients, evicting the least
        recently committed owners as needed: ``(assigned, fresh)``, the slot
        of each client and the slots newly taken over (free or evicted),
        which must be zeroed in every tree before any tree writes."""
        if len(cids) > self.retention:
            raise ValueError(
                f"round {round} commits {len(cids)} clients but the sharded "
                f"store retains only {self.retention} slots; raise "
                "retention above the largest cohort")
        assigned = np.empty((len(cids),), np.int64)
        pinned = set()
        misses = []
        for i, cid in enumerate(cids):
            slot = self._slot_of.get(int(cid))
            if slot is None:
                misses.append(i)
            else:
                assigned[i] = slot
                pinned.add(slot)
        fresh = []
        if misses:
            free = list(np.flatnonzero(self._slot_ids < 0))
            held = np.asarray([s for s in np.flatnonzero(self._slot_ids >= 0)
                               if s not in pinned], np.int64)
            # Oldest commit first, ties by slot index.
            victims = list(held[np.lexsort((held, self._slot_round[held]))])
            for i in misses:
                if free:
                    slot = int(free.pop(0))
                else:
                    slot = int(victims.pop(0))
                    del self._slot_of[int(self._slot_ids[slot])]
                    self.evictions += 1
                assigned[i] = slot
                fresh.append(slot)
        for cid, slot in zip(cids, assigned):
            self._slot_of[int(cid)] = int(slot)
            self._slot_ids[slot] = int(cid)
            self._slot_round[slot] = int(round)
        return assigned, np.asarray(fresh, np.int64)

    def gather(self, ids, tree: str = "residuals") -> Tree:
        """One ``index_select`` a leaf; misses read the zero sentinel."""
        idx = torch.from_numpy(self._slot_index(_ids_array(ids))).to(
            self.device)
        return {k: _rows(v, idx)
                for k, v in self._pools[self._check_tree(tree)].items()}

    def scatter(self, ids, rows: Tree, commit, round: int,
                tree: str = "residuals") -> None:
        """Write the committed rows into their slots, in place.  Rows with
        ``commit == 0`` neither take a slot nor refresh the LRU clock."""
        tree = self._check_tree(tree)
        ids = _ids_array(ids)
        pos = np.flatnonzero(_host(commit) > 0)
        if pos.size == 0:
            return
        slot_idx, fresh = self._assign_slots(ids[pos], round)
        if fresh.size:
            fresh_t = torch.from_numpy(fresh).to(self.device)
            for pool in self._pools.values():
                for v in pool.values():
                    _write_rows(v, fresh_t, None)
        pos_t = torch.from_numpy(pos).to(self.device)
        slot_t = torch.from_numpy(slot_idx).to(self.device)
        for k, v in self._pools[tree].items():
            _write_rows(v, slot_t, rows[k].index_select(0, pos_t))

    def dense_view(self, tree: str = "residuals") -> Tree:
        """The full ``(M, …)`` view, zeros but the occupied slots.  O(M ×
        model): for tests only."""
        tree = self._check_tree(tree)
        occupied = np.flatnonzero(self._slot_ids >= 0)
        owner = torch.from_numpy(self._slot_ids[occupied]).to(self.device)
        slot = torch.from_numpy(occupied).to(self.device)
        out = _zeros(self.num_clients, self.templates[tree], self.device)
        for k, v in out.items():
            v.index_copy_(0, owner, _rows(self._pools[tree][k], slot))
        return out

    def state(self) -> Dict[str, Any]:
        """``slots`` (the residual pool), ``slots_<tree>`` for every extra
        tree, ``slot_ids``, ``slot_round``, ``versions`` and, when tracked,
        ``norms``.  The ``evictions`` counter is not state, as in the
        reference."""
        rows = self.retention + 1
        pools = {name: {k: _whole(v)[:rows] for k, v in pool.items()}
                 for name, pool in self._pools.items()}
        out: Dict[str, Any] = {
            "slots": pools["residuals"],
            "slot_ids": torch.from_numpy(self._slot_ids.copy()),
            "slot_round": torch.from_numpy(self._slot_round.copy())}
        for name in self.templates:
            if name != "residuals":
                out[f"slots_{name}"] = pools[name]
        return {**out, **self._vector_state()}

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Restore :meth:`state`'s tree and rebuild the slot directory."""
        rows = self.retention + 1
        pools = {name: _load(tree["slots" if name == "residuals"
                                  else f"slots_{name}"], rows, spec,
                             self.device, name)
                 for name, spec in self.templates.items()}
        slot_ids = _vector(tree["slot_ids"], self.retention, "slot_ids")
        slot_round = _vector(tree["slot_round"], self.retention, "slot_round")
        self._load_vectors(tree)
        self._pools = pools
        self._slot_ids, self._slot_round = slot_ids, slot_round
        self._slot_of = {int(cid): s for s, cid in enumerate(slot_ids)
                         if cid >= 0}
        if self._mesh is not None:
            self.shard_over(self._mesh)

    def memory_bytes(self) -> Dict[str, Any]:
        """The base accounting plus the slot directory, the window and the
        eviction count."""
        out = super().memory_bytes()
        out["vector_bytes"] += int(self._slot_ids.nbytes
                                   + self._slot_round.nbytes)
        out["retention"] = self.retention
        out["evictions"] = self.evictions
        return out

    def _shard_backing(self) -> None:
        # The slot axis has retention + 1 rows (the zero sentinel), which
        # seldom divides the data axes: padded up to a multiple, as the
        # reference pads; the pad rows are never addressed.
        self._pools = {name: {k: self._place(_whole(v)[:self.retention + 1],
                                             pad=True)
                              for k, v in pool.items()}
                       for name, pool in self._pools.items()}

    def _backing_bytes(self, local: bool = False) -> int:
        return int(sum(_nbytes(v, local) for pool in self._pools.values()
                       for v in pool.values()))


def make_store(kind: str, num_clients: int, template: Tree, *,
               retention: int | None = None, track_norms: bool = False,
               extra_trees: Optional[Dict[str, Tree]] = None
               ) -> ClientStateStore:
    """A store backend by name: ``"dense"`` or ``"sharded"`` (which needs
    ``retention``, the client-slot window)."""
    if kind == "dense":
        return DenseStore(num_clients, template, track_norms=track_norms,
                          extra_trees=extra_trees)
    if kind == "sharded":
        if retention is None:
            raise ValueError("sharded store requires retention= (the "
                             "client-slot window)")
        return ShardedStore(num_clients, template, retention,
                            track_norms=track_norms, extra_trees=extra_trees)
    raise ValueError(f"unknown store kind {kind!r}; use 'dense' | 'sharded'")
