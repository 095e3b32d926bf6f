"""Selective masking on the CUDA kernels (counterpart of
``repro/kernels/ops.py``).

``topk_mask(x, gamma)`` masks ONE array on the per-array kernels
(``kernels.topk_mask``): 1 histogram + ``iters`` counts + 1 apply, the whole
pipeline on the device with no host sync; ``masked_count(x, tau)`` is one
count.

``topk_mask_pytree(tree, gamma)`` masks every maskable leaf of a delta tree
in a leaf-count-independent number of sweeps (DESIGN.md §3.4):
1 segmented histogram + ``refine_sweeps`` multi-candidate count sweeps
+ 1 fused count/apply sweep (= 4 for the default config).

``topk_mask_stacked`` is the cohort form the round uses: a tree whose leaves
carry a leading client axis packs as ``clients x leaves`` segments, so one
sweep of each kernel masks the whole cohort — each segment with its own k
and thresholds, identical to masking every client on its own.

``topk_encode_pytree`` / ``topk_encode_stacked`` are the fused wire path
(DESIGN.md §10): the last sweep is ``segmented_encode``, which emits the
masked values (int8 codes against per-segment scales from one
``segmented_stats`` sweep), a keep bitmap and kept counts, and a per-leaf
compaction batched over clients turns those narrow outputs into COO or
bitmap payloads without re-reading the fp32 data.

Sharded masking: given ``group`` (a ``DeviceMesh``), ``topk_mask_pytree``
and ``topk_mask_stacked`` mask clients whose leaves are DTensors on that
mesh (the client axis whole; plain tensors count as replicated) through
the same packer and passes.  Each rank packs its local shards, its
segments numbered as the whole clients' (a first-axis slice split over
ranks is one segment on each of them); the histogram and each count
sweep run on the local shard and their integer counts are summed over
the mesh between passes, a replicated shard counted by one rank only; so
every rank derives the same thresholds, equal to the whole client's,
and the apply runs on its shard.  The masks are the unsharded masks bit
for bit: the counts are exact integer sums.

``ssm_scan(a, bx, c, h0)`` and ``wkv6(r, k, v, logw, u, s0)`` are the two
recurrences of the model zoo (``kernels.ssm_scan``, ``kernels.wkv6``) in the
models' own layouts, any T, no padding; both are differentiable, through
``torch.autograd.Function``s whose backwards are kernels too.

Trees are flat ``{name: tensor}`` dicts in the reference's leaf order
(``repro_torch.bridge``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.compression import (int8_scales, pack_bits_rows,
                                          unpack_bits_rows)
from repro_torch.kernels import packing as pk
from repro_torch.kernels import segmented as seg
from repro_torch.kernels import ssm_scan as ssk
from repro_torch.kernels import topk_mask as tk
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import EXPO_MIN

Tree = Dict[str, torch.Tensor]

__all__ = ["DEFAULT_REFINE_SWEEPS", "DEFAULT_CANDIDATES", "topk_mask",
           "masked_count", "pytree_sweep_count", "topk_mask_pytree",
           "topk_mask_stacked",
           "topk_encode_pytree", "topk_encode_stacked", "client_encode_scales",
           "wirepath_sweep_count", "wirepath_bytes_moved", "ssm_scan",
           "wkv6"]


def topk_mask(x: torch.Tensor, gamma: float, iters: int = 8) -> torch.Tensor:
    """Threshold-select the ~gamma fraction of largest-|x| entries of ``x``
    (any shape, any float dtype; computed in fp32 and cast back).

    1 histogram sweep brackets the k-th magnitude (k = max(1, round(gamma *
    size))) to an octave whose end counts come from the histogram's suffix
    sums; ``iters`` bisection steps each count ``|x| >= mid`` in one sweep;
    the apply sweep keeps ``|x| >= tau`` with ``tau = hi`` unless hi would
    keep nothing.  Kept <= k whenever the k-th and (k+1)-th magnitudes are
    further apart than the final bracket; tied entries stay together.
    """
    k = max(1, int(round(gamma * x.numel())))
    flat = x.reshape(-1).to(torch.float32).contiguous()
    hist = tk.exponent_histogram(flat)
    lo, hi, _, cnt_hi = tk.select_threshold_counts(hist, k)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = tk.count_ge(flat, mid)
        raise_lo = cnt > k
        lo = torch.where(raise_lo, mid, lo)
        hi = torch.where(raise_lo, hi, mid)
        cnt_hi = torch.where(raise_lo, cnt_hi, cnt)   # hi moved: count is cnt
    # hi is the conservative end: count(>= hi) <= k <= count(>= lo); lo when
    # hi would keep nothing (a tie plateau).
    tau = torch.where(cnt_hi >= 1, hi, lo)
    return tk.apply_threshold(flat, tau).reshape(x.shape).to(x.dtype)


def masked_count(x: torch.Tensor, tau) -> torch.Tensor:
    """0-d int32 number of entries of ``x`` with ``|x| >= tau``, over x's
    own entries only, for any tau (the reference also counts its block
    padding when tau <= 0)."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    tau = torch.as_tensor(tau, dtype=torch.float32, device=flat.device)
    return tk.count_ge(flat, tau.reshape(()).contiguous())


DEFAULT_REFINE_SWEEPS = 2
DEFAULT_CANDIDATES = 16


def pytree_sweep_count(num_leaves: int, *, segmented: bool = True,
                       iters: int = 8,
                       refine_sweeps: int = DEFAULT_REFINE_SWEEPS) -> int:
    """Sweeps over the data to selectively mask an L-leaf tree (analytic).

    Per-leaf pipeline: every leaf pays 1 histogram + ``iters`` counts + 1
    apply.  Segmented: 1 histogram + ``refine_sweeps`` multi-candidate
    counts + 1 fused count/apply, independent of L.
    """
    if segmented:
        return 1 + refine_sweeps + 1
    return num_leaves * (iters + 2)


def _packed_cohort(tree: Tree, min_leaf_size: int,
                   axis0_slices: bool = False):
    """Pack the maskable leaves of a client-stacked tree: ``(names, spec,
    x2d, seg_ids, num_clients)``, or None when no leaf is maskable.  With
    ``axis0_slices`` each first-axis slice of a leaf of ndim >= 2 (per
    client) is a segment of its own.  A DTensor leaf packs its local
    shard (the client axis whole), its size per client the whole leaf's."""
    names = [n for n, leaf in tree.items()
             if leaf.numel() // leaf.shape[0] >= min_leaf_size]
    if not names:
        return None
    leaves = [_local(tree[n]) for n in names]
    num_clients = leaves[0].shape[0]
    slices = [leaf.shape[1] if axis0_slices and leaf.dim() >= 3 else 1
              for leaf in leaves]
    spec = pk.build_pack_spec([leaf[0] for leaf in leaves], slices)
    x2d = pk.pack_stacked(leaves, spec)
    seg_ids = spec.seg_ids(num_clients, device=x2d.device)
    return names, spec, x2d, seg_ids, num_clients


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if hasattr(x, "to_local") else x


def _shard_segments(tree: Tree, names, seg_ids, gamma: float,
                    num_clients: int, axis0_slices: bool, mesh):
    """The local pack's segments renumbered as the whole clients' on
    ``mesh`` (the module docstring's sharded masking): ``(apply ids,
    count ids, k)``.  A first-axis slice split over ranks is one segment
    on each; a leaf replicated over a mesh dim is counted by that dim's
    rank 0 only, the other ranks' counts going to a dump segment past the
    last (k 1, never read)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    coord = mesh.get_coordinate()
    remap, counted, ks = [], [], []
    for n in names:
        leaf = tree[n]
        shape = tuple(leaf.shape)
        if isinstance(leaf, DTensor):
            local, off = compute_local_shape_and_global_offset(
                shape, mesh, leaf.placements)
            owner = all(c == 0 for c, p in zip(coord, leaf.placements)
                        if not isinstance(p, Shard))
        else:
            local, off = shape, (0,) * len(shape)
            owner = all(c == 0 for c in coord)
        cut = axis0_slices and len(shape) >= 3
        parts = shape[1] if cut else 1
        k = max(1, int(round(gamma * (leaf.numel() // shape[0] // parts))))
        mine = local[1] if cut else 1
        remap += [len(ks) + (off[1] if cut else 0) + j for j in range(mine)]
        counted += [owner] * mine
        ks += [k] * parts
    segments = len(ks)
    dump = num_clients * segments
    whole = [c * segments + r for c in range(num_clients) for r in remap]
    dev = seg_ids.device
    rows = seg_ids.long()
    apply_ids = torch.tensor(whole, dtype=torch.int32, device=dev)[rows]
    count_ids = torch.tensor([w if own else dump for w, own in
                              zip(whole, counted * num_clients)],
                             dtype=torch.int32, device=dev)[rows]
    k = torch.tensor(ks * num_clients + [1], dtype=torch.int32, device=dev)
    return apply_ids.contiguous(), count_ids.contiguous(), k


def _segment_k(spec: pk.PackSpec, gamma: float, num_clients: int,
               device) -> torch.Tensor:
    """(C * S,) int32 k = max(1, round(gamma * size)) of every segment, a
    :func:`~repro_torch.kernels.packing.device_constant`."""
    def build():
        sizes, inverse = torch.unique(spec.segment_sizes(),
                                      return_inverse=True)
        ks = torch.tensor([max(1, int(round(gamma * int(n))))
                           for n in sizes], dtype=torch.int32)
        return ks[inverse].repeat(num_clients)

    return pk.device_constant(("segment_k", spec, gamma, num_clients),
                              build, device)


def _refine_taus(x2d, seg_ids, hist, k, refine_sweeps: int,
                 candidates: int, reduce=None) -> torch.Tensor:
    """Per-segment final thresholds from the suffix histogram: bracket the
    k-th magnitude, refine it with ``refine_sweeps`` count sweeps and take
    the conservative endpoint (lo when hi would keep nothing).
    ``reduce``, when given, sums each sweep's counts over the ranks."""
    lo, hi, cnt_lo, cnt_hi = seg.select_thresholds(hist, k)
    for sweep in range(refine_sweeps):
        # Sweep 0 subdivides the histogram's 16x bracket geometrically;
        # later sweeps refine the now-narrow bracket linearly.
        cand = seg.candidate_taus(lo, hi, candidates, geometric=(sweep == 0))
        counts = seg.segmented_count(x2d, seg_ids, cand)
        if reduce is not None:
            counts = reduce(counts)
        lo, hi, cnt_lo, cnt_hi = seg.shrink_brackets(
            lo, hi, cnt_lo, cnt_hi, cand, counts, k)
    return torch.where(cnt_hi >= 1, hi, lo)


def _sum_over(mesh):
    """In-place sum of a tensor over every dim of ``mesh``."""
    import torch.distributed as dist

    def reduce(t: torch.Tensor) -> torch.Tensor:
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                dist.all_reduce(t, group=mesh.get_group(d))
        return t
    return reduce


def topk_mask_stacked(tree: Tree, gamma: float, *, min_leaf_size: int = 256,
                      refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                      candidates: int = DEFAULT_CANDIDATES,
                      axis0_slices: bool = False, group=None) -> Tree:
    """Selective masking of a client-stacked tree (leading client axis on
    every leaf) in ``refine_sweeps + 2`` kernel launches for the whole
    cohort.  Leaves with fewer than ``min_leaf_size`` elements per client
    pass through dense.  Per client and leaf the result is what
    :func:`topk_mask_pytree` gives: at most k = max(1, round(gamma * size))
    entries kept when the k-th and (k+1)-th magnitudes differ by more than
    the final bracket (~1% of tau), all tied entries kept otherwise.

    ``axis0_slices``: a maskable leaf of ndim >= 2 is masked per
    first-axis slice (each slice its own segment, k from the slice's
    size), as the pod round's kernel route masks; vectors stay whole.

    ``group``: a ``DeviceMesh`` over which the leaves are DTensors (the
    client axis whole); each client is masked over its shards (module
    docstring).  None: plain tensors, one device.
    """
    packed = None if gamma >= 1.0 else _packed_cohort(tree, min_leaf_size,
                                                      axis0_slices)
    if packed is None:
        return tree
    names, spec, x2d, seg_ids, num_clients = packed
    if group is None:
        count_ids, reduce = seg_ids, None
        k = _segment_k(spec, gamma, num_clients, x2d.device)
    else:
        seg_ids, count_ids, k = _shard_segments(
            tree, names, seg_ids, gamma, num_clients, axis0_slices, group)
        reduce = _sum_over(group)

    hist = seg.segmented_histogram(x2d, count_ids, k.numel())
    if reduce is not None:
        hist = reduce(hist)
    tau = _refine_taus(x2d, count_ids, hist, k, refine_sweeps, candidates,
                       reduce)
    out2d, _kept = seg.segmented_apply(x2d, seg_ids, tau)

    out = dict(tree)
    for name, masked in zip(names, pk.unpack_stacked(out2d, spec)):
        leaf = tree[name]
        out[name] = masked if group is None else _like(masked, leaf)
    return out


def _like(local: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``local`` as the shard of a tensor laid out as ``leaf`` (a DTensor),
    or ``local`` itself for a plain ``leaf``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        return local
    return DTensor.from_local(local, leaf.device_mesh, leaf.placements,
                              shape=leaf.shape, stride=leaf.stride(),
                              run_check=False)


def topk_mask_pytree(tree: Tree, gamma: float, *, min_leaf_size: int = 256,
                     refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                     candidates: int = DEFAULT_CANDIDATES,
                     axis0_slices: bool = False, group=None) -> Tree:
    """Whole-model selective masking of ONE client's delta tree in
    ``refine_sweeps + 2`` sweeps (see :func:`topk_mask_stacked`); with
    ``group`` (a ``DeviceMesh``) over the client's DTensor shards."""
    stacked = topk_mask_stacked({n: leaf[None] for n, leaf in tree.items()},
                                gamma, min_leaf_size=min_leaf_size,
                                refine_sweeps=refine_sweeps,
                                candidates=candidates,
                                axis0_slices=axis0_slices, group=group)
    return {n: leaf[0] for n, leaf in stacked.items()}


# --------------------------------------------------------------------------
# Fused wire path: masked delta -> COO / bitmap wire payload (DESIGN.md §10).
# --------------------------------------------------------------------------
# "Keep everything nonzero" threshold for the assume-masked path: one bin
# below the histogram's smallest edge, as in the underfull branch of
# ``seg.select_thresholds``.  Magnitudes below 2^(EXPO_MIN-1) ship as zero.
_WIRE_FLOOR_TAU = float(2.0 ** (EXPO_MIN - 1))


def client_encode_scales(scales: torch.Tensor,
                         num_clients: int) -> torch.Tensor:
    """The per-segment scales ``segmented_encode`` divides by: a client
    with any non-finite scale gets NaN for all its segments.

    The reference gathers scales onto rows through a one-hot matmul, so
    one NaN or infinite scale makes ``0 * scale`` NaN in every row of its
    buffer — one client's, since the codec is vmapped — and every code of
    that client becomes 0 (NaN -> 0).  The wire still carries the
    per-segment scales, so such a client decodes to NaN where its own scale
    is non-finite and to 0 elsewhere.  The port packs the whole cohort in
    one buffer, so it spreads the NaN per client here, never across
    clients."""
    per = scales.reshape(num_clients, -1)
    bad = ~torch.isfinite(per).all(1, keepdim=True)
    return torch.where(bad, torch.full_like(per, float("nan")),
                       per).reshape(-1)


def _leaf_wire(vals: torch.Tensor, bits: torch.Tensor, ls: pk.LeafSpec,
               gamma: float, wire: str, scales: torch.Tensor | None):
    """Compact ONE packed leaf's encode outputs, for every client at once,
    into its stacked wire payload.

    ``vals``: (C, rows * SEG_LANE) fp32 or int8 encode output; ``bits``:
    the matching (C, rows * SEG_LANE // 8) uint8 keep bitmap.  Each kept
    entry takes its index-order slot from a cumulative sum; entries past
    the k-slot budget are shed by highest index (the COO and bitmap codecs
    shed the smallest magnitudes instead, which differs only on tie
    plateaus that overflow the budget).  No sort, no re-read of fp32 data.
    """
    size = ls.size
    k = min(max(1, int(round(gamma * size))), size)
    num_clients = vals.shape[0]
    v = vals[:, ls.offset:ls.offset + size]
    byte0 = ls.offset // 8                     # offset is a SEG_LANE multiple
    keep = unpack_bits_rows(bits[:, byte0:byte0 + (size + 7) // 8], size)
    slot = torch.cumsum(keep.to(torch.int64), 1) - 1
    live = keep & (slot < k)
    dest = torch.where(live, slot, torch.full_like(slot, k))   # trash slot k
    val_buf = torch.zeros((num_clients, k + 1), dtype=v.dtype, device=v.device)
    val_buf.scatter_(1, dest, torch.where(live, v, torch.zeros_like(v)))
    if scales is not None:
        values = {"q": val_buf[:, :k], "scale": scales}
    else:
        values = val_buf[:, :k].to(ls.dtype)
    shape = torch.tensor(ls.shape, dtype=torch.int32)
    if wire == "coo":
        index = torch.arange(size, dtype=torch.int32, device=v.device)
        idx_buf = torch.zeros((num_clients, k + 1), dtype=torch.int32,
                              device=v.device)
        idx_buf.scatter_(1, dest, torch.where(
            live, index.expand(num_clients, size), torch.zeros_like(index)))
        return {"indices": idx_buf[:, :k], "values": values, "shape": shape}
    # Bitmap wire: repack the budget-capped bits, so the popcount never
    # exceeds the value slots.
    return {"bitmap": pack_bits_rows(live), "values": values, "shape": shape}


def topk_encode_stacked(tree: Tree, gamma: float, *,
                        min_leaf_size: int = 256,
                        refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                        candidates: int = DEFAULT_CANDIDATES,
                        quantize: bool = False, wire: str = "coo",
                        assume_masked: bool = False) -> Dict[str, Any]:
    """Client-stacked delta tree -> stacked upload wire in one fused
    pipeline for the whole cohort.

    Per maskable leaf (``size >= min_leaf_size``) the result holds, with a
    leading client axis on every array but the shape vector,

    * ``wire="coo"``    — ``{"indices", "values", "shape"}``;
    * ``wire="bitmap"`` — ``{"bitmap", "values", "shape"}``;

    with ``values = {"q": int8, "scale": (C,) fp32}`` when ``quantize``
    (the scale is ``max|leaf| * float32(1/127)``, floored at 1e-12, from
    the stats sweep).  Smaller leaves pass through dense and unquantised:
    the codec layer owns them.

    ``assume_masked=True`` skips threshold selection (the input is already
    masked): every entry above 2^(EXPO_MIN-1) ships, for 1 encode launch
    (+ 1 stats launch with ``quantize``).  Otherwise the stats sweep's
    histogram seeds the masking path's refinement, for 1 stats +
    ``refine_sweeps`` count + 1 encode launches.  Non-float leaves go
    through the packed buffer's fp32 cast.
    """
    if wire not in ("coo", "bitmap"):
        raise ValueError(f"unknown wire format {wire!r}")
    packed = None if gamma >= 1.0 else _packed_cohort(tree, min_leaf_size)
    if packed is None:
        return tree
    names, spec, x2d, seg_ids, num_clients = packed
    num_segments = num_clients * spec.num_segments

    amax = None
    if assume_masked:
        tau = torch.full((num_segments,), _WIRE_FLOOR_TAU,
                         dtype=torch.float32, device=x2d.device)
        if quantize:
            _, amax = seg.segmented_stats(x2d, seg_ids, num_segments)
    else:
        k = _segment_k(spec, gamma, num_clients, x2d.device)
        hist, amax = seg.segmented_stats(x2d, seg_ids, num_segments)
        tau = _refine_taus(x2d, seg_ids, hist, k, refine_sweeps, candidates)
    scales = int8_scales(amax[:, 0]).contiguous() if quantize else None
    out2d, bm2d, _kept = seg.segmented_encode(
        x2d, seg_ids, tau.contiguous(),
        None if scales is None else client_encode_scales(scales, num_clients))

    vals = out2d.reshape(num_clients, -1)
    bits = bm2d.reshape(num_clients, -1)
    scales_cl = (scales.reshape(num_clients, spec.num_segments)
                 if quantize else None)
    out: Dict[str, Any] = dict(tree)
    for s, (name, ls) in enumerate(zip(names, spec.leaves)):
        out[name] = _leaf_wire(vals, bits, ls, gamma, wire,
                               None if scales_cl is None else scales_cl[:, s])
    return out


def _unstack(wire: Any):
    if isinstance(wire, dict):
        return {k: v if k == "shape" else _unstack(v)
                for k, v in wire.items()}
    return wire[0]


def topk_encode_pytree(tree: Tree, gamma: float, **kw) -> Dict[str, Any]:
    """:func:`topk_encode_stacked` of ONE client's delta tree: the same
    payloads without the client axis (the int8 scale is a scalar)."""
    stacked = topk_encode_stacked({n: leaf[None] for n, leaf in tree.items()},
                                  gamma, **kw)
    return {n: _unstack(w) for n, w in stacked.items()}


def wirepath_sweep_count(*, fused: bool,
                         refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                         assume_masked: bool = False,
                         quantize: bool = True) -> int:
    """Full-width passes over an n-param delta to build ONE upload's wire
    payload (analytic).

    * fused — 1 stats (histogram + absmax) + ``refine_sweeps`` counts + 1
      encode; with ``assume_masked`` the selection sweeps vanish (1 encode,
      + 1 absmax sweep when ``quantize``).
    * codec path — the same masking front half plus a dense fp32 write
      (apply), then the codec re-reads the masked tree three more times
      (sort-key build, argsort, gather).
    """
    if fused:
        if assume_masked:
            return 2 if quantize else 1
        return 1 + refine_sweeps + 1
    select = 0 if assume_masked else 1 + refine_sweeps
    return select + 2 + 3


def wirepath_bytes_moved(n_params: int, gamma: float, *, fused: bool,
                         quantize: bool = True, wire: str = "coo",
                         refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                         assume_masked: bool = False) -> dict:
    """Analytic device-memory bytes (reads + writes) to wire-encode one
    n-param delta: ``reads``, ``writes``, ``total``, ``payload_bytes`` and
    the per-stage ``breakdown``."""
    n = int(n_params)
    dense = 4 * n
    k = min(max(1, int(round(gamma * n))), n)
    vb = 1 if quantize else 4
    payload = (k * (4 + vb)) if wire == "coo" else (k * vb + (n + 7) // 8)
    if quantize:
        payload += 4                                   # fp32 scale
    breakdown = {}
    if not assume_masked:
        breakdown["select_reads"] = (1 + refine_sweeps) * dense
    elif fused and quantize:
        breakdown["select_reads"] = dense              # absmax-only sweep
    if fused:
        narrow = (n if quantize else dense) + (n + 7) // 8
        breakdown["encode_read"] = dense
        breakdown["encode_writes"] = narrow            # int8/fp32 + bitmap
        breakdown["compact_reads"] = narrow            # never fp32 again
        breakdown["payload_writes"] = payload
    else:
        breakdown["apply_read"] = dense
        breakdown["apply_write"] = dense               # masked fp32 tree
        breakdown["codec_rereads"] = 3 * dense         # key, argsort, gather
        breakdown["payload_writes"] = payload
    reads = sum(breakdown.get(key, 0) for key in (
        "select_reads", "encode_read", "compact_reads", "apply_read",
        "codec_rereads"))
    writes = sum(breakdown.get(key, 0) for key in (
        "encode_writes", "apply_write", "payload_writes"))
    return {"reads": reads, "writes": writes, "total": reads + writes,
            "payload_bytes": payload, "breakdown": breakdown}


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous()


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor):
    """Selective-SSM recurrence on the CUDA kernel (``kernels.ssm_scan``).

    a, bx: (B, T, d, N) decay and input terms (the layout models/ssm.py
    uses); c: (B, T, N); h0: (B, d, N), any float dtype (computed in fp32).
    Returns (y (B, T, d), hT (B, d, N)) fp32.  Differentiable: the casts
    are autograd's, the scan ``ssm_scan.SsmScanFunction``."""
    return ssk.ssm_scan(_f32(a), _f32(bx), _f32(c), _f32(h0))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """RWKV6 wkv recurrence on the CUDA kernel (``kernels.wkv6``).

    r/k/v/logw: (B, T, H, D); u: (H, D); s0: (B, H, D, D), any float dtype
    (computed in fp32).  Returns (y (B, T, H, D), sT (B, H, D, D)) fp32.
    Differentiable: the casts are autograd's, the recurrence
    ``wkv6.Wkv6Function``."""
    return wk.wkv6(_f32(r), _f32(k), _f32(v), _f32(logw), _f32(u), _f32(s0))
